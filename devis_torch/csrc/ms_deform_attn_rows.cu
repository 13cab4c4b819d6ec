// Single-frame multi-scale deformable attention for Hopper (sm_90a), forward
// and backward, at any head width.
//
// Two kernels, each the counterpart of a Pallas kernel of
// devis_tpu/ops/ms_deform_attn_pallas.py:
//
//   K6 msda_rows              <- _fwd_kernel_fused (ms_deform_attn_rows).
//      out[b, q, m, :] = sum over (l, p) of att * bilinear(value_l, loc), zero
//      padding, f32 accumulation.
//   K7 msda_rows_bwd_win      <- _bwd_kernel_rows.
//      From the output gradient: the gradient of the value, of the locations
//      and of the weights, with the taps rebuilt in the kernel.
//
// Their first caller is the mask head's DCNv2 layer under differentiation:
// the K*K kernel positions of U_k = x . W_k are K*K levels of one head with
// one point each, D = Cout from 264 down to 1, Q = H*W pixels. The image
// encoder (Q = S, M = 8, D = 32) runs K7 as K8's backward.
//
// K6: a group of G lanes per (b, q, m), G the smallest power of two that
// holds min(D, 32) channels; lane i of a group owns channels i, i + G, ...
// What bounds it: the corner gathers, from device memory where the value (up
// to 265 MB of U in bf16 at a mask-head layer) outgrows L2.
//
// K7 (`msda_bwd_block` in msda_common.cuh, shared with K5): the value
// gradient is a scatter, one add per (tap, corner, channel). Added straight
// into device memory one scalar atomic at a time, it was bound by the atomic
// read-modify-writes: the f32 gradient of U (2 GB at the image's lay5 with
// 50 masks) does not fit L2, and neighbouring pixels' corners touch each row
// about 4 times over. The kernel sorts a block's corners by window row (the
// box of rows its taps touch at a level), reads each touched row once, sums
// its adds in registers and flushes it once with vector atomics: global adds
// fall 2.3-3.1x on the mask head, and the value is read once a row, not once
// a corner. A tap is computed once, by one thread per (query, point). The
// DCN route passes its query grid: blocks then take 2-D pixel tiles, whose
// windows are boxes a few pixels wider than the tile; without it blocks take
// raster runs of queries (the image encoder). D above 64 is cut into channel
// slices, one block each. What bounds it now: latency, through the barriers
// between its per-level steps (tap, sort, row pass) and the dependent
// shared-memory reads of the row pass; at D = 1 (out_lay) those fixed costs
// exceed the old kernel's whole time. The flush's atomics are the largest
// memory traffic where the gradient outgrows L2 (lay5).

#include "msda_common.cuh"

static const int kThreads = 256;

// value (B, S, M, D); loc (B, Q, M, L, P, 2) f32; att (B, Q, M, L, P) f32
// -> out (B, Q, M*D).
template <typename scalar_t>
__global__ void msda_rows_kernel(const scalar_t* __restrict__ value,
                                 const float* __restrict__ loc, const float* __restrict__ att,
                                 scalar_t* __restrict__ out, long groups, int Q, int S, int M,
                                 int D, int P, int G, Pyramid pyr) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long group = tid / G;
  const int lig = (int)(tid % G);
  if (group >= groups) return;
  const int m = (int)(group % M);
  const long b = group / M / Q;
  const int LP = pyr.L * P;
  const float* lc = loc + group * LP * 2;
  const float* at = att + group * LP;
  const size_t row = (size_t)M * D;
  const scalar_t* vb = value + (size_t)b * S * row + (size_t)m * D;
  for (int d = lig; d < D; d += G) {
    float acc = 0.f;
    for (int l = 0; l < pyr.L; ++l) {
      const scalar_t* vl = vb + (size_t)pyr.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        acc += at[k] * sample_bilinear(vl, pyr.h[l], pyr.w[l], row, lc[2 * k], lc[2 * k + 1], d);
      }
    }
    out[group * D + d] = from_f<scalar_t>(acc);
  }
}

// The value frame of every stage is the queries' own batch entry.
struct SameFrame {
  __device__ __forceinline__ int operator()(int, int n) const { return n; }
};

// value (B, S, M, D); loc (B, Q, M, L, P, 2) f32; att (B, Q, M, L, P) f32;
// grad_out (B, Q, M*D) -> grad_value (B, S, M, D) f32, zeroed by the caller;
// grad_loc like loc; grad_att like att; adds (2) counters or null.
template <typename scalar_t, int LPQ>
__global__ void __launch_bounds__(BWD_THREADS, 2) msda_rows_bwd_win_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, const scalar_t* __restrict__ grad_out,
    float* __restrict__ grad_value, float* __restrict__ grad_loc, float* __restrict__ grad_att,
    unsigned long long* __restrict__ adds, int Q, int S, int M, int D, int P, Pyramid pyr,
    BwdTiles tiles, BwdPlan plan, int groups, bool aligned, int vw) {
  msda_bwd_block<scalar_t, LPQ>(value, loc, att, grad_out, grad_value, grad_loc, grad_att, adds,
                                Q, S, M, D, P, pyr.L, pyr, SameFrame{}, tiles, plan, groups,
                                aligned, vw);
}

static int group_lanes(int D) {
  int g = 1;
  while (g < D && g < 32) g <<= 1;
  return g;
}

static int blocks_for(long groups, int G) {
  return (int)((groups * G + kThreads - 1) / kThreads);
}

template <typename scalar_t>
static int launch_rows(void* value, void* loc, void* att, void* out, int B, int Q, int S, int M,
                       int D, int P, const int* levels, int L, void* stream) {
  const long groups = (long)B * Q * M;
  const int G = group_lanes(D);
  msda_rows_kernel<scalar_t><<<blocks_for(groups, G), kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (scalar_t*)out, groups, Q, S,
      M, D, P, G, make_pyramid(levels, L));
  return (int)cudaGetLastError();
}

template <typename scalar_t, int LPQ>
static int launch_bwd_win(const void* value, const void* loc, const void* att,
                          const void* grad_out, void* grad_value, void* grad_loc, void* grad_att,
                          void* adds, int B, int Q, int S, int M, int D, int P,
                          const Pyramid& pyr, const BwdTiles& t, const BwdPlan& plan,
                          int groups, size_t smem, cudaStream_t stream) {
  auto kernel = msda_rows_bwd_win_kernel<scalar_t, LPQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (D * (int)sizeof(scalar_t)) % 16 == 0 && (uintptr_t)value % 16 == 0 &&
                       (uintptr_t)grad_out % 16 == 0;
  const long blocks = (long)B * M * t.n_tiles * groups * ((D + plan.slice - 1) / plan.slice);
  kernel<<<(int)blocks, BWD_THREADS, smem, stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (const scalar_t*)grad_out,
      (float*)grad_value, (float*)grad_loc, (float*)grad_att, (unsigned long long*)adds, Q, S,
      M, D, P, pyr, t, plan, groups, aligned, bwd_flush_width(D, grad_value));
  return (int)cudaGetLastError();
}

// `lanes` a query (a power of two) and the plan come from the wrapper's
// `bwd_plan`; grid_w > 0 selects 2-D tiles of the grid_h x grid_w queries;
// `groups` splits the levels over blocks.
template <typename scalar_t>
static int launch_rows_bwd(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                           void* grad_loc, void* grad_att, void* adds, int B, int Q, int S,
                           int M, int D, int P, int qb, int grid_h, int grid_w, int tile_h,
                           int tile_w, int cap, int slice, int pitch, int lanes, int groups,
                           const int* levels, int L, void* stream) {
  const Pyramid pyr = make_pyramid(levels, L);
  BwdTiles t;
  BwdPlan plan;
  size_t smem;
  const int err = bwd_setup(Q, D, P, Vec16<scalar_t>::N, pyr, qb, grid_h, grid_w, tile_h,
                            tile_w, cap, slice, pitch, lanes, t, plan, smem);
  if (err) return err;
  if (groups < 1 || (long)B * M * t.n_tiles * groups * ((D + slice - 1) / slice) > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
#define K7_LAUNCH(N)                                                                      \
  return launch_bwd_win<scalar_t, N>(value, loc, att, grad_out, grad_value, grad_loc,     \
                                     grad_att, adds, B, Q, S, M, D, P, pyr, t, plan,       \
                                     groups, smem, (cudaStream_t)stream)
  switch (lanes) {
    case 1: K7_LAUNCH(1);
    case 2: K7_LAUNCH(2);
    case 4: K7_LAUNCH(4);
    case 8: K7_LAUNCH(8);
    case 16: K7_LAUNCH(16);
  }
#undef K7_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_rows_f32(void* value, void* loc, void* att, void* out, int B, int Q, int S, int M, int D,
                  int P, const int* levels, int L, void* stream) {
  return launch_rows<float>(value, loc, att, out, B, Q, S, M, D, P, levels, L, stream);
}

int msda_rows_bf16(void* value, void* loc, void* att, void* out, int B, int Q, int S, int M,
                   int D, int P, const int* levels, int L, void* stream) {
  return launch_rows<__nv_bfloat16>(value, loc, att, out, B, Q, S, M, D, P, levels, L, stream);
}

int msda_rows_bwd_f32(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                      void* grad_loc, void* grad_att, void* adds, int B, int Q, int S, int M,
                      int D, int P, int qb, int grid_h, int grid_w, int tile_h, int tile_w,
                      int cap, int slice, int pitch, int lanes, int groups, const int* levels,
                      int L, void* stream) {
  return launch_rows_bwd<float>(value, loc, att, grad_out, grad_value, grad_loc, grad_att, adds,
                                B, Q, S, M, D, P, qb, grid_h, grid_w, tile_h, tile_w, cap,
                                slice, pitch, lanes, groups, levels, L, stream);
}

int msda_rows_bwd_bf16(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                       void* grad_loc, void* grad_att, void* adds, int B, int Q, int S, int M,
                       int D, int P, int qb, int grid_h, int grid_w, int tile_h, int tile_w,
                       int cap, int slice, int pitch, int lanes, int groups,
                       const int* levels, int L, void* stream) {
  return launch_rows_bwd<__nv_bfloat16>(value, loc, att, grad_out, grad_value, grad_loc,
                                        grad_att, adds, B, Q, S, M, D, P, qb, grid_h, grid_w,
                                        tile_h, tile_w, cap, slice, pitch, lanes, groups, levels,
                                        L, stream);
}

}  // extern "C"
