// Single-frame multi-scale deformable attention for Hopper (sm_90a), forward
// and backward, at any head width.
//
// Two kernels, each the counterpart of a Pallas kernel of
// devis_tpu/ops/ms_deform_attn_pallas.py:
//
//   K6 msda_rows              <- _fwd_kernel_fused (ms_deform_attn_rows).
//      out[b, q, m, :] = sum over (l, p) of att * bilinear(value_l, loc), zero
//      padding, f32 accumulation.
//   K7 msda_rows_bwd          <- _bwd_kernel_rows.
//      From the output gradient: the gradient of the value, of the locations
//      and of the weights, with the taps rebuilt from loc and att.
//
// Their first caller is the mask head's DCNv2 layer under differentiation:
// the K*K kernel positions of U_k = x . W_k are K*K levels of one head with
// one point each, D = Cout from 264 down to 1, Q = H*W pixels. The image
// encoder (Q = S, M = 8, D = 32) runs K7 as K8's backward.
//
// K6. What bound the first design (a group of G = min(32, pow2 >= D)
// lanes per (b, q, m), lane i owning channels i, i + G, ...): every lane
// walked the taps in turn, one dependent round trip each, with 2-byte loads
// (64 bytes a warp instruction); at D 264 / 128 it ran its channel loop
// outside the tap loop and rebuilt all 9 taps' corners and weights in each
// of 9 / 4 rounds. It took about 2 ms over the clip's six mask-head layers,
// 7.7x their bound by bytes.
//
// Now a block takes `units` units (a unit: one (b, q, m) and one slice of
// its channels) and works in two steps:
//   1. One thread per (unit, tap) reads the tap's location and weight
//      (8 and 4 contiguous bytes, neighbouring threads on neighbouring
//      taps, K6_UNROLL taps' loads in flight) and computes its geometry once
//      (tap_geometry: corner, fractions, dead or live) into shared memory.
//   2. A unit's threads are `groups` tap groups of `lanes` threads, thread c
//      of a group owning chunk c of the slice (16 bytes of channels, or one
//      channel where the row is not 16-byte aligned or D * itemsize not a
//      multiple of 16); a group takes taps g, g + groups, ... and has the 4
//      corner loads of K6_UNROLL taps in flight before it uses any. Groups
//      are summed with shuffles; group 0 writes its chunk once.
// Where a unit is one thread (D 1, out_lay) that thread computes its own
// taps in registers (step 1 and its barrier cost more than they save
// there), K6_UNROLL_ONE taps' loads in flight.
// The split comes from the wrapper's `rows_plan`: one group of as many
// threads as the slice has chunks (any count: D 264 in bf16 is 33 chunks,
// a unit of 33 threads, no idle lane) where the launch fills the card (the
// DCN route), and taps spread over up to 32 / lanes groups where it does
// not (the image decoder: 300 queries x 8 heads, 8 groups of 2 taps). The
// launcher refuses 16-byte access on a value off 16 bytes.
//
// Measured (bf16, NVIDIA H100, `kernel_ab.py`; PERF.md section 6): 3.9x
// faster over the clip's six layers and 4.5x over the image mask head's,
// 2.5x at the image decoder. Two taps in flight beat four (fewer registers,
// more warps); the tap's level by a shift where P is a power of two. What
// bounds it now: the wide layers run at 1.9-2.2x their bound by bytes (U
// from device memory where it outgrows L2); D 1 (out_lay) at 1.9x, reading
// loc and att at about 1.5 TB/s; the image decoder (2 400 units) at 3.8x,
// latency. 2-D tiles of the DCN route's query grid were slower than raster
// runs over the six layers and were dropped.
//
// K7 (`bwd_run` in msda_bwd.cuh, shared with K5 and K9): the value
// gradient is a scatter, one add per (tap, corner, channel). Added with f32
// atomics, its order (and its last bits) would change from run to run; so
// the corners are sorted by value row and one warp sums each row in a fixed
// order, in the value's type, with no zeroed f32 buffer and no cast: equal
// inputs give equal bits. The DCN route's rows (the K*K positions of U as levels) take
// about 4 corners each, the image encoder's about 16.

#include "msda_bwd.cuh"

// K6 launch constants (`rows_plan` reads them with `_build.source_define`)
#define K6_UNROLL 2              // taps a thread has in flight
#define K6_UNROLL_ONE 5          // the same where a unit is one thread
#define K6_MAX_THREADS 512       // threads a block, at most
#define K6_MAX_CHUNKS 256        // channel chunks a slice, at most
#define K6_SMEM 49152            // bytes of tap geometry a block, at most (the
                                 // default dynamic shared memory limit)
#define K6_FILL_THREADS 135168   // 132 SMs x 1024 threads: a wave of the H100 at
                                 // the occupancy the kernel's registers allow

// The launch split of K6 (`rows_plan`): raster runs of `units` units a
// block, a unit one (b, q, m) and one of its `slices` channel slices of
// `chunks` chunks; `groups` tap groups of `lanes` threads a unit.
struct RowsPlan {
  int lanes, groups, slices, chunks, units;
};

// (b * Q + q) * M + m of the block's unit u, or -1 past the edge; its
// channel slice in `slice`.
__device__ __forceinline__ long rows_unit(const RowsPlan& p, long n_units, int u, int& slice) {
  const long gu = (long)blockIdx.x * p.units + u;
  slice = 0;
  if (u >= p.units || gu >= n_units) return -1;
  if (p.slices == 1) return gu;
  slice = (int)(gu % p.slices);
  return gu / p.slices;
}

// A tap's geometry at normalized (x, y) of level l with weight a: (dx, dy,
// a, packed corner), the corner TAP_DEAD where the tap is not live or misses
// the level.
__device__ __forceinline__ float4 tap_entry(const Pyramid& pyr, int l, bool live, float2 xy,
                                            float a) {
  unsigned packed = TAP_DEAD;
  float dx = 0.f, dy = 0.f;
  int x0, y0;
  if (live && tap_geometry(pyr.h[l], pyr.w[l], xy.x, xy.y, x0, y0, dx, dy))
    packed = ((unsigned)(y0 + 1) << 16) | (unsigned)(x0 + 1);
  return make_float4(dx, dy, a, __uint_as_float(packed));
}

// value (B, S, M, D); loc (B, Q, M, L, P, 2) f32; att (B, Q, M, L, P) f32
// -> out (B, Q, M*D). CW channels a thread: 16 bytes, or 1 (any alignment).
// ONE: a unit is one thread, which computes its taps itself; else dynamic
// shared memory holds units * L * P float4 of tap geometry.
template <typename scalar_t, int CW, bool ONE>
__global__ void __launch_bounds__(K6_MAX_THREADS) msda_rows_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, scalar_t* __restrict__ out, long n_units, int Q, int S, int M,
    int D, int P, int pshift, Pyramid pyr, RowsPlan plan) {
  using C = Chunk<scalar_t, CW>;
  constexpr int U = ONE ? K6_UNROLL_ONE : K6_UNROLL;
  extern __shared__ float4 s_geo[];  // (unit, tap): dx, dy, a, packed corner
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  const int LP = pyr.L * P, tid = threadIdx.x, n_geo = plan.units * LP;

  // 1. every tap of the block's units, once; U taps' loads in flight
  if (!ONE) {
    for (int i0 = tid; i0 < n_geo; i0 += U * blockDim.x) {
      float2 xy[U];
      float a[U];
      bool on[U];
      int kk[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int i = i0 + j * blockDim.x, u = i / LP;
        int slice;
        const long item = i < n_geo ? rows_unit(plan, n_units, u, slice) : -1;
        on[j] = item >= 0;
        kk[j] = i - u * LP;
        const size_t t = (size_t)(on[j] ? item : 0) * LP + kk[j];
        xy[j] = on[j] ? loc2[t] : make_float2(0.f, 0.f);
        a[j] = on[j] ? att[t] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i >= n_geo) break;
        s_geo[i] = tap_entry(pyr, tap_level(kk[j], P, pshift), on[j], xy[j], a[j]);
      }
    }
    __syncthreads();
  }

  // 2. the unit's chunks over its taps, U taps' corners in flight
  const int tpu = plan.groups * plan.lanes;
  const int u = tid / tpu, r = tid - u * tpu, g = r / plan.lanes, c = r - g * plan.lanes;
  int slice = 0;
  const long item = rows_unit(plan, n_units, u, slice);
  const int c0 = (slice * plan.chunks + c) * CW;
  const bool live = item >= 0 && c < plan.chunks && c0 < D;
  const size_t row = (size_t)M * D;
  const long b = live ? item / ((long)M * Q) : 0;
  const int m = live ? (int)(item % M) : 0;
  const scalar_t* vm = value + (size_t)b * S * row + (size_t)m * D + c0;
  const float4* geo = s_geo + (size_t)(live ? u : 0) * LP;
  const size_t t0 = (size_t)(live ? item : 0) * LP;
  float acc[CW];
#pragma unroll
  for (int v = 0; v < CW; ++v) acc[v] = 0.f;
  for (int k0 = 0; k0 < LP; k0 += U * plan.groups) {
    float4 e[U];
    if (ONE) {  // the thread's own taps: their loads first, then their geometry
      float2 xy[U];
      float a[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const bool on = live && k0 + j < LP;
        xy[j] = on ? loc2[t0 + k0 + j] : make_float2(0.f, 0.f);
        a[j] = on ? att[t0 + k0 + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const bool on = live && k0 + j < LP;
        e[j] = tap_entry(pyr, on ? tap_level(k0 + j, P, pshift) : 0, on, xy[j], a[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int k = k0 + g + j * plan.groups;
        e[j] = live && k < LP ? geo[k] : make_float4(0.f, 0.f, 0.f, __uint_as_float(TAP_DEAD));
      }
    }
    typename C::raw_t raw[U][4];
    float wt[U][4];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int k = k0 + g + j * plan.groups;
      const int l = live && k < LP ? tap_level(k, P, pshift) : 0;
      tap_corners<scalar_t, CW>(vm + (size_t)pyr.start[l] * row, pyr.h[l], pyr.w[l], row,
                                __float_as_uint(e[j].w), e[j].x, e[j].y, raw[j], wt[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) tap_accumulate<scalar_t, CW>(acc, e[j].z, raw[j], wt[j]);
  }
  // a unit of several groups lies in one warp (tpu divides 32)
  for (int o = plan.lanes; o < tpu; o <<= 1)
#pragma unroll
    for (int v = 0; v < CW; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  if (live && g == 0) C::store(out + (size_t)item * D + c0, acc);
}

// The value frame of every stage is the queries' own batch entry.
struct SameFrame {
  __device__ __forceinline__ int operator()(int, int n) const { return n; }
};

// The plan (`rows_plan`): `vec` (16-byte chunks, else one channel a
// thread), lanes, groups, slices, chunks a slice, units a block, threads a
// block. Refuses a plan the kernel cannot run (16-byte access on a value off
// 16 bytes among them).
template <typename scalar_t>
static int launch_rows(void* value, void* loc, void* att, void* out, int B, int Q, int S, int M,
                       int D, int P, int vec, int lanes, int groups, int slices, int chunks,
                       int units, int threads, const int* levels, int L, void* stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || Q < 1 || M < 1 || D < 1 || P < 1 || L < 1 || L > MAX_LEVELS) return bad;
  const int cw = vec ? VN : 1, per_unit = groups * lanes;
  if (lanes < 1 || groups < 1 || slices < 1 || units < 1 || chunks < 1 || chunks > lanes ||
      chunks > K6_MAX_CHUNKS || (long)slices * chunks * cw < D ||
      (groups > 1 && (per_unit > 32 || 32 % per_unit != 0)) || threads % 32 != 0 ||
      threads > K6_MAX_THREADS || (long)units * per_unit > threads)
    return bad;
  if (vec && (D % VN != 0 || (uintptr_t)value % 16 != 0 || (uintptr_t)out % 16 != 0))
    return bad;
  if ((uintptr_t)loc % 8 != 0) return bad;
  const bool one = per_unit == 1;
  const size_t smem = one ? 0 : (size_t)units * L * P * sizeof(float4);
  const long n_units = (long)B * Q * M * slices, blocks = (n_units + units - 1) / units;
  if (smem > K6_SMEM || blocks > 0x7fffffffL) return bad;
  const Pyramid pyr = make_pyramid(levels, L);
  for (int l = 0; l < L; ++l)
    if (pyr.h[l] >= 0xffff || pyr.w[l] >= 0xffff) return bad;  // packed corners
  const RowsPlan p{lanes, groups, slices, chunks, units};
  auto kernel = vec ? (one ? &msda_rows_kernel<scalar_t, VN, true>
                           : &msda_rows_kernel<scalar_t, VN, false>)
                    : (one ? &msda_rows_kernel<scalar_t, 1, true>
                           : &msda_rows_kernel<scalar_t, 1, false>);
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (scalar_t*)out, n_units, Q,
      S, M, D, P, point_shift(P), pyr, p);
  return (int)cudaGetLastError();
}

// value (B, S, M, D); loc (B, Q, M, L, P, 2) f32; att (B, Q, M, L, P) f32;
// grad_out (B, Q, M*D) -> grad_value (B, S, M, D) in the value's type;
// grad_loc like loc; grad_att like att. `lanes`, `per` and `vec` come from
// the wrapper's `taps_plan`; scratch as `BwdScratch` says, with wts and dots
// of 4 floats a tap.
template <typename scalar_t>
static int launch_rows_bwd(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                           void* grad_loc, void* grad_att, void* keys0, void* keys1, void* vals0,
                           void* vals1, void* wts, void* dots, void* begin, void* end, void* hist,
                           void* sums, void* top, int B, int Q, int S, int M, int D, int P,
                           int lanes, int per, int vec, int gpr, const int* levels, int L,
                           void* stream) {
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const BwdScratch s{{(unsigned*)keys0, (unsigned*)keys1}, {(unsigned*)vals0, (unsigned*)vals1},
                     (int*)begin, (int*)end, (int*)hist, (int*)sums, (int*)top};
  return bwd_run<k7_bwd, scalar_t>(
      value, (const float*)loc, (const float*)att, grad_out, grad_value, (float*)grad_loc,
      (float*)grad_att, (float*)wts, (float*)dots, s, B, B, Q, S, M, D, L, P, lanes, per, vec,
      gpr, make_pyramid(levels, L), SameFrame{}, (cudaStream_t)stream);
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_rows_f32(void* value, void* loc, void* att, void* out, int B, int Q, int S, int M, int D,
                  int P, int vec, int lanes, int groups, int slices, int chunks, int units,
                  int threads, const int* levels, int L, void* stream) {
  return launch_rows<float>(value, loc, att, out, B, Q, S, M, D, P, vec, lanes, groups, slices,
                            chunks, units, threads, levels, L, stream);
}

int msda_rows_bf16(void* value, void* loc, void* att, void* out, int B, int Q, int S, int M,
                   int D, int P, int vec, int lanes, int groups, int slices, int chunks,
                   int units, int threads, const int* levels, int L, void* stream) {
  return launch_rows<__nv_bfloat16>(value, loc, att, out, B, Q, S, M, D, P, vec, lanes, groups,
                                    slices, chunks, units, threads, levels, L, stream);
}

int msda_rows_bwd_f32(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                      void* grad_loc, void* grad_att, void* keys0, void* keys1, void* vals0,
                      void* vals1, void* wts, void* dots, void* begin, void* end, void* hist,
                      void* sums, void* top, int B, int Q, int S, int M, int D, int P, int lanes,
                      int per, int vec, int gpr, const int* levels, int L, void* stream) {
  return launch_rows_bwd<float>(value, loc, att, grad_out, grad_value, grad_loc, grad_att, keys0,
                                keys1, vals0, vals1, wts, dots, begin, end, hist, sums, top, B, Q,
                                S, M, D, P, lanes, per, vec, gpr, levels, L, stream);
}

int msda_rows_bwd_bf16(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                       void* grad_loc, void* grad_att, void* keys0, void* keys1, void* vals0,
                       void* vals1, void* wts, void* dots, void* begin, void* end, void* hist,
                       void* sums, void* top, int B, int Q, int S, int M, int D, int P, int lanes,
                       int per, int vec, int gpr, const int* levels, int L, void* stream) {
  return launch_rows_bwd<__nv_bfloat16>(value, loc, att, grad_out, grad_value, grad_loc,
                                        grad_att, keys0, keys1, vals0, vals1, wts, dots, begin,
                                        end, hist, sums, top, B, Q, S, M, D, P, lanes, per, vec,
                                        gpr, levels, L, stream);
}

}  // extern "C"
