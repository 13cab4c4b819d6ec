// Single-frame multi-scale deformable attention for Hopper (sm_90a), forward
// and backward, at any head width.
//
// Two kernels, each the counterpart of a Pallas kernel of
// devis_tpu/ops/ms_deform_attn_pallas.py:
//
//   K6 msda_rows      <- _fwd_kernel_fused (ms_deform_attn_rows).
//      out[b, q, m, :] = sum over (l, p) of att * bilinear(value_l, loc), zero
//      padding, f32 accumulation.
//   K7 msda_rows_bwd  <- _bwd_kernel_rows.
//      From the output gradient: the gradient of the value (f32 atomics into
//      an f32 buffer, so not bit-reproducible), of the locations and of the
//      weights, with the taps rebuilt in the kernel.
//
// Their first caller is the mask head's DCNv2 layer under differentiation:
// the K*K kernel positions of U_k = x . W_k are K*K levels of one head with
// one point each, D = Cout from 264 down to 1, Q = H*W pixels. The COCO
// decoder (M = 8, D = 32) is the next.
//
// Mapping: a group of G lanes per (b, q, m), G the smallest power of two that
// holds min(D, 32) channels, so a warp serves 32 / G queries; lane i of a
// group owns channels i, i + G, ... Every lane of a group computes the same
// tap geometry. In K6 the channel loop is outside the tap loop (one
// accumulator a lane); in K7 it is inside, and the three sums a tap needs
// over all D channels are reduced across the group's lanes by shuffles.
//
// What bounds them: the gathers (K6) and the atomic scatter (K7), as in the
// temporal kernels; the value of a mask-head layer (up to 265 MB of U in
// bf16) no longer fits L2, so the corner rows come from device memory.

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

// value, loc, att as above; grad_out (B, Q, M*D) -> grad_value (B, S, M, D)
// f32, zeroed by the caller; grad_loc like loc; grad_att like att.
template <typename scalar_t>
__global__ void msda_rows_bwd_kernel(const scalar_t* __restrict__ value,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ att,
                                     const scalar_t* __restrict__ grad_out,
                                     float* __restrict__ grad_value,
                                     float* __restrict__ grad_loc, float* __restrict__ grad_att,
                                     long groups, int Q, int S, int M, int D, int P, int G,
                                     Pyramid pyr) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lig = (int)(tid % G);
  // lanes past the last group stay for the shuffles and do no work
  const bool valid = tid / G < groups;
  const long group = valid ? tid / G : 0;
  const int m = (int)(group % M);
  const long b = group / M / Q;
  const int LP = pyr.L * P;
  const float* lc = loc + group * LP * 2;
  const float* at = att + group * LP;
  const scalar_t* go = grad_out + group * D;
  const size_t row = (size_t)M * D;
  const size_t base = (size_t)b * S * row + (size_t)m * D;
  for (int l = 0; l < pyr.L; ++l) {
    const size_t level = base + (size_t)pyr.start[l] * row;
    const int h = pyr.h[l], w = pyr.w[l];
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float a = at[k];
      int x0, y0;
      float dx, dy;
      float s_v = 0.f, s_x = 0.f, s_y = 0.f;
      if (valid && tap_geometry(h, w, lc[2 * k], lc[2 * k + 1], x0, y0, dx, dy)) {
        for (int d = lig; d < D; d += G) {
          const float g = to_f(go[d]);
          tap_backward(value + level, grad_value + level, h, w, row, x0, y0, dx, dy, g, a * g,
                       d, s_v, s_x, s_y);
        }
      }
      s_v = group_sum(s_v, G);
      s_x = group_sum(s_x, G);
      s_y = group_sum(s_y, G);
      if (valid && lig == 0) {
        grad_att[group * LP + k] = s_v;
        grad_loc[(group * LP + k) * 2] = a * s_x * (float)w;
        grad_loc[(group * LP + k) * 2 + 1] = a * s_y * (float)h;
      }
    }
  }
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

template <typename scalar_t>
static int launch_rows_bwd(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                           void* grad_loc, void* grad_att, int B, int Q, int S, int M, int D,
                           int P, const int* levels, int L, void* stream) {
  const long groups = (long)B * Q * M;
  const int G = group_lanes(D);
  msda_rows_bwd_kernel<scalar_t><<<blocks_for(groups, G), kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)att, (const scalar_t*)grad_out,
      (float*)grad_value, (float*)grad_loc, (float*)grad_att, groups, Q, S, M, D, P, G,
      make_pyramid(levels, L));
  return (int)cudaGetLastError();
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
                      void* grad_loc, void* grad_att, int B, int Q, int S, int M, int D, int P,
                      const int* levels, int L, void* stream) {
  return launch_rows_bwd<float>(value, loc, att, grad_out, grad_value, grad_loc, grad_att, B, Q,
                                S, M, D, P, levels, L, stream);
}

int msda_rows_bwd_bf16(void* value, void* loc, void* att, void* grad_out, void* grad_value,
                       void* grad_loc, void* grad_att, int B, int Q, int S, int M, int D, int P,
                       const int* levels, int L, void* stream) {
  return launch_rows_bwd<__nv_bfloat16>(value, loc, att, grad_out, grad_value, grad_loc,
                                        grad_att, B, Q, S, M, D, P, levels, L, stream);
}

}  // extern "C"
