// Single-frame multi-scale deformable attention from raw projections, for
// Hopper (sm_90a).
//
// K8 msda_proj <- devis_tpu/ops/ms_deform_attn_pallas.py:_fwd_kernel_proj, the
// attention of the image model's encoder layers and of its first decoder
// layer (2-d reference points). From the raw outputs of the offset and logit
// projections the kernel computes, in its own body,
//   att = softmax over the L*P logits of one (b, q, m), in f32,
//   loc = ref_l + off * (1 / w_l, 1 / h_l),
//   out[b, q, m, :] = sum over (l, p) of att * bilinear(value_l, loc),
// with zero padding and f32 accumulation. Locations and weights never reach
// device memory.
//
// It is K1 (ms_deform_attn.cu) without the temporal part, in K1's form: one
// warp per (b, q, m), lane d owns channel d (D <= 32); every lane walks the
// L*P taps, and the four corner reads of a tap are 32 neighbouring channels of
// one value row, one coalesced 64-byte (bf16) or 128-byte (f32) load each.
// What the TPU kernel adds to this function is layout and is not carried
// over: no query padding, no parity-packed value, no row window with an
// overflow tail.
//
// What bounds it: the gathers. The value of one image (11.9 MB in bf16 at
// 832x1344) stays in the 50 MB L2, so the kernel is bound by L2 load
// throughput and latency, not by device-memory bytes or FLOPs.
//
// Location arithmetic uses the round-to-nearest intrinsics of
// msda_common.cuh, so the kernel computes exactly the f32 pixel coordinates
// of the plain PyTorch version.

#include "msda_common.cuh"

static const int kThreads = 256;

// value (B, S, M, D); ref (B, Q, L, 2) f32; off (B, Q, M*L*P*2), (x, y) pairs
// in (m, l, p) order; logit (B, Q, M*L*P) -> out (B, Q, M*D).
template <typename scalar_t>
__global__ void msda_proj_kernel(const scalar_t* __restrict__ value,
                                 const float* __restrict__ ref,
                                 const scalar_t* __restrict__ off,
                                 const scalar_t* __restrict__ logit,
                                 scalar_t* __restrict__ out, long warps, int Q, int S, int M,
                                 int D, int P, Pyramid pyr) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= warps) return;  // whole warps leave together
  const int m = (int)(warp % M);
  const long bq = warp / M;
  const long b = bq / Q;
  const int L = pyr.L;
  const int n = L * P;
  const scalar_t* lg = logit + (bq * M + m) * n;

  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, to_f(lg[i]));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) sum += expf(to_f(lg[i]) - mx);
  const float inv = 1.f / warp_sum(sum);

  const float* r = ref + bq * L * 2;
  const scalar_t* of = off + (bq * M + m) * n * 2;
  const size_t row = (size_t)M * D;
  const scalar_t* vb = value + (size_t)b * S * row + (size_t)m * D;
  const bool active = lane < D;
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const scalar_t* vl = vb + (size_t)pyr.start[l] * row;
    const float rx = r[2 * l], ry = r[2 * l + 1];
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float a = expf(to_f(lg[k]) - mx) * inv;
      const float lx = tap_loc(rx, to_f(of[2 * k]), pyr.inv_w[l]);
      const float ly = tap_loc(ry, to_f(of[2 * k + 1]), pyr.inv_h[l]);
      if (active) acc += a * sample_bilinear(vl, pyr.h[l], pyr.w[l], row, lx, ly, lane);
    }
  }
  if (active) out[(bq * M + m) * D + lane] = from_f<scalar_t>(acc);
}

template <typename scalar_t>
static int launch_proj(void* value, void* ref, void* off, void* logit, void* out, int B, int Q,
                       int S, int M, int D, int P, const int* levels, int L, void* stream) {
  const long warps = (long)B * Q * M;
  const int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  msda_proj_kernel<scalar_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)ref, (const scalar_t*)off, (const scalar_t*)logit,
      (scalar_t*)out, warps, Q, S, M, D, P, make_pyramid(levels, L));
  return (int)cudaGetLastError();
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_proj_f32(void* value, void* ref, void* off, void* logit, void* out, int B, int Q, int S,
                  int M, int D, int P, const int* levels, int L, void* stream) {
  return launch_proj<float>(value, ref, off, logit, out, B, Q, S, M, D, P, levels, L, stream);
}

int msda_proj_bf16(void* value, void* ref, void* off, void* logit, void* out, int B, int Q, int S,
                   int M, int D, int P, const int* levels, int L, void* stream) {
  return launch_proj<__nv_bfloat16>(value, ref, off, logit, out, B, Q, S, M, D, P, levels, L,
                                    stream);
}

}  // extern "C"
