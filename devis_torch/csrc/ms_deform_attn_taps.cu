// Backward of multi-scale deformable attention from precomputed taps, for
// Hopper (sm_90a).
//
// K9 msda_taps_bwd <- devis_tpu/ops/ms_deform_attn_pallas.py:_bwd_kernel, the
// backward of the q-major op (the image model's decoder layers with 4-d
// reference points). The caller has expanded every sampling point into its
// four bilinear entries: idx, the level-local raster index of the pixel, and
// wt = bilinear weight * validity * attention weight. From the output
// gradient g it gives
//   grad_value[b, start_l + idx, m, :] = sum of wt * g[b, q, mg, :] over entries,
//   grad_wt[b, mg, q, l, k]             = value[b, start_l + idx, m, :] . g,
// and the chain rule through the function that made the taps turns grad_wt
// into the gradients of the locations and the attention weights.
//
// `groups` heads of idx, wt and g share one value head: mg = m * G + j reads
// and scatters to value head m (the TPU kernel's grouped value block).
//
// The TPU kernel multiplies by a one-hot tile (the TPU has no scatter) and
// sums grad_value per value tile over the query tiles in grid order. Added
// onto an f32 buffer with atomics, the sums would not be bit-reproducible
// from run to run; so (msda_bwd.cuh) the entries are sorted by value row,
// stably, and the lanes of a value row sum its entries in a fixed order and
// store the row once in the value's type; grad_wt is each entry's dot
// g . value row, which the same lanes form while they hold the row. Entries
// address pixels by plain raster index; the TPU's parity packing is layout.
// An entry whose index lies outside its level adds nothing and gets grad_wt
// 0; a dead tap inside the level may receive a grad_wt, which the chain
// rule's validity mask zeroes. `taps_plan` in ms_deform_attn_cuda.py picks
// the gather's vec, lanes and PER, and `msda_taps_bwd_mirror` there repeats
// the order of its sums on the CPU.

#include "msda_bwd.cuh"

// value (B, S, M, D); idx int32 and wt f32 (B, MG, Q, L, K4); g (B, Q, MG*D)
// -> grad_value (B, S, M, D) in the value's type; grad_wt like wt. Scratch
// as `BwdScratch` says (entries: B * MG * Q * L * K4).
template <typename scalar_t>
static int launch_taps_bwd(void* value, void* idx, void* wt, void* g, void* grad_value,
                           void* grad_wt, void* keys0, void* keys1, void* vals0, void* vals1,
                           void* begin, void* end, void* hist, void* sums, void* top, int B,
                           int Q, int S, int M, int G, int D, int K4, int lanes, int per,
                           int vec, int gpr, const int* levels, int L, void* stream) {
  if (B < 1 || Q < 1 || S < 1 || M < 1 || G < 1 || D < 1 || K4 < 1 || L < 1 ||
      L > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  const long n = (long)B * M * G * Q * L * K4, n_rows = (long)B * S * M;
  if (n > 0x7fffffffL || n_rows >= 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const Pyramid pyr = make_pyramid(levels, L);
  const BwdScratch s{{(unsigned*)keys0, (unsigned*)keys1}, {(unsigned*)vals0, (unsigned*)vals1},
                     (int*)begin, (int*)end, (int*)hist, (int*)sums, (int*)top};
  const cudaStream_t st = (cudaStream_t)stream;
  taps_entries_kernel<k9_bwd><<<(unsigned)bwd_blocks(n, BWD_THREADS), BWD_THREADS, 0, st>>>(
      (const int*)idx, s.keys[0], (float*)grad_wt, n, Q, M * G, G, K4, S, (unsigned)n_rows, pyr);
  return bwd_sort_gather<k9_bwd, scalar_t>(value, g, (const float*)wt, (float*)grad_wt,
                                           grad_value, n, (unsigned)n_rows, D, lanes, per, vec,
                                           gpr, GRows{1, L * K4, M * G, Q, 0}, s, st);
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_taps_bwd_f32(void* value, void* idx, void* wt, void* g, void* grad_value, void* grad_wt,
                      void* keys0, void* keys1, void* vals0, void* vals1, void* begin, void* end,
                      void* hist, void* sums, void* top, int B, int Q, int S, int M, int G, int D,
                      int K4, int lanes, int per, int vec, int gpr, const int* levels, int L,
                      void* stream) {
  return launch_taps_bwd<float>(value, idx, wt, g, grad_value, grad_wt, keys0, keys1, vals0,
                                vals1, begin, end, hist, sums, top, B, Q, S, M, G, D, K4, lanes,
                                per, vec, gpr, levels, L, stream);
}

int msda_taps_bwd_bf16(void* value, void* idx, void* wt, void* g, void* grad_value,
                       void* grad_wt, void* keys0, void* keys1, void* vals0, void* vals1,
                       void* begin, void* end, void* hist, void* sums, void* top, int B, int Q,
                       int S, int M, int G, int D, int K4, int lanes, int per, int vec,
                       int gpr, const int* levels, int L, void* stream) {
  return launch_taps_bwd<__nv_bfloat16>(value, idx, wt, g, grad_value, grad_wt, keys0, keys1,
                                        vals0, vals1, begin, end, hist, sums, top, B, Q, S, M, G,
                                        D, K4, lanes, per, vec, gpr, levels, L, stream);
}

}  // extern "C"
