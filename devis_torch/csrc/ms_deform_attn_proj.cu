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
// device memory. What the TPU kernel adds to this function is layout and is
// not carried over: no query padding, no parity-packed value, no row window
// with an overflow tail.
//
// What bound the first design (one warp per (b, q, m), lane d owning
// channel d): every lane walked the L*P = 16 taps in turn, a dependent
// chain of four 2-byte corner loads (64 bytes a warp instruction) and one
// FMA a tap; each of the 32 lanes recomputed every tap's exp and location
// and read the logits three times. An encoder launch (Q = S = 23 205) took
// about 0.6 ms, 4.5x slower a tap than K1.
//
// Now, still one warp per (b, q, m):
//   * the logits are read once, coalesced, for the maximum; then lane t
//     owns tap t of each run of 32 taps: it reads the tap's logit and
//     offset pair (neighbouring lanes on neighbouring taps), computes its
//     exp and its location and corner once (tap_geometry);
//   * the warp is 32 / lanes groups of `lanes` lanes, lane c of a group
//     owning 16 bytes of channels (4 lanes a tap in bf16 at D 32, 8 in
//     f32); a group takes every (32 / lanes)-th tap, fetching its corner,
//     fractions and exp from the owner lane by shuffles, with the 4 corner
//     loads of K8_UNROLL taps in flight before it uses any;
//   * the groups are summed with shuffles, the sum is divided once by the
//     sum of the exps (the softmax's normalisation, taken out of the tap
//     sum), and group 0 writes the (b, q, m)'s D channels once.
// Where D * itemsize is not a multiple of 16 or the value or output is not
// 16-byte aligned, the same kernel reads and writes its chunks element by
// element (`vec` 0, from the wrapper's `proj_plan`); the launcher refuses
// 16-byte access on misaligned pointers.
//
// Measured (bf16, NVIDIA H100, `kernel_ab.py`; PERF.md section 6): 3.3x
// faster at the encoder (Q = S = 23 205) and at decoder layer 0 (Q 300).
// Two taps in flight a lane beat four (fewer registers, more warps). What
// bounds it now: the corner gathers from L2 (the image's value, 11.9 MB,
// stays there), 0.66 GB of live corners a launch at about 3.6 TB/s, and
// their latency; the bound by device-memory bytes (0.013 ms) is out of reach
// of a kernel that does not stage value rows on chip.
//
// Location arithmetic uses the round-to-nearest intrinsics of
// msda_common.cuh, so the kernel computes exactly the f32 pixel coordinates
// of the plain PyTorch version.

#include "msda_common.cuh"

#define K8_THREADS 256  // 8 warps a block, one (b, q, m) each
#define K8_UNROLL 2     // taps a lane group has in flight

// value (B, S, M, D); ref (B, Q, L, 2) f32; off (B, Q, M*L*P*2), (x, y) pairs
// in (m, l, p) order; logit (B, Q, M*L*P) -> out (B, Q, M*D). CW channels a
// thread: 16 bytes, or 1 (any alignment).
template <typename scalar_t, int CW>
__global__ void __launch_bounds__(K8_THREADS) msda_proj_kernel(
    const scalar_t* __restrict__ value, const float* __restrict__ ref,
    const scalar_t* __restrict__ off, const scalar_t* __restrict__ logit,
    scalar_t* __restrict__ out, long items, int Q, int S, int M, int D, int P, int pshift,
    int lanes, Pyramid pyr) {
  using C = Chunk<scalar_t, CW>;
  const long item = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= items) return;  // whole warps leave together
  const int m = (int)(item % M);
  const long bq = item / M, b = bq / Q;
  const int n = pyr.L * P;
  const scalar_t* lg = logit + item * n;
  const scalar_t* of = off + item * n * 2;
  const float* r = ref + bq * pyr.L * 2;

  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, to_f(lg[i]));
  mx = warp_max(mx);

  const int tpw = 32 / lanes, grp = lane / lanes, c0 = (lane % lanes) * CW;
  const bool chan = c0 < D;
  const size_t row = (size_t)M * D;
  const scalar_t* vm = value + (size_t)b * S * row + (size_t)m * D + c0;
  float acc[CW], esum = 0.f;
#pragma unroll
  for (int v = 0; v < CW; ++v) acc[v] = 0.f;
  for (int base = 0; base < n; base += 32) {
    // tap base + lane: its exp, location and corner, once
    const int t = base + lane;
    unsigned packed = TAP_DEAD;
    float dx = 0.f, dy = 0.f, e = 0.f;
    if (t < n) {
      e = expf(to_f(lg[t]) - mx);
      esum += e;
      const int l = tap_level(t, P, pshift);
      const float lx = tap_loc(r[2 * l], to_f(of[2 * t]), pyr.inv_w[l]);
      const float ly = tap_loc(r[2 * l + 1], to_f(of[2 * t + 1]), pyr.inv_h[l]);
      int x0, y0;
      if (tap_geometry(pyr.h[l], pyr.w[l], lx, ly, x0, y0, dx, dy))
        packed = ((unsigned)(y0 + 1) << 16) | (unsigned)(x0 + 1);
    }
    const int cnt = min(32, n - base);
    for (int j0 = 0; j0 < cnt; j0 += K8_UNROLL * tpw) {
      typename C::raw_t raw[K8_UNROLL][4];
      float wt[K8_UNROLL][4], a[K8_UNROLL];
#pragma unroll
      for (int u = 0; u < K8_UNROLL; ++u) {
        const int j = j0 + grp + u * tpw;
        const bool on = j < cnt && chan;
        const int src = j < cnt ? j : 0;  // every lane shuffles
        const unsigned pk = __shfl_sync(0xffffffffu, packed, src);
        const float tdx = __shfl_sync(0xffffffffu, dx, src);
        const float tdy = __shfl_sync(0xffffffffu, dy, src);
        a[u] = __shfl_sync(0xffffffffu, e, src);
        const int l = on ? tap_level(base + j, P, pshift) : 0;
        tap_corners<scalar_t, CW>(vm + (size_t)pyr.start[l] * row, pyr.h[l], pyr.w[l], row,
                                  on ? pk : TAP_DEAD, tdx, tdy, raw[u], wt[u]);
      }
#pragma unroll
      for (int u = 0; u < K8_UNROLL; ++u) tap_accumulate<scalar_t, CW>(acc, a[u], raw[u], wt[u]);
    }
  }
  const float inv = 1.f / warp_sum(esum);
  for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < CW; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  if (grp == 0 && chan) {
#pragma unroll
    for (int v = 0; v < CW; ++v) acc[v] *= inv;
    C::store(out + item * D + c0, acc);
  }
}

// `lanes` a tap (a power of two up to 32 whose chunks hold D channels) and
// `vec` (16-byte chunks, else one channel a lane) come from the wrapper's
// `proj_plan`. Refuses 16-byte access on a value or output off 16 bytes.
template <typename scalar_t>
static int launch_proj(void* value, void* ref, void* off, void* logit, void* out, int B, int Q,
                       int S, int M, int D, int P, int lanes, int vec, const int* levels, int L,
                       void* stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || Q < 1 || M < 1 || D < 1 || P < 1 || L < 1 || L > MAX_LEVELS) return bad;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || lanes * (vec ? VN : 1) < D)
    return bad;
  if (vec && (D % VN != 0 || (uintptr_t)value % 16 != 0 || (uintptr_t)out % 16 != 0))
    return bad;
  const Pyramid pyr = make_pyramid(levels, L);
  for (int l = 0; l < L; ++l)
    if (pyr.h[l] >= 0xffff || pyr.w[l] >= 0xffff) return bad;  // packed corners
  const long items = (long)B * Q * M;
  const long blocks = (items * 32 + K8_THREADS - 1) / K8_THREADS;
  if (blocks > 0x7fffffffL) return bad;
  auto kernel = vec ? &msda_proj_kernel<scalar_t, VN> : &msda_proj_kernel<scalar_t, 1>;
  kernel<<<(unsigned)blocks, K8_THREADS, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)ref, (const scalar_t*)off, (const scalar_t*)logit,
      (scalar_t*)out, items, Q, S, M, D, P, point_shift(P), lanes, pyr);
  return (int)cudaGetLastError();
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_proj_f32(void* value, void* ref, void* off, void* logit, void* out, int B, int Q, int S,
                  int M, int D, int P, int lanes, int vec, const int* levels, int L,
                  void* stream) {
  return launch_proj<float>(value, ref, off, logit, out, B, Q, S, M, D, P, lanes, vec, levels,
                            L, stream);
}

int msda_proj_bf16(void* value, void* ref, void* off, void* logit, void* out, int B, int Q, int S,
                   int M, int D, int P, int lanes, int vec, const int* levels, int L,
                   void* stream) {
  return launch_proj<__nv_bfloat16>(value, ref, off, logit, out, B, Q, S, M, D, P, lanes, vec,
                                    levels, L, stream);
}

}  // extern "C"
