// Backward of multi-scale deformable attention from precomputed taps, for
// Hopper (sm_90a).
//
// K9 msda_taps_bwd <- devis_tpu/ops/ms_deform_attn_pallas.py:_bwd_kernel, the
// backward of the q-major op (the image model's decoder layers with 4-d
// reference points). The caller has expanded every sampling point into its
// four bilinear entries: idx, the level-local raster index of the pixel, and
// wt = bilinear weight * validity * attention weight. From the output
// gradient g the kernel gives
//   grad_value[b, start_l + idx, m, :] += wt * g[b, q, mg, :]   per entry,
//   grad_wt[b, mg, q, l, k]             = value[b, start_l + idx, m, :] . g,
// and the chain rule through the function that made the taps turns grad_wt
// into the gradients of the locations and the attention weights.
//
// `groups` heads of idx, wt and g share one value head: mg = m * G + j reads
// and scatters to value head m (the TPU kernel's grouped value block).
//
// Its own design, not the TPU kernel's one-hot W^T . g: the TPU has no
// scatter, so it multiplies by a one-hot tile; here grad_value is a scatter
// of f32 atomics into an f32 buffer the caller has zeroed (so the sums are
// not bit-reproducible from run to run), and grad_wt is a dot over the D
// channels of the entry's value row. Entries address pixels by plain raster
// index; the TPU's parity packing is layout.
//
// An entry whose index lies outside its level, and an entry of weight 0,
// scatters nothing; the first also gets grad_wt 0. A dead tap inside the
// level may receive a grad_wt: the chain rule's validity mask zeroes it.
//
// What bound the first design (one warp per (b, mg, q), lane d owning
// channel d): the warp walked its L * 4P entries (64 at the image decoder's
// L 4, P 4) one after another, each a 64-byte row load, 32 scalar atomics,
// a 5-step warp sum and a lane-0 store, and re-read the g row every entry:
// 4 800 warps each ran a chain of 64 dependent steps, one wave of latency.
//
// Now, still one warp per (b, mg, q):
//   * lane t reads entry t of each run of 32 (index and weight, coalesced)
//     and resolves it to a value row once (-1 where the index lies outside
//     its level);
//   * the warp is 32 / lanes groups of `lanes` lanes, lane c of a group
//     owning chunk c (and c + lanes, ... up to PER chunks) of the D channels:
//     16 bytes where the value is aligned and D fills them (4 lanes an entry
//     in bf16 at D 32, 8 in f32), else one channel; its chunks of g stay in
//     registers for all entries;
//   * a group takes every (32 / lanes)-th entry, one at a time (two or
//     four in flight measured slower), fetching its row and weight from the
//     owner lane by shuffles: 8 steps in place of 64 at D 32 bf16;
//   * grad_wt is the group's sum of its lanes' partial dots (log2(lanes)
//     shuffles), stored by the group's first lane; grad_value gets wt * g
//     with red.global.add.v4.f32 (one scalar atomic a channel where chunks
//     are single channels). The flush has its own split of the channels:
//     float4 piece p of the f32 row to lane p % lanes, so that one red
//     instruction of a group covers lanes * 16 contiguous bytes (whole
//     32-byte sectors). A bf16 chunk is 8 channels, 32 bytes of f32: flushed
//     from the load split, each red would cover half a sector (measured
//     about a fifth slower at the image decoder's shape). The lane keeps
//     its pieces of g in registers beside its chunks.
// What bounds it: the vector atomics onto grad_value (one 16-byte add per
// live entry and 4 channels, 27 MB at the image decoder's shape, all 4 800
// warps in one wave) and the value rows' gathers from L2; about 2.2x its
// bytes bound (PERF.md).
// `taps_plan` in ms_deform_attn_cuda.py picks vec, lanes and PER, and
// `msda_taps_bwd_mirror` there repeats this index arithmetic on the CPU.

#include "msda_common.cuh"

#define K9_THREADS 256  // 8 warps a block, one (b, mg, q) each
#define K9_MAX_PER 4    // chunks of one entry a lane may own

// dst[0 .. CW) += a * v, with 16-byte vector atomics (dst 16-byte aligned)
// or one scalar atomic (CW 1).
template <int CW>
__device__ __forceinline__ void flush_chunk(float* dst, float a, const float* v) {
  if constexpr (CW == 1) {
    atomicAdd(dst, a * v[0]);
  } else {
#pragma unroll
    for (int c = 0; c < CW; c += 4)
      red_add_v4(dst + c, a * v[c], a * v[c + 1], a * v[c + 2], a * v[c + 3]);
  }
}

// value (B, S, M, D); idx int32 and wt f32 (B, MG, Q, L, K4); g (B, Q, MG*D)
// -> grad_value (B, S, M, D) f32, zeroed by the caller; grad_wt like wt.
// CW channels a chunk (16 bytes, or 1), PER chunks a lane.
template <typename scalar_t, int CW, int PER>
__global__ void __launch_bounds__(K9_THREADS) msda_taps_bwd_kernel(
    const scalar_t* __restrict__ value, const int* __restrict__ idx,
    const float* __restrict__ wt, const scalar_t* __restrict__ g,
    float* __restrict__ grad_value, float* __restrict__ grad_wt, long items, int Q, int S,
    int M, int G, int D, int K4, int lanes, Pyramid pyr) {
  using C = Chunk<scalar_t, CW>;
  const long item = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= items) return;  // whole warps leave together
  const int MG = M * G;
  const int q = (int)(item % Q);
  const int mg = (int)((item / Q) % MG);
  const long b = item / Q / MG;
  const int m = mg / G;
  const int n = pyr.L * K4;
  const int* ix = idx + item * n;
  const float* w = wt + item * n;
  float* gw = grad_wt + item * n;
  const int tpw = 32 / lanes, grp = lane / lanes, sub = lane % lanes;

  // the lane's chunks of the (b, q, mg) output gradient, once
  const scalar_t* go = g + ((b * Q + q) * MG + mg) * (long)D;
  float gr[PER][CW];
  int c0[PER];
  bool on[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    c0[k] = (sub + k * lanes) * CW;
    on[k] = c0[k] < D;
    C::unpack(C::load(go + c0[k], on[k]), gr[k]);
  }
  // the flush's split: FP pieces of FW channels a lane (the chunks
  // themselves where they are at most 16 bytes of f32)
  constexpr bool SPLIT = CW > 4;
  constexpr int FW = SPLIT ? 4 : CW, FP = SPLIT ? PER * CW / 4 : PER;
  float gf[FP][FW];
  int f0[FP];
  bool fon[FP];
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    f0[k] = (sub + k * lanes) * FW;
    fon[k] = f0[k] < D;
#pragma unroll
    for (int c = 0; c < FW; ++c) {
      if constexpr (SPLIT)
        gf[k][c] = fon[k] ? to_f(go[f0[k] + c]) : 0.f;
      else
        gf[k][c] = gr[k][c];
    }
  }

  const size_t row = (size_t)M * D;
  const size_t head = (size_t)b * S * row + (size_t)m * D;
  const scalar_t* vh = value + head;
  float* gh = grad_value + head;
  for (int base = 0; base < n; base += 32) {
    // entry base + lane: its value row and weight, once
    const int t = base + lane;
    int r = -1;
    float we = 0.f;
    if (t < n) {
      const int l = t / K4;
      const int i = ix[t];
      if (i >= 0 && i < pyr.h[l] * pyr.w[l]) r = pyr.start[l] + i;
      we = w[t];
    }
    const int cnt = min(32, n - base);
    for (int j0 = 0; j0 < cnt; j0 += tpw) {
      const int j = j0 + grp;
      const int src = j < cnt ? j : 0;  // every lane shuffles
      const int rj = __shfl_sync(0xffffffffu, r, src);
      const float wj = __shfl_sync(0xffffffffu, we, src);
      const int rw = j < cnt ? rj : -1;
      const scalar_t* vr = vh + (size_t)(rw < 0 ? 0 : rw) * row;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        float v[CW];
        C::unpack(C::load(vr + c0[k], rw >= 0 && on[k]), v);
#pragma unroll
        for (int c = 0; c < CW; ++c) dot = fmaf(v[c], gr[k][c], dot);
      }
      dot = group_sum(dot, lanes);
      if (sub == 0 && j < cnt) gw[base + j] = dot;
      if (rw >= 0 && wj != 0.f) {
        float* dst = gh + (size_t)rw * row;
#pragma unroll
        for (int k = 0; k < FP; ++k)
          if (fon[k]) flush_chunk<FW>(dst + f0[k], wj, gf[k]);
      }
    }
  }
}

// `lanes` a group (a power of two up to 32), `per` chunks a lane (1, 2 or 4)
// and `vec` (16-byte chunks, else one channel) come from the wrapper's
// `taps_plan`: lanes * per chunks must hold D channels. Refuses 16-byte
// access on a value, g or grad_value off 16 bytes.
template <typename scalar_t>
static int launch_taps_bwd(void* value, void* idx, void* wt, void* g, void* grad_value,
                           void* grad_wt, int B, int Q, int S, int M, int G, int D, int K4,
                           int lanes, int per, int vec, const int* levels, int L,
                           void* stream) {
  constexpr int VN = Vec16<scalar_t>::N;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || Q < 1 || S < 1 || M < 1 || G < 1 || D < 1 || K4 < 1 || L < 1 ||
      L > MAX_LEVELS)
    return bad;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (per != 1 && per != 2 && per != K9_MAX_PER) || lanes * per * (vec ? VN : 1) < D)
    return bad;
  if (vec && (D % VN != 0 || (uintptr_t)value % 16 != 0 || (uintptr_t)g % 16 != 0 ||
              (uintptr_t)grad_value % 16 != 0))
    return bad;
  const long items = (long)B * M * G * Q;
  const long blocks = (items * 32 + K9_THREADS - 1) / K9_THREADS;
  if (blocks > 0x7fffffffL) return bad;
  auto kernel = &msda_taps_bwd_kernel<scalar_t, 1, 1>;
  if (vec)
    kernel = per == 1   ? &msda_taps_bwd_kernel<scalar_t, VN, 1>
             : per == 2 ? &msda_taps_bwd_kernel<scalar_t, VN, 2>
                        : &msda_taps_bwd_kernel<scalar_t, VN, K9_MAX_PER>;
  else
    kernel = per == 1   ? &msda_taps_bwd_kernel<scalar_t, 1, 1>
             : per == 2 ? &msda_taps_bwd_kernel<scalar_t, 1, 2>
                        : &msda_taps_bwd_kernel<scalar_t, 1, K9_MAX_PER>;
  kernel<<<(unsigned)blocks, K9_THREADS, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const int*)idx, (const float*)wt, (const scalar_t*)g,
      (float*)grad_value, (float*)grad_wt, items, Q, S, M, G, D, K4, lanes,
      make_pyramid(levels, L));
  return (int)cudaGetLastError();
}

// C entry points. Pointers and the stream arrive as void*; `levels` is
// (L, 2) host ints (h, w). Each returns cudaGetLastError().
extern "C" {

int msda_taps_bwd_f32(void* value, void* idx, void* wt, void* g, void* grad_value, void* grad_wt,
                      int B, int Q, int S, int M, int G, int D, int K4, int lanes, int per,
                      int vec, const int* levels, int L, void* stream) {
  return launch_taps_bwd<float>(value, idx, wt, g, grad_value, grad_wt, B, Q, S, M, G, D, K4,
                                lanes, per, vec, levels, L, stream);
}

int msda_taps_bwd_bf16(void* value, void* idx, void* wt, void* g, void* grad_value,
                       void* grad_wt, int B, int Q, int S, int M, int G, int D, int K4,
                       int lanes, int per, int vec, const int* levels, int L, void* stream) {
  return launch_taps_bwd<__nv_bfloat16>(value, idx, wt, g, grad_value, grad_wt, B, Q, S, M, G,
                                        D, K4, lanes, per, vec, levels, L, stream);
}

}  // extern "C"
