"""Deformable-attention kernels (K1-K3, K5-K9) and their plain versions.

The port's counterpart of `devis_tpu/ops/ms_deform_attn_pallas.py`. Each
public op takes the JAX package's q-major layout and dispatches on where its
tensors lie: on the CPU it runs the plain PyTorch version; on a CUDA device it
launches the hand-written kernel from `csrc/ms_deform_attn*.cu`, or raises. `launches` counts kernel launches
and `plain_calls` CPU dispatches, per op; each of them runs in a span (`util.trace`) named after the
kernel: `msda.K1_temporal_proj` (K2's inside it), `msda.K2_tap_window`, `msda.K3_temporal`,
`msda.K5_temporal_bwd`, `msda.K6_rows`, `msda.K7_rows_bwd`, `msda.K8_proj`, `msda.K9_taps_bwd`.

  * K1 `msda_temporal_proj` (encoder; replaces `_fwd_kernel_temporal_proj`):
    value (T, S, M, D), per-level references (T, Q, L, 2) and the raw outputs
    of the four projections: current offsets (T, Q, M*L*P*2), temporal
    offsets (T, Q, M*W*L*P*2), current logits (T, Q, M*L*P), temporal
    logits (T, Q, M*W*L*P). Locations = ref + off / (w_l, h_l) with the
    temporal reference pinned to level 0; weights = one softmax per
    (t, q, m) over the current and temporal logits together. On the card
    the op launches K2, then K1 on K2's windows: per (t, m, q-block) and
    (frame slot, level) K1 stages the first `window_plan` rows of the window
    in shared memory and reads every other live corner where it lies.
  * K2 `msda_tap_window` (replaces `_ranges_proj_kernel`): per
    (t, m, q-block, level) the first and last raster row of the level that a
    live K1 tap touches, (0, -1) where none does. Unpacked rows, q-blocks of
    `Q_BLOCK`.
  * K3 `msda_temporal` (decoder; replaces `_fwd_kernel_temporal`):
    precomputed loc (T, Q, M, Lf, P, 2) and att (T, Q, M, Lf, P) over the
    fused level stack.
  * K5 `msda_temporal_bwd` (replaces `_bwd_kernel_rows_temporal`): from the
    output gradient (T, Q, M*D), the gradients of value, loc and att.
  * K6 `msda_rows` (replaces `_fwd_kernel_fused`) and K7 `msda_rows_bwd`
    (replaces `_bwd_kernel_rows`): single-frame attention, value
    (B, S, M, D) at any D, loc (B, Q, M, L, P, 2), att (B, Q, M, L, P), and
    its backward. K6 takes raster runs
    of (b, q, m) in the split `rows_plan` gives: each tap's geometry
    computed once, chunks of channels over the threads, taps over groups of
    threads where the launch is too small to fill the card.
  * K5, K7 and K9 share one backward in a fixed order (`csrc/msda_bwd.cuh`):
    the corners' entries (value row, weight) are sorted by value row, stably,
    one warp a value row sums its entries in entry order and writes the row
    once in the value's dtype, and each entry's dot g . row gives the weight
    and location gradients (K9: grad_wt). The sort is a global radix sort
    (K9, and K5/K7 where `bwd_route` says) or, for K5 and K7, a sort of each
    run of one (head, stage, query frame) on its level's pixels alone, a row
    then walking its frame's runs in run order: the same order, the same
    bits. Equal inputs give equal bits on every run, as the JAX kernels' one
    owner a value tile does. `msda_bwd_mirror` and `msda_taps_bwd_mirror`
    repeat that order on the CPU, tile, run and row order as arguments.
  * K8 `msda_proj` (replaces `_fwd_kernel_proj`): single-frame attention
    from the raw projections, the image model's encoder and first decoder
    layer: value (B, S, M, D), references (B, Q, L, 2), offsets
    (B, Q, M*L*P*2), logits (B, Q, M*L*P). Locations = ref + off / (w_l, h_l)
    and one softmax per (b, q, m) over L*P, both inside the kernel: a warp
    per (b, q, m), its taps over groups of `proj_plan(...).lanes` lanes.
  * K9 `msda_taps_bwd` (replaces `_bwd_kernel`): the backward of the q-major
    op from precomputed taps: idx, wt (B, MG, Q, L, 4P) from `taps`, the
    output gradient (B, Q, MG*D) -> grad_value and grad_wt. MG = M * G heads
    may share the M value heads. `msda_taps` is that op: forward K6,
    backward K9 plus the chain rule through `taps` (the image decoder's
    layers with 4-d reference points).

On a CUDA tensor K1, K3, K6 and K8 run as `torch.autograd.Function`s whose
backward is K5, K5, K7 and K7 (`msda_taps`: K6 forward, K9 backward). K1's backward rebuilds loc and att from the raw projections
under autograd, launches K5 and lets autograd chain the loc and att gradients
to references, offsets and logits. On the CPU autograd differentiates the
plain versions.

Levels run frame-major: the current frame's L levels, then L levels for each
of the W frames the rule names (`temporal_frame_rule`). The value is read per
frame; no stacked copy is made.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
from ..util import trace
from .ms_deform_attn import (Shapes, level_start_index, ms_deform_attn,
                             ms_deform_attn_temporal_plain, normalize_shapes,
                             rule_window, temporal_frame_table)

Q_BLOCK = 128
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_LEVELS = 16
_MAX_WINDOW = 16              # offsets of a window rule (csrc `FrameRule.off`)
K1_MAX_STAGES = (1 + _MAX_WINDOW) * _MAX_LEVELS   # csrc `K1_MAX_LF`: (1 + W) * L
# K1's shared memory (csrc/ms_deform_attn.cu): a head of softmax statistics
# and window bounds (three ints a stage), 32 bytes of tap (rows and weights)
# per (query, point), and two stage buffers of value rows padded to 16 bytes
K1_HEAD_BYTES = 2 * Q_BLOCK * 4 + 3 * K1_MAX_STAGES * 4
K1_TAP_BYTES = 32
SMEM_PER_SM = 233472          # 228 KB on an H100 SM
SMEM_PER_BLOCK = 232448       # 227 KB, the most one block may take
SMEM_RESERVED = 1024          # the runtime's share of every block
# the kernel lab's variants of K1 (csrc/ms_deform_attn.cu, `K1_*`); only
# "full" runs on a model path
K1_MODES = ("full", "nostage", "noloc", "nogather", "noacc", "count")


def _inv(spatial_shapes: Shapes, device):
    # f32 reciprocals of the level sizes, as the kernels compute them
    inv_w = torch.tensor([1.0 / w for _, w in spatial_shapes], dtype=torch.float32,
                         device=device)
    inv_h = torch.tensor([1.0 / h for h, _ in spatial_shapes], dtype=torch.float32,
                         device=device)
    return inv_w, inv_h


def temporal_proj_locations(spatial_shapes, ref, c_off, t_off, n_heads: int):
    """(T, Q, M, Lf, P, 2) f32 locations from references and raw offsets,
    with the same f32 operations as K1 and K2."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    T, Q, L, _ = ref.shape
    M = n_heads
    P = c_off.shape[-1] // (M * L * 2)
    W = t_off.shape[-1] // (M * L * P * 2)
    inv_w, inv_h = _inv(spatial_shapes, ref.device)
    ref = ref.float()
    co = c_off.float().reshape(T, Q, M, L, P, 2)
    to = t_off.float().reshape(T, Q, M, W, L, P, 2)
    lx_c = ref[:, :, None, :, None, 0] + co[..., 0] * inv_w[:, None]
    ly_c = ref[:, :, None, :, None, 1] + co[..., 1] * inv_h[:, None]
    r0 = ref[:, :, 0]                                    # level-0 reference
    lx_t = r0[:, :, None, None, None, None, 0] + to[..., 0] * inv_w[:, None]
    ly_t = r0[:, :, None, None, None, None, 1] + to[..., 1] * inv_h[:, None]
    loc_c = torch.stack([lx_c, ly_c], -1)
    loc_t = torch.stack([lx_t, ly_t], -1).reshape(T, Q, M, W * L, P, 2)
    return torch.cat([loc_c, loc_t], dim=3)


def temporal_proj_weights(c_logit, t_logit, n_heads: int, n_levels: int):
    """(T, Q, M, Lf, P) f32 joint softmax of current and temporal logits."""
    T, Q, _ = c_logit.shape
    M = n_heads
    logits = torch.cat([c_logit.float().reshape(T, Q, M, -1),
                        t_logit.float().reshape(T, Q, M, -1)], dim=-1)
    P = c_logit.shape[-1] // (M * n_levels)
    return torch.softmax(logits, dim=-1).reshape(T, Q, M, -1, P)


def msda_temporal_proj_plain(value, spatial_shapes, ref, c_off, t_off,
                             c_logit, t_logit, rule):
    """Plain K1: the rows are built in PyTorch, then sampled."""
    M = value.shape[2]
    loc = temporal_proj_locations(spatial_shapes, ref, c_off, t_off, M)
    att = temporal_proj_weights(c_logit, t_logit, M, len(spatial_shapes))
    return ms_deform_attn_temporal_plain(value, spatial_shapes, loc, att, rule)


def stage_buffer_rows(caps, n_levels: int, window: int):
    """Rows of K1's two stage buffers for per-level capacities `caps`:
    stage s = j * L + l (frame slot j, level l) loads into buffer s % 2."""
    n_stages = (1 + window) * n_levels
    return tuple(max([caps[s % n_levels] for s in range(b, n_stages, 2)], default=0)
                 for b in (0, 1))


def k1_smem_bytes(caps, n_levels: int, window: int, dtype, head_dim: int,
                  n_points: int) -> int:
    """Dynamic shared memory of one K1 block, as the kernel lays it out."""
    item = torch.finfo(dtype).bits // 8
    vec = 16 // item
    row = -(-head_dim // vec) * vec * item
    return (K1_HEAD_BYTES + Q_BLOCK * n_points * K1_TAP_BYTES
            + sum(stage_buffer_rows(caps, n_levels, window)) * row)


def window_plan(spatial_shapes, dtype, head_dim: int = 32, n_points: int = 4,
                blocks_per_sm: int = 2):
    """K1's staging capacity per level, in value rows: the same number k of
    raster lines of every level (its whole height where that is less), k as
    large as lets `blocks_per_sm` blocks share an SM's shared memory. A
    window holds the rows that a block's 128 raster-ordered queries reach,
    a band of lines at every level, so a band of k lines is the natural unit.
    The plan assumes temporal frames (W >= 1), whose stages alternate
    buffers across frames when L is odd."""
    return _window_plan(normalize_shapes(spatial_shapes), dtype, head_dim, n_points,
                        blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _window_plan(spatial_shapes, dtype, head_dim, n_points, blocks_per_sm):
    L = len(spatial_shapes)
    budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks_per_sm - SMEM_RESERVED)

    def caps(k):
        return tuple(min(h, k) * w for h, w in spatial_shapes)

    def fits(k):
        return k1_smem_bytes(caps(k), L, 1, dtype, head_dim, n_points) <= budget

    if not fits(0):
        raise ValueError(f"window_plan: {n_points} points a level leave no shared memory "
                         f"for {blocks_per_sm} blocks an SM")
    k = 0
    while k < max(h for h, _ in spatial_shapes) and fits(k + 1):
        k += 1
    return caps(k)


# K2's launch (csrc/ms_deform_attn.cu, `msda_tap_window_kernel`): one block
# per (t, q-block, group of G heads); a thread takes one load of VP (x, y)
# offset pairs of a query, the same load of every qpp-th query
@functools.lru_cache(maxsize=None)
def tap_window_plan(n_heads: int, window: int, n_levels: int, n_points: int, dtype,
                    aligned: bool = True):
    """(G, threads, VP) of a K2 launch: VP pairs a load (16 bytes where the
    offsets are `aligned` to 16 bytes and 16 bytes of pairs divide a level's
    P points, so that a load is of one (head, stage); else one pair), G heads
    a block (the most whose loads of one query fit in the kernel's most
    threads: the block stages its queries' references once for all its
    heads), and the threads of a block: whole queries' loads, at most that
    many, rounded up to a warp."""
    most = _build.source_define("ms_deform_attn", "K2_MAX_THREADS")
    vp16 = 16 // (torch.finfo(dtype).bits // 8) // 2
    vp = vp16 if aligned and n_points % vp16 == 0 else 1

    def loads(G):
        return (1 + window) * G * n_levels * n_points // vp

    G = max(G for G in range(1, n_heads + 1) if n_heads % G == 0 and
            (G == 1 or loads(G) <= most))
    vq = loads(G)
    used = max(most // vq, 1) * vq if vq <= most else most
    return G, min(-(-used // 32) * 32, most), vp


def tap_window_grid(T: int, Q: int, n_heads: int, plan):
    """(blocks, threads a block) of a K2 launch with `plan`."""
    return T * -(-Q // Q_BLOCK) * (n_heads // plan[0]), plan[1]


def msda_tap_window_plain(spatial_shapes, ref, c_off, t_off, n_heads: int,
                          q_block: int = Q_BLOCK):
    """Plain K2 → (T, M, n_qblocks, Lf, 2) int32 [first, last] rows."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    loc = temporal_proj_locations(spatial_shapes, ref, c_off, t_off, n_heads)
    T, Q, M, Lf, P, _ = loc.shape
    L = len(spatial_shapes)
    nqb = -(-Q // q_block)
    big = torch.iinfo(torch.int32).max
    firsts, lasts = [], []
    for lvl in range(Lf):
        h, w = spatial_shapes[lvl % L]
        x = loc[:, :, :, lvl, :, 0] * w - 0.5                 # (T, Q, M, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        live = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0 = torch.floor(torch.where(live, x, 0.0)).long()
        y0 = torch.floor(torch.where(live, y, 0.0)).long()
        lo = y0.clamp(0, h - 1) * w + x0.clamp(0, w - 1)
        hi = (y0 + 1).clamp(0, h - 1) * w + (x0 + 1).clamp(0, w - 1)
        lo = torch.where(live, lo, big)
        hi = torch.where(live, hi, -1)
        pad = nqb * q_block - Q
        lo = torch.nn.functional.pad(lo, (0, 0, 0, 0, 0, pad), value=big)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, 0, 0, pad), value=-1)
        lo = lo.reshape(T, nqb, q_block, M, P).amin(dim=(2, 4))  # (T, nqb, M)
        hi = hi.reshape(T, nqb, q_block, M, P).amax(dim=(2, 4))
        firsts.append(torch.where(hi >= 0, lo, 0))
        lasts.append(hi)
    out = torch.stack([torch.stack(firsts, -1), torch.stack(lasts, -1)], -1)
    return out.permute(0, 2, 1, 3, 4).to(torch.int32).contiguous()


def msda_temporal_proj_windowed_plain(value, spatial_shapes, ref, c_off, t_off,
                                      c_logit, t_logit, rule, windows, plan,
                                      q_block: int = Q_BLOCK):
    """Plain K1 as the windowed kernel reads its value: per (t, m, q-block)
    and stage (frame slot j, level l) the first min(n, plan[l]) rows of K2's
    window [first, first + n) are copied to a stage buffer (its other rows
    are NaN); a live corner inside the copied rows reads the buffer, every
    other live corner reads the value where it lies. `windows` is K2's
    (T, M, n_qblocks, Lf, 2) output for `q_block`. Returns (out (T, Q, M*D)
    in the value's dtype, reads): reads[0] counts the corners read from the
    value in windows that fit their capacity (0 wherever the windows cover
    every tap), reads[1] those in windows that do not."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    T, _, M, D = value.shape
    L = len(spatial_shapes)
    loc = temporal_proj_locations(spatial_shapes, ref, c_off, t_off, M)
    att = temporal_proj_weights(c_logit, t_logit, M, L)
    Q, Lf = loc.shape[1], loc.shape[3]
    dev = value.device
    table = torch.as_tensor(temporal_frame_table(rule, T), dtype=torch.long, device=dev)
    frames = torch.cat([torch.arange(T, device=dev)[:, None],
                        table.reshape(T, Lf // L - 1)], 1)
    starts = level_start_index(spatial_shapes)
    qb = torch.arange(Q, device=dev) // q_block
    ti = torch.arange(T, device=dev)[:, None, None, None]
    mi = torch.arange(M, device=dev)[None, None, :, None]
    v = value.float()
    out = torch.zeros(T, Q, M, D, dtype=torch.float32, device=dev)
    reads = torch.zeros(2, dtype=torch.long)
    nan = torch.tensor(float("nan"), device=dev)
    for s in range(Lf):
        j, l = divmod(s, L)
        h, w = spatial_shapes[l]
        cap = int(plan[l])
        lvl = v[frames[:, j], starts[l]:starts[l] + h * w]          # (T, hw, M, D)
        first = windows[:, :, :, s, 0].long()                       # (T, M, nqb)
        n = (windows[:, :, :, s, 1].long() - first + 1).clamp(min=0)
        nst = n.clamp(max=cap)
        if cap:
            r = torch.arange(cap, device=dev)
            rows = (first[..., None] + r).clamp(max=h * w - 1)        # (T, M, nqb, cap)
            stage = lvl[ti, rows, mi.reshape(1, M, 1, 1)]            # (T, M, nqb, cap, D)
            stage = torch.where((r < nst[..., None])[..., None], stage, nan)
        # per query (T, Q, M, 1) for the P points
        first_q = first[:, :, qb].permute(0, 2, 1)[..., None]
        nst_q = nst[:, :, qb].permute(0, 2, 1)[..., None]
        fits_q = (n <= cap)[:, :, qb].permute(0, 2, 1)[..., None]
        x = loc[:, :, :, s, :, 0] * w - 0.5                          # (T, Q, M, P)
        y = loc[:, :, :, s, :, 1] * h - 0.5
        live = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0f = torch.floor(torch.where(live, x, 0.0))
        y0f = torch.floor(torch.where(live, y, 0.0))
        dx, dy = x - x0f, y - y0f
        x0, y0 = x0f.long(), y0f.long()
        a = att[:, :, :, s]
        for oy, ox, wt in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                           (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
            yi, xi = y0 + oy, x0 + ox
            ok = live & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            row = (yi * w + xi).clamp(0, h * w - 1)
            rel = row - first_q
            staged = ok & (rel >= 0) & (rel < nst_q)
            glob = ok & ~staged
            val = torch.where(glob[..., None], lvl[ti, row, mi], 0.0)
            if cap:
                vs = stage[ti, mi, qb[None, :, None, None], rel.clamp(0, cap - 1)]
                val = torch.where(staged[..., None], vs, val)
            out += ((a * wt)[..., None] * val).sum(3)
            reads[0] += int((glob & fits_q).sum())
            reads[1] += int((glob & ~fits_q).sum())
    return out.reshape(T, Q, M * D).to(value.dtype), reads


def _plain_backward(fn, value, loc, att, grad_out):
    """Gradients of a plain attention `fn(value, loc, att)` by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (value, loc, att)]
        out = fn(*leaves)
    return torch.autograd.grad(out, leaves, grad_out.to(out.dtype))


def msda_temporal_bwd_plain(value, spatial_shapes, loc, att, grad_out, rule):
    """Plain K5: autograd of the plain temporal attention. Returns
    (grad_value in the value's dtype, grad_loc f32, grad_att f32)."""
    return _plain_backward(
        lambda v, l, a: ms_deform_attn_temporal_plain(v, spatial_shapes, l, a, rule),
        value, loc, att, grad_out)


def msda_rows_bwd_plain(value, spatial_shapes, loc, att, grad_out):
    """Plain K7: autograd of the plain single-frame attention."""
    return _plain_backward(
        lambda v, l, a: ms_deform_attn(v, spatial_shapes, l, a),
        value, loc, att, grad_out)


# ---------------------------------------------------------------------------
# K5, K7 and K9 in a fixed order: the transpose and the gather, and their
# mirror on the CPU
# ---------------------------------------------------------------------------

def _bwd_define(macro: str) -> int:
    return _build.source_define("msda_bwd.cuh", macro)


def bwd_sort_plan(n_rows: int):
    """(passes, bits a digit) of the radix sort over keys 0 .. n_rows (the
    last one a corner outside its level): 8 bits at most a digit, the
    key's bits split evenly over the fewest passes."""
    bits = max(int(n_rows).bit_length(), 1)
    passes = -(-bits // 8)
    return passes, -(-bits // passes)


def bwd_scratch(n_entries: int, n_rows: int, device, weights: bool = True):
    """Device scratch of one K5, K7 or K9 launch (csrc/msda_bwd.cuh
    `BwdScratch`): keys and sorted entry indices twice, begin and end a value
    row (zeroed), the tiles' digit histograms, the scan's tile totals and its
    top total; with `weights`, the corners' weights and dots (K9 reads its
    weights and writes its dots in place: wt, grad_wt)."""
    tiles = -(-n_entries // _bwd_define("BWD_TILE"))
    hist = 256 * tiles
    if -(-hist // _bwd_define("BWD_SCAN_TILE")) > _bwd_define("BWD_SCAN_TOP"):
        raise ValueError(f"bwd_scratch: {n_entries} entries are more than the scan takes")
    i32 = dict(dtype=torch.int32, device=device)
    n = max(n_entries, 1)
    out = dict(keys=[torch.empty(n, **i32) for _ in range(2)],
               vals=[torch.empty(n, **i32) for _ in range(2)],
               begin=torch.zeros(n_rows, **i32), end=torch.zeros(n_rows, **i32),
               hist=torch.empty(max(hist, 1), **i32),
               sums=torch.empty(max(-(-hist // _bwd_define("BWD_SCAN_TILE")), 1), **i32),
               top=torch.empty(1, **i32))
    if weights:
        out["wts"] = torch.empty(n, dtype=torch.float32, device=device)
        out["dots"] = torch.empty(n, dtype=torch.float32, device=device)
    return out


def bwd_groups(plan, n_entries: int, n_rows: int) -> int:
    """Lane groups a value row takes in the gather (`gpr`): the largest
    power of two at most the mean entries a row over `BWD_UNROLL` (a group
    takes that many entries a step), at least 1, at most 32 / plan.lanes (a
    row in one warp). The rest of the warp takes other rows."""
    mean = n_entries / max(n_rows, 1)
    g = 1
    while 2 * g * _bwd_define("BWD_UNROLL") <= mean and 2 * g * plan.lanes <= 32:
        g *= 2
    return g


# The run-wise route of K5 and K7 (csrc/msda_bwd.cuh `run_sort_kernel`,
# `run_gather_kernel`): the entries of one (head m, stage s = j * L + l,
# query frame n) lie together, a run R = ((m * J + j) * L + l) * N + n of
# E = Q * P * 4; each run is sorted stably on its level's pixels within its
# own range, and a value row takes its frame's runs' segments in run order.
RUN_DEAD = -1                 # a corner outside its level, as a local key (csrc RUN_DEAD)


class RunPlan(collections.namedtuple("RunPlan", "E N J M hw lb nb zoff Z")):
    """csrc `RunPlan`: per level its pixels `hw`, a bucket's pixels 2^lb,
    its buckets `nb` and where its runs start in the offs table (hw + 1 ints
    a run); two passes where any level has more than one bucket, the first
    packing a run-local entry index of `ebits` bits and the pixel's low bits
    above it."""

    @property
    def ebits(self) -> int:
        return max(1, (self.E - 1).bit_length())

    @property
    def two(self) -> bool:
        return max(self.nb) > 1

    @property
    def runs(self) -> int:
        return self.M * self.J * len(self.hw) * self.N

    @property
    def offs_size(self) -> int:
        return self.M * self.J * self.N * self.Z

    @property
    def bkt_size(self) -> int:
        """The first pass's bucket table: nb_max + 1 ints a run."""
        return self.runs * (max(self.nb) + 1) if self.two else 0

    def coords(self, R: int):
        """(m, j, l, n) of run R."""
        L = len(self.hw)
        return R // (self.N * L * self.J), R // (self.N * L) % self.J, R // self.N % L, R % self.N

    def table(self, m: int, j: int, l: int, n: int) -> int:
        """Where run (m, j, l, n)'s part of the offs table starts."""
        return ((m * self.J + j) * self.Z + self.zoff[l]) * self.N + n * (self.hw[l] + 1)

    def passes(self):
        """(mode, blocks, bins, warps, shared-memory bytes) of each launch of
        the sort (`run_sort_launch`): the counters, and the first of two
        passes' staged rounds or the second's staged bucket."""
        if not self.two:
            launches = [("one", self.runs, max(self.hw), _bwd_define("RUN_MAX_WARPS"), 0)]
        else:
            cache = _bwd_define("RUN_CACHE") * 8
            launches = [("high", self.runs, max(self.nb), _bwd_define("RUN_HIGH_WARPS"), 0),
                        ("low", self.runs * max(self.nb),
                         max(min(1 << lb, hw) for lb, hw in zip(self.lb, self.hw)),
                         _bwd_define("RUN_LOW_WARPS"), cache)]
        out = []
        for mode, blocks, bins, most, extra in launches:
            nw = run_warps(bins, most)
            ints = ((2 * nw + 1) * bins + 3 * 32 * _bwd_define("RUN_UNROLL") * nw
                    if mode == "high" else -(-(nw + 1) * bins // 2) * 2)
            out.append((mode, blocks, bins, nw, 4 * ints + extra))
        return out


def run_warps(bins: int, most: int) -> int:
    """Warps a block of the run-wise sort takes (csrc `run_warps`)."""
    nw = most
    while nw > 1 and nw * bins > _bwd_define("RUN_SMEM_INTS"):
        nw >>= 1
    return nw


def run_plan(spatial_shapes, Q: int, P: int, N: int, J: int, M: int, bucket: int = 0,
             strict: bool = True):
    """The run-wise sort's plan (csrc `make_run_plan`), buckets of about
    `bucket` entries (0: RUN_BUCKET): a level's buckets hold 2^lb pixels, lb
    the largest (at most log2 RUN_BINS) with E * 2^lb / hw at most `bucket`.
    Where the kernels would refuse it: raises, or with `strict` False
    returns None."""
    bins = _bwd_define("RUN_BINS")
    bucket = bucket or _bwd_define("RUN_BUCKET")
    E = 4 * Q * P
    hw = tuple(h * w for h, w in spatial_shapes)
    lbs = []
    for x in hw:
        lb = 0
        while (2 << lb) <= x * bucket // max(E, 1) and (2 << lb) <= bins:
            lb += 1
        lbs.append(lb)
    nb = tuple(-(-x // (1 << lb)) for x, lb in zip(hw, lbs))
    zoff = tuple(sum(x + 1 for x in hw[:l]) for l in range(len(hw)))
    plan = RunPlan(E, N, J, M, hw, tuple(lbs), nb, zoff, sum(hw) + len(hw))
    if E < 1 or bucket < 1 or plan.offs_size >= 2 ** 31 or plan.runs * E >= 2 ** 31 or \
            max(nb) > bins or (plan.two and plan.ebits + max(lbs) > 32):
        if strict:
            raise ValueError(f"run_plan: {max(nb)} buckets a level (at most {bins}), "
                             f"{plan.offs_size} ints of tables, {plan.runs * E} entries")
        return None
    return plan


def bwd_route(spatial_shapes, Q: int, P: int, N: int, J: int, M: int) -> int:
    """The sort K5 and K7 take (the `bucket` of their C entries): 0, the
    run-wise sort with buckets of about RUN_BUCKET entries, where a run
    holds at least as many entries as its largest level has pixels, there
    are at least RUN_MIN_RUNS runs (the first pass takes a block a run) and
    `run_plan` fits; else -1, the global sort (K5 at the decoder's 10
    queries, where the per-run tables would outweigh the entries; K7 at the
    image encoder's 64 runs). Either gives the same bits."""
    runs = M * J * len(spatial_shapes) * N
    if 4 * Q * P < max(h * w for h, w in spatial_shapes) or runs < _bwd_define("RUN_MIN_RUNS"):
        return -1
    return -1 if run_plan(spatial_shapes, Q, P, N, J, M, strict=False) is None else 0


def run_feeds(frames, n_frames: int):
    """The gather's table of runs a value frame is read by: items j * N + n
    (frame slot j of query frame n, `frames` (N, J)) whose frame is f, in
    run order, at feed[ptr[f]:ptr[f + 1]]. Returns (ptr (F + 1,), feed
    (N * J,)) int32."""
    frames = torch.as_tensor(frames, dtype=torch.long)
    flat = frames.t().reshape(-1)                       # item j * N + n
    feed = torch.sort(flat, stable=True).indices
    ptr = torch.zeros(n_frames + 1, dtype=torch.long)
    ptr[1:] = torch.cumsum(torch.bincount(flat, minlength=n_frames), 0)
    return ptr.int(), feed.int()


@functools.lru_cache(maxsize=64)
def _device_feeds(frames_key, n_frames: int, device):
    """`run_feeds` on `device`, and the most runs a frame is read by."""
    ptr, feed = run_feeds(torch.tensor(frames_key), n_frames)
    return ptr.to(device), feed.to(device), int((ptr[1:] - ptr[:-1]).max())


def run_scratch(n_entries: int, plan: RunPlan, device):
    """Device scratch of one run-wise K5 or K7 launch (csrc `RunScratch`):
    the local keys, the weights and the dots in entry order, (entry, weight)
    pairs in the sorted order, (run-local entry and low bits, weight) pairs
    between two passes, the first pass's bucket table, the offs table."""
    n = max(n_entries, 1)
    i32 = dict(dtype=torch.int32, device=device)
    return dict(keys=torch.empty(n, **i32),
                wts=torch.empty(n, dtype=torch.float32, device=device),
                dots=torch.empty(n, dtype=torch.float32, device=device),
                pairs=torch.empty(2 * n, **i32), offs=torch.empty(max(plan.offs_size, 1), **i32),
                tmp=torch.empty(2 * n, **i32) if plan.two else None,
                bkt=torch.empty(plan.bkt_size, **i32) if plan.two else None)


def bwd_scratch_bytes(n_entries: int, n_rows: int, plan=None) -> int:
    """Device bytes of the scratch of one K5 or K7 launch: the global sort's
    (`bwd_scratch`) where `plan` is None, else the run-wise route's."""
    if plan is None:
        tiles = -(-n_entries // _bwd_define("BWD_TILE"))
        hist = 256 * tiles
        return 4 * (6 * n_entries + 2 * n_rows + hist + -(-hist // _bwd_define("BWD_SCAN_TILE"))
                    + 1)
    return 4 * ((5 + (2 if plan.two else 0)) * n_entries + plan.offs_size + plan.bkt_size)


def _scratch_ptrs(sc):
    return (sc["keys"][0].data_ptr(), sc["keys"][1].data_ptr(), sc["vals"][0].data_ptr(),
            sc["vals"][1].data_ptr())


def _tap_entries(spatial_shapes, loc, att, frames, S, M, n_rows):
    """Step 1 of K5/K7 on the CPU (or wherever loc lies): (keys (4 * taps,),
    weights, the taps' geometry (dx, dy, live, level widths, level
    heights)). Entries in the kernel's order (m, s, n, q, p, c)
    (`bwd_entries_kernel`); key the value row ((f * S + s) * M + m),
    `n_rows` where the tap is dead or the corner outside its level."""
    N, Q, _, Lx, P, _ = loc.shape
    L = len(spatial_shapes)
    dev = loc.device
    starts = torch.as_tensor(level_start_index(spatial_shapes), device=dev)
    s_idx = torch.arange(Lx, device=dev).view(1, 1, 1, Lx, 1)
    lvl = s_idx % L
    hs = torch.tensor([h for h, _ in spatial_shapes], device=dev)[lvl]
    ws = torch.tensor([w for _, w in spatial_shapes], device=dev)[lvl]
    x = loc[..., 0].float() * ws - 0.5
    y = loc[..., 1].float() * hs - 0.5
    live = (x >= -1) & (x < ws) & (y >= -1) & (y < hs)
    x0f, y0f = torch.floor(torch.where(live, x, 0.0)), torch.floor(torch.where(live, y, 0.0))
    dx, dy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    frame = torch.as_tensor(frames, device=dev)[torch.arange(N, device=dev).view(N, 1, 1, 1, 1),
                                                s_idx // L]
    m = torch.arange(M, device=dev).view(1, 1, M, 1, 1)
    base = frame * S + starts[lvl]
    a = att.float()
    keys, wts = [], []
    for c in range(4):
        yi, xi = y0 + (c >> 1), x0 + (c & 1)
        ok = live & (yi >= 0) & (yi < hs) & (xi >= 0) & (xi < ws)
        keys.append(torch.where(ok, (base + yi * ws + xi) * M + m, n_rows))
        cw = (dy if c >> 1 else 1 - dy) * (dx if c & 1 else 1 - dx)
        wts.append(torch.where(ok, a * cw, 0.0))
    # the kernel's entry order: (m, s, n, q, p, c), a (head, stage)'s together
    perm = (2, 3, 0, 1, 4, 5)
    return (torch.stack(keys, -1).permute(perm).reshape(-1),
            torch.stack(wts, -1).permute(perm).reshape(-1), (dx, dy, live, ws, hs))


def local_keys(keys, spatial_shapes, frames, S: int, M: int, n_rows: int):
    """The run-wise route's keys (`bwd_entries_kernel` with LOCAL): each
    live corner's pixel in its level, RUN_DEAD for the rest, from the global
    keys of `_tap_entries` (entry order (m, s, n, q, p, c))."""
    N, J = frames.shape
    L = len(spatial_shapes)
    starts = torch.as_tensor(level_start_index(spatial_shapes))
    s = torch.arange(J * L).view(1, J * L, 1, 1)
    n = torch.arange(N).view(1, 1, N, 1)
    base = frames.long()[n, s // L] * S + starts[s % L]                 # (1, Lx, N, 1)
    k = keys.view(M, J * L, N, -1)
    return torch.where(k < n_rows, k // M - base, RUN_DEAD).reshape(-1)


def _radix_sort_mirror(keys, n_rows, tile_order=None):
    """Step 2 on the CPU as the kernels run it: per pass the tiles' digit
    histograms, their exclusive scan digit-major, then each tile (in
    `tile_order`, any permutation of the tiles) places its entries at its
    digit's offset plus their rank among its entries of that digit in entry
    order. Returns (sorted keys, entry indices)."""
    n = keys.numel()
    tile = _bwd_define("BWD_TILE")
    tiles = -(-n // tile)
    passes, dbits = bwd_sort_plan(n_rows)
    bins = 1 << dbits
    vals = torch.arange(n)
    order = list(range(tiles)) if tile_order is None else list(tile_order)
    if sorted(order) != list(range(tiles)):
        raise ValueError("tile_order must be a permutation of the tiles")
    for p in range(passes if n else 0):
        digit = (keys >> (p * dbits)) & (bins - 1)
        hist = torch.zeros(bins, tiles, dtype=torch.long)
        hist.index_put_((digit, torch.arange(n) // tile), torch.ones(n, dtype=torch.long),
                        accumulate=True)
        flat = hist.reshape(-1)
        offs = (torch.cumsum(flat, 0) - flat).reshape(bins, tiles)
        k_out, v_out = torch.empty_like(keys), torch.empty_like(vals)
        for t in order:
            d = digit[t * tile:(t + 1) * tile]
            onehot = torch.nn.functional.one_hot(d, bins)
            rank = (torch.cumsum(onehot, 0) - onehot).gather(1, d[:, None])[:, 0]
            at = offs[d, t] + rank
            k_out[at] = keys[t * tile:(t + 1) * tile]
            v_out[at] = vals[t * tile:(t + 1) * tile]
        keys, vals = k_out, v_out
    return keys, vals


def _counting_pass(digits, bins: int, nw: int):
    """One block of the run-wise sort on the CPU (`run_sort_kernel`): the
    segment split into `nw` contiguous parts of whole rounds of 32, each
    part's digit counts, every part's first position of every digit
    (over the parts in order, then over the digits), then each entry at its
    part's position of its digit plus its rank there in entry order. Returns
    (position of each entry in the segment, each digit's first position and
    the total (bins + 1,))."""
    n = digits.numel()
    per = -(-(-(-n // nw)) // 32) * 32
    part = torch.arange(n) // max(per, 1)
    counts = torch.zeros(nw, bins, dtype=torch.long)
    counts.index_put_((part, digits), torch.ones(n, dtype=torch.long), accumulate=True)
    totals = counts.sum(0)
    starts = torch.zeros(bins + 1, dtype=torch.long)
    starts[1:] = torch.cumsum(totals, 0)
    first = starts[:bins][None] + torch.cumsum(counts, 0) - counts      # (parts, bins)
    order = torch.sort(part * bins + digits, stable=True).indices
    key = (part * bins + digits)[order]
    run_start = torch.ones(n, dtype=torch.bool)
    run_start[1:] = key[1:] != key[:-1]
    idx = torch.arange(n)
    rank = idx - torch.cummax(torch.where(run_start, idx, 0), 0).values
    pos = torch.empty(n, dtype=torch.long)
    pos[order] = first[part[order], digits[order]] + rank
    return pos, starts


def _run_sort_mirror(local, plan: RunPlan, run_order=None):
    """Step 2 of the run-wise route on the CPU as the kernels run it: each
    run (in `run_order`, any permutation of the runs) sorted stably on the
    local pixels `local` (entry order, RUN_DEAD where a corner lies outside
    its level), within the run's own range of positions: in one pass, or
    first by bucket pix >> lb, then each bucket within its range by the low
    bits. Returns (the entry at each position, -1 where none is; the offs
    table of absolute positions)."""
    n, E = local.numel(), plan.E
    ids = torch.full((n,), -1, dtype=torch.long)
    offs = torch.zeros(plan.offs_size, dtype=torch.long)
    order = range(plan.runs) if run_order is None else list(run_order)
    if sorted(order) != list(range(plan.runs)):
        raise ValueError("run_order must be a permutation of the runs")
    (_, _, _, nw_first, _), *low = plan.passes()
    for R in order:
        m, j, l, nn = plan.coords(R)
        seg = local[R * E:(R + 1) * E].long()
        live = seg != RUN_DEAD
        ent, pix = torch.arange(R * E, (R + 1) * E)[live], seg[live]
        base, hw, lb = plan.table(m, j, l, nn), plan.hw[l], plan.lb[l]
        if not plan.two:
            pos, starts = _counting_pass(pix, hw, nw_first)
            ids[R * E + pos] = ent
            offs[base:base + hw + 1] = R * E + starts
            continue
        pos, bstarts = _counting_pass(pix >> lb, plan.nb[l], nw_first)
        tmp_e, tmp_p = torch.empty_like(ent), torch.empty_like(pix)
        tmp_e[pos], tmp_p[pos] = ent, pix
        for d in range(plan.nb[l]):
            b0, b1 = int(bstarts[d]), int(bstarts[d + 1])
            bins = min(1 << lb, hw - (d << lb))
            pos2, starts = _counting_pass(tmp_p[b0:b1] & ((1 << lb) - 1), bins, low[0][3])
            ids[R * E + b0 + pos2] = tmp_e[b0:b1]
            offs[base + (d << lb):base + (d << lb) + bins] = R * E + b0 + starts[:bins]
        offs[base + hw] = R * E + int(bstarts[-1])
    return ids, offs


def _run_rows_mirror(ids, offs, plan: RunPlan, feeds, spatial_shapes, S: int, n_rows: int):
    """Step 3's walk of the run-wise route on the CPU: each value row
    (f, sp, m) takes its frame's runs (`feeds`, `run_feeds`) in run order and
    each run's segment at its pixel. Returns what `_radix_sort_mirror`
    returns for the gather: (the row of each position, the entry at each
    position), the rows' lists laid end to end in row order, then the dead
    corners (key n_rows)."""
    ptr, feed = (t.long() for t in feeds)
    M, N, J = plan.M, plan.N, plan.J
    r = torch.arange(n_rows)
    m, sp, f = r % M, r // M % S, r // (M * S)
    starts = torch.as_tensor(level_start_index(spatial_shapes))
    lvl = torch.bucketize(sp, starts, right=True) - 1
    pix = sp - starts[lvl]
    hw = torch.as_tensor(plan.hw)
    zoff = torch.as_tensor(plan.zoff)
    nf = ptr[f + 1] - ptr[f]
    pieces = []                                   # (row, feed index, position in the run's range)
    for k in range(int(nf.max()) if n_rows else 0):
        on = k < nf
        item = feed[torch.where(on, ptr[f] + k, 0)]
        j, nn = item // N, item % N
        ob = ((m * J + j) * plan.Z + zoff[lvl]) * N + nn * (hw[lvl] + 1) + pix
        b, e = offs[ob], offs[ob + 1]
        length = torch.where(on, e - b, 0)
        rows = torch.repeat_interleave(r, length)
        within = torch.arange(int(length.sum())) - torch.repeat_interleave(
            torch.cumsum(length, 0) - length, length)
        pieces.append((rows, torch.full_like(rows, k),
                       torch.repeat_interleave(b, length) + within))
    none = torch.zeros(0, dtype=torch.long)
    rows, ks, at = (torch.cat(x) for x in zip(*pieces)) if pieces else (none, none, none)
    order = torch.sort(rows * (int(nf.max()) + 1) + ks, stable=True).indices
    entries = ids[at[order]]
    dead = torch.ones(ids.numel(), dtype=torch.bool)
    dead[entries] = False
    keys = torch.cat([rows[order], torch.full((int(dead.sum()),), n_rows, dtype=torch.long)])
    return keys, torch.cat([entries, torch.nonzero(dead)[:, 0]])


def run_walk_mirror(ids, offs, plan: RunPlan, feeds, spatial_shapes, S: int, row: int,
                    gpr: int):
    """The entries each of a value row's `gpr` lane groups takes in the
    run-wise gather, in order: per segment of its frame's runs, group g
    from (g - entries before) mod gpr in steps of gpr (`run_gather_kernel`)."""
    ptr, feed = (t.long() for t in feeds)
    M, N, L = plan.M, plan.N, len(plan.hw)
    m, sp, f = row % M, row // M % S, row // (M * S)
    starts = level_start_index(spatial_shapes)
    lvl = max(i for i in range(L) if starts[i] <= sp)
    pix = sp - starts[lvl]
    groups, before = [[] for _ in range(gpr)], 0
    for k in range(int(ptr[f]), int(ptr[f + 1])):
        j, nn = int(feed[k]) // N, int(feed[k]) % N
        ob = plan.table(m, j, lvl, nn) + pix
        b, length = int(offs[ob]), int(offs[ob + 1] - offs[ob])
        for g in range(gpr):
            groups[g] += ids[list(range(b + (g - before) % gpr, b + length, gpr))].tolist()
        before += length
    return groups


def _gather_mirror(value_rows, g_rows, wts, keys, order, n_rows, plan, row_order=None,
                   chunk=4096):
    """Steps 3-4 on the CPU: each value row's segment of the sorted entries,
    entry j of a segment to group j % gpr (`bwd_groups`), each group's
    w * g summed in entry order, the groups added by the kernel's butterfly;
    each entry's dot summed over its lanes' chunks, then over the lanes by
    `group_sum`'s butterfly. `g_rows` (n, D) is the output-gradient row of
    every entry. `row_order` runs the rows in another order (`chunk` rows at
    a time). Returns (grad_value (n_rows, D) f32, dots (n,) f32, zero where
    the key is n_rows)."""
    D = value_rows.shape[1]
    groups = bwd_groups(plan, keys.numel(), n_rows)
    live_keys = keys < n_rows
    begin = torch.zeros(n_rows, dtype=torch.long)
    end = torch.zeros(n_rows, dtype=torch.long)
    kl = keys[live_keys]
    if kl.numel():
        pos = torch.arange(keys.numel())[live_keys]
        first = torch.ones_like(kl, dtype=torch.bool)
        first[1:] = kl[1:] != kl[:-1]
        last = torch.ones_like(kl, dtype=torch.bool)
        last[:-1] = kl[1:] != kl[:-1]
        begin[kl[first]] = pos[first]
        end[kl[last]] = pos[last] + 1
    rows = torch.arange(n_rows) if row_order is None else torch.as_tensor(row_order)
    rows = rows[end[rows] > begin[rows]]                 # the others stay zero
    grad = torch.zeros(n_rows, D, dtype=torch.float32)
    dots = torch.zeros(keys.numel(), dtype=torch.float32)
    lane_chans = [[c for k in range(plan.per)
                   for c in range((sub + k * plan.lanes) * plan.cw,
                                  min((sub + k * plan.lanes + 1) * plan.cw, D))]
                  for sub in range(plan.lanes)]
    j = torch.arange(groups)
    for r0 in range(0, rows.numel(), chunk):
        rs = rows[r0:r0 + chunk]
        b, e = begin[rs], end[rs]
        v = value_rows[rs].float()[:, None, :]
        acc = torch.zeros(rs.numel(), groups, D, dtype=torch.float32)
        for k in range(int(((e - b + groups - 1) // groups).max())):
            i = b[:, None] + j + k * groups                         # (rows, groups)
            live = i < e[:, None]
            ids = order[torch.where(live, i, 0)]
            w = torch.where(live, wts[ids], 0.0)
            gr = torch.where(live[..., None], g_rows[ids].float(), 0.0)
            acc = acc + w[..., None] * gr
            parts = [torch.zeros(ids.shape, dtype=torch.float32) for _ in range(plan.lanes)]
            for sub, chans in enumerate(lane_chans):
                for c in chans:
                    parts[sub] = parts[sub] + gr[..., c] * v[..., c]
            o = plan.lanes >> 1                   # group_sum: the widest step first
            while o:
                parts = [parts[t] + parts[t ^ o] for t in range(plan.lanes)]
                o >>= 1
            dots[ids[live]] = parts[0][live]
        o = 1
        while o < groups:
            acc = acc + acc[:, j ^ o]
            o <<= 1
        grad[rs] = acc[:, 0]
    return grad, dots


def msda_bwd_mirror(value, spatial_shapes, loc, att, grad_out, frames=None, plan=None,
                    tile_order=None, row_order=None, sort="global", run_order=None):
    """K5 and K7 on the CPU in the kernels' order (csrc/msda_bwd.cuh): the
    corners' entries, the stable sort by value row (`sort` "global": the
    radix sort, tiles in `tile_order`; an int: the run-wise route with
    buckets of about that many entries (0: RUN_BUCKET), runs in `run_order`;
    both give the same order), one warp's sums a row (rows in `row_order`) and the taps'
    gradients from their dots. value (F, S, M, D); loc (N, Q, M, Lx, P, 2);
    frames (N, Lx / L) the value frame of each frame slot (default: frame n
    for the queries of frame n, one slot: K7). Returns (grad_value in the
    value's dtype, grad_loc f32, grad_att f32), f32 arithmetic."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    F, S, M, D = value.shape
    N, Q, _, Lx, P, _ = loc.shape
    if frames is None:
        frames = torch.arange(N)[:, None]
    plan = plan or taps_plan(D, value.dtype, True)
    n_rows = F * S * M
    frames = torch.as_tensor(frames)
    keys, wts, (dx, dy, live, ws, hs) = _tap_entries(
        spatial_shapes, loc, att, frames, S, M, n_rows)
    if sort == "global":
        skeys, order = _radix_sort_mirror(keys, n_rows, tile_order)
    else:
        rp = run_plan(spatial_shapes, Q, P, N, Lx // len(spatial_shapes), M, sort)
        ids, offs = _run_sort_mirror(local_keys(keys, spatial_shapes, frames, S, M, n_rows),
                                     rp, run_order)
        skeys, order = _run_rows_mirror(ids, offs, rp, run_feeds(frames, F), spatial_shapes, S,
                                        n_rows)
    g_idx = ((torch.arange(N * Q).view(1, 1, N * Q, 1, 1) * M
              + torch.arange(M).view(M, 1, 1, 1, 1)).expand(M, Lx, N * Q, P, 4).reshape(-1))
    g_rows = grad_out.float().reshape(N * Q * M, D)[g_idx]
    grad, dots = _gather_mirror(value.float().reshape(n_rows, D), g_rows, wts, skeys, order,
                                n_rows, plan, row_order)
    dots = dots.reshape(M, Lx, N, Q, P, 4).permute(2, 3, 0, 1, 4, 5)
    tx = torch.zeros(att.shape)
    ty, tz = torch.zeros(att.shape), torch.zeros(att.shape)
    for c in range(4):
        gv = dots[..., c]
        wy = dy if c >> 1 else 1 - dy
        wx = dx if c & 1 else 1 - dx
        tx = tx + wy * wx * gv
        ty = ty + (wy if c & 1 else -wy) * gv
        tz = tz + (wx if c >> 1 else -wx) * gv
    a = att.float()
    g_att = torch.where(live, tx, 0.0)
    g_loc = torch.stack([torch.where(live, a * ty * ws, 0.0),
                         torch.where(live, a * tz * hs, 0.0)], -1)
    return grad.reshape(value.shape).to(value.dtype), g_loc, g_att


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _check_cuda(name, device, tensors, dtype):
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def _check_geometry(name, spatial_shapes, D, W, rule=("all",), stages=False):
    """Limits of the temporal kernels, as their C launchers hold them: at
    most `_MAX_LEVELS` levels and one lane per channel (D <= 32); a window
    rule of at most `_MAX_WINDOW` offsets, the `all` rule (which reads no
    offsets) at any W; with `stages` (K1, and K2 which makes K1's windows)
    at most `K1_MAX_STAGES` stages (1 + W) * L, K1's header."""
    L = len(spatial_shapes)
    if L > _MAX_LEVELS:
        raise ValueError(f"{name}: at most {_MAX_LEVELS} levels")
    if D > 32:
        raise ValueError(f"{name}: head dim {D} > 32 is not supported")
    if rule[0] != "all" and W > _MAX_WINDOW:
        raise ValueError(f"{name}: a window rule takes at most {_MAX_WINDOW} offsets, "
                         f"got {W}")
    if stages and (1 + W) * L > K1_MAX_STAGES:
        raise ValueError(f"{name}: (1 + W) * L = {(1 + W) * L} stages, at most "
                         f"{K1_MAX_STAGES}")


def _rule_args(rule):
    offsets = () if rule[0] == "all" else rule[1]
    return int(rule[0] == "all"), _build.int_array(offsets)


_SINGLE_FRAME = {"msda_rows": "ms_deform_attn_rows",
                 "msda_proj": "ms_deform_attn_proj",
                 "msda_taps_bwd": "ms_deform_attn_taps"}


def _function(name: str, n_ptrs: int, n_ints: int):
    """A typed C entry: `n_ptrs` device pointers, `n_ints` ints, then K1's
    capacities and mode (K1 only), the level table and L, then W (tap
    windows) or the rule (flag, offsets, W) (temporal attention) or nothing
    (single-frame attention), then the stream."""
    source = next((lib for prefix, lib in _SINGLE_FRAME.items()
                   if name.startswith(prefix)), None)
    rows = source is not None
    fn = getattr(_build.library(source or "ms_deform_attn"), name)
    if fn.argtypes is None:
        P, I, A = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        tail = [A, I] if rows else [A, I, I] if name.startswith("msda_tap_window") \
            else [A, I, I, A, I]
        if name.startswith("msda_temporal_proj"):
            tail = [A, I] + tail
        fn.argtypes = [P] * n_ptrs + [I] * n_ints + tail + [P]
        fn.restype = ctypes.c_int
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _levels(spatial_shapes):
    return _build.int_array([v for hw in spatial_shapes for v in hw])


def launch_k1(value, spatial_shapes, ref, c_off, t_off, c_logit, t_logit, rule,
              windows, plan, mode: str = "full"):
    """One launch of the windowed K1 in `mode` (`K1_MODES`) on K2's
    `windows`, staging `plan[l]` rows a level. Counts nothing: the op and the
    kernel lab count their own launches. Returns (out, reads), reads the
    `count` mode's two counters of corners read from global memory (in
    windows that fit their capacity, and in those that do not), else None."""
    T, S, M, D = value.shape
    _, Q, L, _ = ref.shape
    P = c_logit.shape[-1] // (M * L)
    W = rule_window(rule, T)
    _check_geometry("msda_temporal_proj", spatial_shapes, D, W, rule, stages=True)
    _check_cuda("msda_temporal_proj", value.device,
                (value, c_off, t_off, c_logit, t_logit), value.dtype)
    _check_cuda("msda_temporal_proj", value.device, (ref,), torch.float32)
    _check_cuda("msda_temporal_proj", value.device, (windows,), torch.int32)
    if value.dtype not in _DTYPES:
        raise ValueError(f"msda_temporal_proj: unsupported dtype {value.dtype}")
    if (S != sum(h * w for h, w in spatial_shapes)
            or tuple(c_off.shape) != (T, Q, M * L * P * 2)
            or tuple(t_off.shape) != (T, Q, M * W * L * P * 2)
            or tuple(c_logit.shape) != (T, Q, M * L * P)
            or tuple(t_logit.shape) != (T, Q, M * W * L * P)
            or tuple(windows.shape) != (T, M, -(-Q // Q_BLOCK), (1 + W) * L, 2)
            or len(plan) != L):
        raise ValueError("msda_temporal_proj: inconsistent shapes")
    smem = k1_smem_bytes(plan, L, W, value.dtype, D, P)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"msda_temporal_proj: plan {tuple(plan)} needs {smem} bytes of "
                         f"shared memory, more than {SMEM_PER_BLOCK}")
    out = torch.empty((T, Q, M * D), dtype=value.dtype, device=value.device)
    reads = torch.zeros(2, dtype=torch.int32, device=value.device) \
        if mode == "count" else None
    fn = _function(f"msda_temporal_proj_{_DTYPES[value.dtype]}", 9, 6)
    rule_all, offsets = _rule_args(rule)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), ref.data_ptr(), c_off.data_ptr(),
                        t_off.data_ptr(), c_logit.data_ptr(), t_logit.data_ptr(),
                        windows.data_ptr(), out.data_ptr(),
                        None if reads is None else reads.data_ptr(), T, Q, S, M, D, P,
                        _build.int_array(plan), K1_MODES.index(mode),
                        _levels(spatial_shapes), L, rule_all, offsets, W, _stream(value)),
                     "msda_temporal_proj")
    return out, reads


def _launch_temporal_proj(value, spatial_shapes, ref, c_off, t_off, c_logit,
                          t_logit, rule):
    """K2, then K1 on its windows with the default `window_plan`."""
    M, D = value.shape[2:]
    P = c_logit.shape[-1] // (M * len(spatial_shapes))
    windows = msda_tap_window(spatial_shapes, ref, c_off, t_off, M)
    out, _ = launch_k1(value, spatial_shapes, ref, c_off, t_off, c_logit, t_logit,
                       rule, windows, window_plan(spatial_shapes, value.dtype, D, P))
    msda_temporal_proj.launches += 1
    return out


class MSDATemporalProjFunction(torch.autograd.Function):
    """K2 and K1 forward. The backward splits as the JAX package's VJP does:
    loc and att are rebuilt from the raw projections under autograd, K5 gives
    their gradients and the value's, and autograd chains them to the
    references, offsets and logits."""

    @staticmethod
    def forward(ctx, value, ref, c_off, t_off, c_logit, t_logit, spatial_shapes,
                rule):
        ctx.spatial_shapes, ctx.rule = spatial_shapes, rule
        ctx.save_for_backward(value, ref, c_off, t_off, c_logit, t_logit)
        return _launch_temporal_proj(value, spatial_shapes, ref, c_off, t_off,
                                     c_logit, t_logit, rule)

    @staticmethod
    def backward(ctx, grad_out):
        value, *proj = ctx.saved_tensors
        M = value.shape[2]
        needs = ctx.needs_input_grad[1:6]
        with torch.enable_grad():
            ref, c_off, t_off, c_logit, t_logit = (
                t.detach().requires_grad_(n) for t, n in zip(proj, needs))
            loc = temporal_proj_locations(ctx.spatial_shapes, ref, c_off, t_off, M)
            att = temporal_proj_weights(c_logit, t_logit, M, len(ctx.spatial_shapes))
        g_value, g_loc, g_att = msda_temporal_bwd(
            value, ctx.spatial_shapes, loc.detach().contiguous(),
            att.detach().contiguous(), grad_out.contiguous(), ctx.rule)
        leaves = [t for t in (ref, c_off, t_off, c_logit, t_logit) if t.requires_grad]
        grads = iter(torch.autograd.grad([loc, att], leaves, [g_loc, g_att],
                                         allow_unused=True) if leaves else ())
        g_proj = [next(grads) if n else None for n in needs]
        return (g_value if ctx.needs_input_grad[0] else None, *g_proj, None, None)


def msda_temporal_proj(value, spatial_shapes, ref, c_off, t_off, c_logit,
                       t_logit, rule=("all",)):
    """K1 (see module docstring). Returns (T, Q, M*D) in the value's dtype."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K1_temporal_proj"):
        if not value.is_cuda:
            msda_temporal_proj.plain_calls += 1
            return msda_temporal_proj_plain(value, spatial_shapes, ref, c_off,
                                            t_off, c_logit, t_logit, rule)
        return MSDATemporalProjFunction.apply(value, ref, c_off, t_off, c_logit,
                                              t_logit, spatial_shapes, rule)


msda_temporal_proj.launches = 0
msda_temporal_proj.plain_calls = 0


def msda_tap_window(spatial_shapes, ref, c_off, t_off, n_heads: int):
    """K2 (see module docstring) → (T, M, n_qblocks, Lf, 2) int32."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K2_tap_window"):
        if not ref.is_cuda:
            msda_tap_window.plain_calls += 1
            return msda_tap_window_plain(spatial_shapes, ref, c_off, t_off, n_heads)
        T, Q, L, _ = ref.shape
        M = n_heads
        P = c_off.shape[-1] // (M * L * 2)
        W = t_off.shape[-1] // (M * L * P * 2)
        _check_geometry("msda_tap_window", spatial_shapes, 0, W, stages=True)
        _check_cuda("msda_tap_window", ref.device, (ref,), torch.float32)
        _check_cuda("msda_tap_window", ref.device, (c_off, t_off), c_off.dtype)
        if c_off.dtype not in _DTYPES:
            raise ValueError(f"msda_tap_window: unsupported dtype {c_off.dtype}")
        if (tuple(c_off.shape) != (T, Q, M * L * P * 2)
                or tuple(t_off.shape) != (T, Q, M * W * L * P * 2)):
            raise ValueError("msda_tap_window: inconsistent shapes")
        aligned = c_off.data_ptr() % 16 == 0 and (W == 0 or t_off.data_ptr() % 16 == 0)
        plan = tap_window_plan(M, W, L, P, c_off.dtype, aligned)
        nqb = -(-Q // Q_BLOCK)
        out = torch.empty((T, M, nqb, (1 + W) * L, 2), dtype=torch.int32,
                          device=ref.device)
        fn = _function(f"msda_tap_window_{_DTYPES[c_off.dtype]}", 4, 8)
        with torch.cuda.device(ref.device):
            _build.check(fn(ref.data_ptr(), c_off.data_ptr(), t_off.data_ptr(),
                            out.data_ptr(), T, Q, M, P, Q_BLOCK, *plan,
                            _levels(spatial_shapes), L, W, _stream(ref)),
                         "msda_tap_window")
        msda_tap_window.launches += 1
        return out


msda_tap_window.launches = 0
msda_tap_window.plain_calls = 0


def _check_rows(name, value, spatial_shapes, loc, att, n_levels, groups=1):
    """Shapes and types shared by K3, K5, K6 and K7; loc and att with
    `groups` heads a value head."""
    B, S, M, D = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    _check_cuda(name, value.device, (value,), value.dtype)
    _check_cuda(name, value.device, (loc, att), torch.float32)
    if value.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {value.dtype}")
    if (S != sum(h * w for h, w in spatial_shapes)
            or tuple(loc.shape) != (B, Q, M * groups, n_levels, P, 2)
            or tuple(att.shape) != (B, Q, M * groups, n_levels, P)):
        raise ValueError(f"{name}: inconsistent shapes")
    return B, Q, S, M, D, P


def _launch_temporal(value, spatial_shapes, loc, att, rule):
    L = len(spatial_shapes)
    W = rule_window(rule, value.shape[0])
    _check_geometry("msda_temporal", spatial_shapes, value.shape[3], W, rule)
    T, Q, S, M, D, P = _check_rows("msda_temporal", value, spatial_shapes, loc,
                                   att, (1 + W) * L)
    out = torch.empty((T, Q, M * D), dtype=value.dtype, device=value.device)
    fn = _function(f"msda_temporal_{_DTYPES[value.dtype]}", 4, 6)
    rule_all, offsets = _rule_args(rule)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                        out.data_ptr(), T, Q, S, M, D, P, _levels(spatial_shapes),
                        L, rule_all, offsets, W, _stream(value)), "msda_temporal")
    msda_temporal.launches += 1
    return out


class MSDATemporalFunction(torch.autograd.Function):
    """K3 forward, K5 backward."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes, rule):
        ctx.spatial_shapes, ctx.rule = spatial_shapes, rule
        ctx.save_for_backward(value, loc, att)
        return _launch_temporal(value, spatial_shapes, loc, att, rule)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        grads = msda_temporal_bwd(value, ctx.spatial_shapes, loc, att,
                                  grad_out.contiguous(), ctx.rule)
        return (*(g if n else None for g, n in zip(grads, ctx.needs_input_grad)),
                None, None)


def msda_temporal(value, spatial_shapes, loc, att, rule=("all",)):
    """K3 (see module docstring). Returns (T, Q, M*D) in the value's dtype."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K3_temporal"):
        if not value.is_cuda:
            msda_temporal.plain_calls += 1
            return ms_deform_attn_temporal_plain(value, spatial_shapes, loc, att,
                                                 rule)
        return MSDATemporalFunction.apply(value, loc, att, spatial_shapes, rule)


msda_temporal.launches = 0
msda_temporal.plain_calls = 0


def _aligned16(t):
    """`t`, or a copy of it on 16 bytes where it lies off them."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(name, value, spatial_shapes, loc, att, grad_out, dims, frames, tail=(),
                sort=None):
    """One K5 or K7 launch (csrc/msda_bwd.cuh `bwd_run`) into new buffers:
    (grad_value in the value's dtype, grad_loc f32, grad_att f32). `frames`
    (N, J): the value frame of each frame slot (None: K7, frame n alone).
    `sort`: the route (`bwd_route` where None; -1 the global sort; else the
    run-wise one with buckets of about that many entries, 0 for RUN_BUCKET)."""
    value, grad_out = _aligned16(value), _aligned16(grad_out)
    if loc.data_ptr() % 8:          # the kernels read a tap's (x, y) as one float2
        loc = loc.clone()
    F, S, M, D = value.shape
    N, Q, _, Lx, P = att.shape
    J = Lx // len(spatial_shapes)
    n = 4 * att.numel()
    bucket = bwd_route(spatial_shapes, Q, P, N, J, M) if sort is None else sort
    plan = taps_plan(D, value.dtype, True)
    gpr = bwd_groups(plan, n, F * S * M)
    ptrs = lambda *ts: [None if t is None else t.data_ptr() for t in ts]  # noqa: E731
    feeds = ()
    if bucket < 0:
        sc = bwd_scratch(n, F * S * M, value.device)
        scratch = ptrs(*sc["keys"], *sc["vals"], sc["wts"], sc["dots"], sc["begin"], sc["end"],
                       sc["hist"], sc["sums"], sc["top"]) + [None] * 5
    else:
        rp = run_plan(spatial_shapes, Q, P, N, J, M, bucket)
        sc = run_scratch(n, rp, value.device)
        ptr = feed = None
        if frames is not None:
            ptr, feed, most = _device_feeds(tuple(map(tuple, frames.tolist())), F, value.device)
            feeds = (most,)
        scratch = ptrs(sc["keys"], None, None, None, sc["wts"], sc["dots"], None, None, sc["bkt"],
                       None, None, sc["pairs"], sc["tmp"], sc["offs"], ptr, feed)
    if frames is not None and not feeds:
        feeds = (0,)
    g_value = torch.empty_like(value)
    g_loc, g_att = torch.empty_like(loc), torch.empty_like(att)
    fn = _function(f"{name}_{_DTYPES[value.dtype]}", 23, 11 + len(feeds))
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(), grad_out.data_ptr(),
                        g_value.data_ptr(), g_loc.data_ptr(), g_att.data_ptr(), *scratch,
                        *dims, plan.lanes, plan.per, int(plan.vec), gpr, bucket, *feeds,
                        _levels(spatial_shapes), len(spatial_shapes), *tail, _stream(value)),
                     name)
    return g_value, g_loc, g_att


def launch_temporal_bwd(value, spatial_shapes, loc, att, grad_out, rule=("all",), sort=None):
    """One K5 launch: (grad_value in the value's dtype, grad_loc f32,
    grad_att f32). Counts no launch. `sort` as `_launch_bwd`'s."""
    L = len(spatial_shapes)
    W = rule_window(rule, value.shape[0])
    _check_geometry("msda_temporal_bwd", spatial_shapes, value.shape[3], W, rule)
    T, Q, S, M, D, P = _check_rows("msda_temporal_bwd", value, spatial_shapes,
                                   loc, att, (1 + W) * L)
    _check_cuda("msda_temporal_bwd", value.device, (grad_out,), value.dtype)
    if tuple(grad_out.shape) != (T, Q, M * D):
        raise ValueError("msda_temporal_bwd: inconsistent shapes")
    rule_all, offsets = _rule_args(rule)
    frames = torch.cat([torch.arange(T)[:, None],
                        torch.as_tensor(temporal_frame_table(rule, T), dtype=torch.long)], 1)
    return _launch_bwd("msda_temporal_bwd", value, spatial_shapes, loc, att, grad_out,
                       (T, Q, S, M, D, P), frames, (rule_all, offsets, W), sort)


def msda_temporal_bwd(value, spatial_shapes, loc, att, grad_out, rule=("all",)):
    """K5 (see module docstring). Returns (grad_value in the value's dtype,
    grad_loc f32, grad_att f32)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K5_temporal_bwd"):
        if not value.is_cuda:
            msda_temporal_bwd.plain_calls += 1
            return msda_temporal_bwd_plain(value, spatial_shapes, loc, att, grad_out,
                                           rule)
        out = launch_temporal_bwd(value, spatial_shapes, loc, att, grad_out, rule)
        msda_temporal_bwd.launches += 1
        return out


msda_temporal_bwd.launches = 0
msda_temporal_bwd.plain_calls = 0


# K6's launch (csrc/ms_deform_attn_rows.cu, `msda_rows_kernel`): raster
# runs of units a block, a unit one (b, q, m) and one slice of its channels;
# the tap geometry of the block's units in shared memory, then `groups` tap
# groups of `lanes` threads a unit, each thread one chunk of channels
RowsPlan = collections.namedtuple("RowsPlan",
                                  "vec lanes groups slices chunks units threads smem")


@functools.lru_cache(maxsize=None)
def rows_plan(head_dim: int, dtype, aligned: bool, n_heads: int, n_levels: int,
              n_points: int, n_queries: int) -> RowsPlan:
    """The split of a K6 launch over `n_queries` = B * Q queries of
    `n_heads` heads, from the kernel's constants (`K6_*`). `vec`: chunks of
    16 bytes where the value is `aligned` to 16 bytes and D fills whole
    chunks, else of one channel. Channels in `slices` of `chunks` chunks
    (one slice up to `K6_MAX_CHUNKS`). `groups` tap groups of `lanes`
    threads a unit: one group of a thread a chunk (any count) where the
    launch fills the card (`K6_FILL_THREADS`), else the taps spread over up
    to 32 / lanes groups of a power of two of lanes (a unit in one warp).
    `units` a block: the count in 256 or 512 threads that leaves the fewest
    idle, as far as the units' tap geometry (`smem` bytes) fits `K6_SMEM`
    (none where a unit is one thread: it computes its taps itself);
    `threads` a block. Raises where one unit's taps do not fit."""
    k6 = functools.partial(_build.source_define, "ms_deform_attn_rows")
    vn = 16 // (torch.finfo(dtype).bits // 8)
    vec = bool(aligned) and head_dim % vn == 0
    taps = n_levels * n_points
    n_chunks = -(-head_dim // (vn if vec else 1))
    slices = -(-n_chunks // k6("K6_MAX_CHUNKS"))
    chunks = -(-n_chunks // slices)
    lanes, groups = chunks, 1
    if chunks <= 16:
        pow2 = 1 << (chunks - 1).bit_length()
        while (2 * groups * pow2 <= 32 and 2 * groups <= taps
               and n_queries * n_heads * slices * groups * pow2 < k6("K6_FILL_THREADS")):
            groups *= 2
        lanes = pow2 if groups > 1 else chunks
    per_unit = groups * lanes
    most = k6("K6_MAX_THREADS") if per_unit == 1 else k6("K6_SMEM") // (16 * taps)
    if most < 1:
        raise ValueError(f"rows_plan: {taps} taps a query leave no shared memory for one "
                         f"unit ({k6('K6_SMEM')} bytes)")
    best = None
    for size in (256, k6("K6_MAX_THREADS")):
        units = min(max(1, size // per_unit), most)
        threads = -(-units * per_unit // 32) * 32
        idle = (threads - units * per_unit) / threads
        if best is None or idle < best[0]:
            best = (idle, units, threads)
    _, units, threads = best
    return RowsPlan(vec, lanes, groups, slices, chunks, units, threads,
                    0 if per_unit == 1 else units * taps * 16)


def _launch_rows(value, spatial_shapes, loc, att):
    """One K6 launch; loc and att may carry G = MG / M heads a value head
    (head mg reads value head mg // G, the JAX grid's `bm // groups`).
    Returns (B, Q, MG * D)."""
    L = len(spatial_shapes)
    if L > _MAX_LEVELS:
        raise ValueError(f"msda_rows: at most {_MAX_LEVELS} levels")
    MG, M = loc.shape[2], value.shape[2]
    if MG % M:
        raise ValueError(f"msda_rows: {MG} query heads for {M} value heads")
    G = MG // M
    B, Q, S, M, D, P = _check_rows("msda_rows", value, spatial_shapes, loc, att, L, G)
    if loc.data_ptr() % 8:          # the kernel reads a tap's (x, y) as one float2
        loc = loc.clone()
    plan = rows_plan(D, value.dtype, value.data_ptr() % 16 == 0, MG, L, P, B * Q)
    out = torch.empty((B, Q, MG * D), dtype=value.dtype, device=value.device)
    fn = _function(f"msda_rows_{_DTYPES[value.dtype]}", 4, 14)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                        out.data_ptr(), B, Q, S, M, G, D, P, int(plan.vec), plan.lanes,
                        plan.groups, plan.slices, plan.chunks, plan.units, plan.threads,
                        _levels(spatial_shapes), L, _stream(value)), "msda_rows")
    msda_rows.launches += 1
    return out


class MSDARowsFunction(torch.autograd.Function):
    """K6 forward, K7 backward."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, att)
        return _launch_rows(value, spatial_shapes, loc, att)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        grads = msda_rows_bwd(value, ctx.spatial_shapes, loc, att, grad_out.contiguous())
        return (*(g if n else None for g, n in zip(grads, ctx.needs_input_grad)), None)


def msda_rows(value, spatial_shapes, loc, att):
    """K6 (see module docstring). Returns (B, Q, M*D) in the value's dtype."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K6_rows"):
        if not value.is_cuda:
            msda_rows.plain_calls += 1
            return ms_deform_attn(value, spatial_shapes, loc, att)
        return MSDARowsFunction.apply(value, loc, att, spatial_shapes)


msda_rows.launches = 0
msda_rows.plain_calls = 0


def launch_rows_bwd(value, spatial_shapes, loc, att, grad_out, sort=None):
    """One K7 launch; counts no launch. `sort` as `_launch_bwd`'s."""
    if len(spatial_shapes) > _MAX_LEVELS:
        raise ValueError(f"msda_rows_bwd: at most {_MAX_LEVELS} levels")
    B, Q, S, M, D, P = _check_rows("msda_rows_bwd", value, spatial_shapes, loc,
                                   att, len(spatial_shapes))
    _check_cuda("msda_rows_bwd", value.device, (grad_out,), value.dtype)
    if tuple(grad_out.shape) != (B, Q, M * D):
        raise ValueError("msda_rows_bwd: inconsistent shapes")
    return _launch_bwd("msda_rows_bwd", value, spatial_shapes, loc, att, grad_out,
                       (B, Q, S, M, D, P), None, sort=sort)


def msda_rows_bwd(value, spatial_shapes, loc, att, grad_out):
    """K7 (see module docstring). Returns (grad_value in the value's dtype,
    grad_loc f32, grad_att f32)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K7_rows_bwd"):
        if not value.is_cuda:
            msda_rows_bwd.plain_calls += 1
            return msda_rows_bwd_plain(value, spatial_shapes, loc, att, grad_out)
        out = launch_rows_bwd(value, spatial_shapes, loc, att, grad_out)
        msda_rows_bwd.launches += 1
        return out


msda_rows_bwd.launches = 0
msda_rows_bwd.plain_calls = 0


# ---------------------------------------------------------------------------
# K8: single-frame attention from raw projections
# ---------------------------------------------------------------------------

def proj_locations(spatial_shapes, ref, off, n_heads: int):
    """(B, Q, M, L, P, 2) f32 locations from references (B, Q, L, 2) and raw
    offsets (B, Q, M*L*P*2), with the same f32 operations as K8."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    B, Q, L, _ = ref.shape
    o = off.float().reshape(B, Q, n_heads, L, -1, 2)
    inv_w, inv_h = _inv(spatial_shapes, ref.device)
    ref = ref.float()
    lx = ref[:, :, None, :, None, 0] + o[..., 0] * inv_w[:, None]
    ly = ref[:, :, None, :, None, 1] + o[..., 1] * inv_h[:, None]
    return torch.stack([lx, ly], -1)


def proj_weights(logit, n_heads: int, n_levels: int):
    """(B, Q, M, L, P) f32 softmax per head over the L*P logits."""
    B, Q, _ = logit.shape
    att = torch.softmax(logit.float().reshape(B, Q, n_heads, -1), dim=-1)
    return att.reshape(B, Q, n_heads, n_levels, -1)


def msda_proj_plain(value, spatial_shapes, ref, off, logit):
    """Plain K8: the rows are built in PyTorch, then sampled."""
    M = value.shape[2]
    loc = proj_locations(spatial_shapes, ref, off, M)
    att = proj_weights(logit, M, len(spatial_shapes))
    return ms_deform_attn(value, spatial_shapes, loc, att)


# K8's launch (csrc/ms_deform_attn_proj.cu, `msda_proj_kernel`): one warp
# per (b, q, m), 32 / lanes taps at a time, each thread 16 bytes of channels
ProjPlan = collections.namedtuple("ProjPlan", "vec lanes")


@functools.lru_cache(maxsize=None)
def proj_plan(head_dim: int, dtype, aligned: bool) -> ProjPlan:
    """(vec, lanes) of a K8 launch: `vec`, chunks of 16 bytes where the
    value is `aligned` to 16 bytes and D fills whole chunks, else of one
    channel; `lanes` a tap, the least power of two whose chunks hold
    `head_dim` channels (4 in bf16 and 8 in f32 at D 32 with 16 bytes)."""
    vn = 16 // (torch.finfo(dtype).bits // 8)
    vec = bool(aligned) and head_dim % vn == 0
    lanes = 1
    while lanes * (vn if vec else 1) < head_dim:
        lanes *= 2
    if lanes > 32:
        raise ValueError(f"proj_plan: head dim {head_dim} does not fit one warp")
    return ProjPlan(vec, lanes)


def _launch_proj(value, spatial_shapes, ref, off, logit):
    B, S, M, D = value.shape
    _, Q, L, _ = ref.shape
    P = logit.shape[-1] // (M * L)
    _check_geometry("msda_proj", spatial_shapes, D, 0)
    _check_cuda("msda_proj", value.device, (value, off, logit), value.dtype)
    _check_cuda("msda_proj", value.device, (ref,), torch.float32)
    if value.dtype not in _DTYPES:
        raise ValueError(f"msda_proj: unsupported dtype {value.dtype}")
    if (S != sum(h * w for h, w in spatial_shapes) or L != len(spatial_shapes)
            or tuple(ref.shape) != (B, Q, L, 2)
            or tuple(off.shape) != (B, Q, M * L * P * 2)
            or tuple(logit.shape) != (B, Q, M * L * P)):
        raise ValueError("msda_proj: inconsistent shapes")
    plan = proj_plan(D, value.dtype, value.data_ptr() % 16 == 0)
    out = torch.empty((B, Q, M * D), dtype=value.dtype, device=value.device)
    fn = _function(f"msda_proj_{_DTYPES[value.dtype]}", 5, 8)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), ref.data_ptr(), off.data_ptr(),
                        logit.data_ptr(), out.data_ptr(), B, Q, S, M, D, P, plan.lanes,
                        int(plan.vec), _levels(spatial_shapes), L, _stream(value)),
                     "msda_proj")
    msda_proj.launches += 1
    return out


class MSDAProjFunction(torch.autograd.Function):
    """K8 forward. The backward splits as the JAX package's VJP does: loc and
    att are rebuilt from the raw projections under autograd, K7 gives their
    gradients and the value's, and autograd chains them to the references,
    offsets and logits."""

    @staticmethod
    def forward(ctx, value, ref, off, logit, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, ref, off, logit)
        return _launch_proj(value, spatial_shapes, ref, off, logit)

    @staticmethod
    def backward(ctx, grad_out):
        value, *proj = ctx.saved_tensors
        M = value.shape[2]
        needs = ctx.needs_input_grad[1:4]
        with torch.enable_grad():
            ref, off, logit = (t.detach().requires_grad_(n)
                               for t, n in zip(proj, needs))
            loc = proj_locations(ctx.spatial_shapes, ref, off, M)
            att = proj_weights(logit, M, len(ctx.spatial_shapes))
        g_value, g_loc, g_att = msda_rows_bwd(
            value, ctx.spatial_shapes, loc.detach().contiguous(),
            att.detach().contiguous(), grad_out.contiguous())
        leaves = [t for t in (ref, off, logit) if t.requires_grad]
        grads = iter(torch.autograd.grad([loc, att], leaves, [g_loc, g_att],
                                         allow_unused=True) if leaves else ())
        g_proj = [next(grads) if n else None for n in needs]
        return (g_value if ctx.needs_input_grad[0] else None, *g_proj, None)


def msda_proj(value, spatial_shapes, ref, off, logit):
    """K8 (see module docstring). Returns (B, Q, M*D) in the value's dtype."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K8_proj"):
        if not value.is_cuda:
            msda_proj.plain_calls += 1
            return msda_proj_plain(value, spatial_shapes, ref, off, logit)
        return MSDAProjFunction.apply(value, ref, off, logit, spatial_shapes)


msda_proj.launches = 0
msda_proj.plain_calls = 0


# ---------------------------------------------------------------------------
# K9: the q-major op's backward from precomputed taps
# ---------------------------------------------------------------------------

def taps(spatial_shapes, loc, att):
    """The four bilinear entries of every sampling point.

    loc (B, Q, M, L, P, 2); att (B, Q, M, L, P) -> idx (B, M, Q, L, 4P) int32,
    the level-local raster index of each entry's pixel (clamped into the
    level), and wt (B, M, Q, L, 4P) f32 = bilinear weight * validity *
    attention weight. The entries of point p are 4p .. 4p+3 in the order
    top-left, top-right, bottom-left, bottom-right. wt is differentiable with
    respect to loc and att; an entry outside the level has weight 0 and gives
    both a zero gradient."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    B, Q, M, L, P, _ = loc.shape
    dev = loc.device
    hs = torch.tensor([h for h, _ in spatial_shapes], device=dev).view(1, 1, 1, L, 1)
    ws = torch.tensor([w for _, w in spatial_shapes], device=dev).view(1, 1, 1, L, 1)
    x = loc[..., 0].float() * ws - 0.5                     # (B, Q, M, L, P)
    y = loc[..., 1].float() * hs - 0.5
    x0 = torch.floor(x).detach()
    y0 = torch.floor(y).detach()
    dx = x - x0
    dy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    attf = att.float()
    idxs, wts = [], []
    for oy, ox, tw in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                       (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
        yi, xi = y0i + oy, x0i + ox
        valid = ((xi >= 0) & (xi < ws) & (yi >= 0) & (yi < hs)).float()
        idxs.append(torch.minimum(yi.clamp(min=0), hs - 1) * ws
                    + torch.minimum(xi.clamp(min=0), ws - 1))
        wts.append(tw * valid * attf)
    idx = torch.stack(idxs, -1).reshape(B, Q, M, L, P * 4).to(torch.int32)
    wt = torch.stack(wts, -1).reshape(B, Q, M, L, P * 4)
    return idx.permute(0, 2, 1, 3, 4).contiguous(), wt.permute(0, 2, 1, 3, 4).contiguous()


def msda_taps_bwd_plain(value, spatial_shapes, idx, wt, grad_out):
    """Plain K9. value (B, S, M, D); idx, wt (B, MG, Q, L, K4); grad_out
    (B, Q, MG*D). Returns (grad_value (B, S, M, D) in the value's dtype,
    grad_wt f32 like wt). An index outside its level contributes nothing."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    B, S, M, D = value.shape
    _, MG, Q, L, K4 = idx.shape
    G = MG // M
    g = grad_out.float().reshape(B, Q, MG, D).permute(0, 2, 1, 3)     # (B, MG, Q, D)
    v = value.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)  # (B, MG, S, D)
    grad_v = torch.zeros_like(v)
    grad_wt = []
    for lvl, ((h, w), start) in enumerate(zip(spatial_shapes,
                                              level_start_index(spatial_shapes))):
        i = idx[:, :, :, lvl].long()                                  # (B, MG, Q, K4)
        ok = (i >= 0) & (i < h * w)
        rows = (i.clamp(0, h * w - 1) + start).reshape(B, MG, Q * K4, 1).expand(-1, -1, -1, D)
        gathered = torch.gather(v, 2, rows).reshape(B, MG, Q, K4, D)
        grad_wt.append((gathered * g[:, :, :, None]).sum(-1) * ok)
        contrib = (wt[:, :, :, lvl].float() * ok)[..., None] * g[:, :, :, None]
        grad_v.scatter_add_(2, rows, contrib.reshape(B, MG, Q * K4, D))
    grad_v = grad_v.reshape(B, M, G, S, D).sum(2).permute(0, 2, 1, 3)
    return grad_v.to(value.dtype).contiguous(), torch.stack(grad_wt, 3)


# The gather of K5, K7 and K9 (csrc/msda_bwd.cuh `bwd_gather_kernel`): a
# value row `bwd_groups` groups of `lanes` lanes, each lane `per` chunks of
# `cw` channels (16 bytes where `vec`, else one); a warp 32 / (lanes * gpr)
# rows
TapsPlan = collections.namedtuple("TapsPlan", "vec cw chunks lanes per")


@functools.lru_cache(maxsize=None)
def taps_plan(head_dim: int, dtype, aligned: bool) -> TapsPlan:
    """The gather's split of a value row's `head_dim` channels over a lane
    group: chunks of 16 bytes where the value and g are `aligned` to 16
    bytes and D fills whole chunks, else of one channel; `per` chunks a lane
    (1, 2 or `BWD_MAX_PER`: the fewest that put every chunk in one warp),
    `lanes` the least power of two with lanes * per >= chunks."""
    vn = 16 // (torch.finfo(dtype).bits // 8)
    vec = bool(aligned) and head_dim % vn == 0
    cw = vn if vec else 1
    chunks = -(-head_dim // cw)
    per = 1
    while per * 32 < chunks:
        per *= 2
    if per > _bwd_define("BWD_MAX_PER"):
        raise ValueError(f"taps_plan: head dim {head_dim} needs {chunks} chunks, more "
                         f"than a warp holds")
    lanes = 1
    while lanes * per < chunks:
        lanes *= 2
    return TapsPlan(vec, cw, chunks, lanes, per)


def taps_lanes(plan: TapsPlan, n_entries: int, head_dim: int, flush: bool = False,
               groups: int = None):
    """The gather's work split over one row's lanes, in the kernel's order:
    yields (entry, group, lane of the group, channels) for every chunk a
    lane loads of the row's `n_entries` entries (entry j to group
    j % `groups`, by default as many as fill a warp), or, with `flush`,
    every chunk of the row group 0 stores (entry None); `channels` a range
    of the head's channels."""
    groups = groups or 32 // plan.lanes

    def chunks(sub):
        for k in range(plan.per):
            c0 = (sub + k * plan.lanes) * plan.cw
            if c0 < head_dim:
                yield range(c0, min(c0 + plan.cw, head_dim))

    if flush:
        for sub in range(plan.lanes):
            for chans in chunks(sub):
                yield None, 0, sub, chans
        return
    for e in range(n_entries):
        for sub in range(plan.lanes):
            for chans in chunks(sub):
                yield e, e % groups, sub, chans


def msda_taps_bwd_mirror(value, spatial_shapes, idx, wt, grad_out, plan=None,
                         tile_order=None, row_order=None):
    """K9 on the CPU in the kernels' order (csrc/msda_bwd.cuh): each entry's
    key (its value row, or n_rows outside its level), the stable radix sort
    (tiles in `tile_order`), one warp's sums a row (rows in `row_order`).
    Returns what `msda_taps_bwd_plain` returns, in f32 arithmetic."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    B, S, M, D = value.shape
    _, MG, Q, L, K4 = idx.shape
    G = MG // M
    plan = plan or taps_plan(D, value.dtype, True)
    n_rows = B * S * M
    e = torch.arange(idx.numel())
    lvl = e // K4 % L
    item = e // (K4 * L)
    mg, b = item // Q % MG, item // Q // MG
    sizes = torch.tensor([h * w for h, w in spatial_shapes])[lvl]
    starts = torch.as_tensor(level_start_index(spatial_shapes))[lvl]
    i = idx.reshape(-1).long()
    ok = (i >= 0) & (i < sizes)
    keys = torch.where(ok, (b * S + starts + i) * M + mg // G, n_rows)
    skeys, order = _radix_sort_mirror(keys, n_rows, tile_order)
    g_rows = grad_out.float().reshape(B * Q * MG, D)[(b * Q + item % Q) * MG + mg]
    grad, dots = _gather_mirror(value.float().reshape(n_rows, D), g_rows,
                                wt.reshape(-1).float(), skeys, order, n_rows, plan, row_order)
    return grad.reshape(value.shape).to(value.dtype), dots.reshape(idx.shape)


def msda_taps_bwd(value, spatial_shapes, idx, wt, grad_out):
    """K9 (see module docstring). Returns (grad_value in the value's dtype,
    grad_wt f32)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    with trace.span("msda.K9_taps_bwd"):
        if not value.is_cuda:
            msda_taps_bwd.plain_calls += 1
            return msda_taps_bwd_plain(value, spatial_shapes, idx, wt, grad_out)
        B, S, M, D = value.shape
        _, MG, Q, L, K4 = idx.shape
        if L > _MAX_LEVELS or L != len(spatial_shapes):
            raise ValueError(f"msda_taps_bwd: {L} levels for {len(spatial_shapes)} "
                             f"shapes (at most {_MAX_LEVELS})")
        if value.dtype not in _DTYPES:
            raise ValueError(f"msda_taps_bwd: unsupported dtype {value.dtype}")
        _check_cuda("msda_taps_bwd", value.device, (value, grad_out), value.dtype)
        _check_cuda("msda_taps_bwd", value.device, (idx,), torch.int32)
        _check_cuda("msda_taps_bwd", value.device, (wt,), torch.float32)
        if (S != sum(h * w for h, w in spatial_shapes) or MG % M
                or tuple(wt.shape) != tuple(idx.shape)
                or tuple(grad_out.shape) != (B, Q, MG * D)):
            raise ValueError("msda_taps_bwd: inconsistent shapes")
        value, grad_out = _aligned16(value), _aligned16(grad_out)
        g_value = torch.empty_like(value)
        g_wt = torch.empty_like(wt)
        plan = taps_plan(D, value.dtype, True)
        gpr = bwd_groups(plan, idx.numel(), B * S * M)
        sc = bwd_scratch(idx.numel(), B * S * M, value.device, weights=False)
        fn = _function(f"msda_taps_bwd_{_DTYPES[value.dtype]}", 15, 11)
        with torch.cuda.device(value.device):
            _build.check(fn(value.data_ptr(), idx.data_ptr(), wt.data_ptr(),
                            grad_out.data_ptr(), g_value.data_ptr(), g_wt.data_ptr(),
                            *_scratch_ptrs(sc), sc["begin"].data_ptr(), sc["end"].data_ptr(),
                            sc["hist"].data_ptr(), sc["sums"].data_ptr(), sc["top"].data_ptr(),
                            B, Q, S, M, MG // M, D, K4, plan.lanes, plan.per, int(plan.vec), gpr,
                            _levels(spatial_shapes), L, _stream(value)), "msda_taps_bwd")
        msda_taps_bwd.launches += 1
        return g_value, g_wt


msda_taps_bwd.launches = 0
msda_taps_bwd.plain_calls = 0


class MSDATapsFunction(torch.autograd.Function):
    """The q-major op: K6 forward; backward K9 on the taps of (loc, att),
    then the chain rule through `taps` for grad_loc and grad_att."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, att)
        with trace.span("msda.K6_rows"):
            return _launch_rows(value, spatial_shapes, loc, att)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:3]
        with torch.enable_grad():
            loc, att = (t.detach().requires_grad_(n)
                        for t, n in zip((loc, att), needs))
            idx, wt = taps(ctx.spatial_shapes, loc, att)
        g_value, g_wt = msda_taps_bwd(value, ctx.spatial_shapes, idx, wt.detach(),
                                      grad_out.contiguous().to(value.dtype))
        leaves = [t for t in (loc, att) if t.requires_grad]
        grads = iter(torch.autograd.grad(wt, leaves, g_wt, allow_unused=True)
                     if leaves else ())
        g_rows = [next(grads) if n else None for n in needs]
        return (g_value if ctx.needs_input_grad[0] else None, *g_rows, None)


def level_groups(n_levels: int, most: int = _MAX_LEVELS):
    """[(l0, l1), ...]: consecutive runs of at most `most` levels."""
    return [(l0, min(l0 + most, n_levels)) for l0 in range(0, n_levels, most)]


def by_level_groups(fn, value, spatial_shapes, loc, att):
    """`fn(value, shapes, loc, att)` over the level groups of
    `level_groups`, the outputs summed in their dtype (the sum over levels
    split: `ms_deform_attn_pallas_auto`, devis_tpu/ops/ms_deform_attn_pallas.py
    :2494-2512)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    groups = level_groups(len(spatial_shapes))
    if len(groups) == 1:
        return fn(value, spatial_shapes, loc, att)
    starts = list(level_start_index(spatial_shapes)) + [value.shape[1]]
    out = None
    for l0, l1 in groups:
        o = fn(value[:, starts[l0]:starts[l1]].contiguous(), spatial_shapes[l0:l1],
               loc[:, :, :, l0:l1].contiguous(), att[:, :, :, l0:l1].contiguous())
        out = o if out is None else out + o
    return out


def msda_taps(value, spatial_shapes, loc, att):
    """The generic q-major attention `ms_deform_attn(value, shapes, loc, att)`
    of the JAX package's Pallas route: K6 forward, K9 backward. loc
    (B, Q, MG, L, P, 2) f32, att (B, Q, MG, L, P) f32 with G = MG / M heads a
    value head (`_launch_rows`). More than 16 levels run as level groups
    (`by_level_groups`), a K6 launch each. Returns (B, Q, MG*D)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        with trace.span("msda.K6_rows"):
            msda_taps.plain_calls += 1
            return ms_deform_attn(value, spatial_shapes, loc, att)
    return by_level_groups(lambda v, s, lo, a: MSDATapsFunction.apply(v, lo, a, s),
                           value, spatial_shapes, loc, att)


msda_taps.plain_calls = 0     # its launches count as K6's (`msda_rows`) and K9's
