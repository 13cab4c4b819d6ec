"""Deformable-attention kernels (K1-K3, K5-K9) and their plain versions.

The port's counterpart of `devis_tpu/ops/ms_deform_attn_pallas.py`. Each
public op takes the JAX package's q-major layout and dispatches on where its
tensors lie: on the CPU it runs the plain PyTorch version; on a CUDA device it
launches the hand-written kernel from `csrc/ms_deform_attn*.cu`, or raises. `launches` counts kernel launches
and `plain_calls` CPU dispatches, per op.

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
    its backward. `query_grid` (H, W) says the queries are an H x W pixel
    grid (the DCN route), which K7 takes in 2-D tiles. K6 takes raster runs
    of (b, q, m) in the split `rows_plan` gives: each tap's geometry
    computed once, chunks of channels over the threads, taps over groups of
    threads where the launch is too small to fill the card.
  * K5 and K7 share one windowed block (`csrc/msda_common.cuh`): per query
    tile and stage (frame slot, level) the corners' value-gradient adds are
    sorted by window row (the box of rows the tile's taps touch, its first
    `bwd_plan(...).cap` rows in raster order) and each row is summed on chip
    and added once with a vector atomic; corners past the capacity add where
    they lie. `msda_*_bwd_windowed_plain` repeat that in PyTorch and count
    the adds.
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
plain versions. The value gradient's flushes are f32 atomics: equal inputs
give results that differ in the last bits from run to run.

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
from .ms_deform_attn import (Shapes, level_start_index, ms_deform_attn,
                             ms_deform_attn_temporal_plain, normalize_shapes,
                             rule_window, temporal_frame_table)

Q_BLOCK = 128
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_LEVELS = 16
_MAX_WINDOW = 16
# K1's shared memory (csrc/ms_deform_attn.cu): a head of softmax statistics
# and window bounds, 32 bytes of tap (rows and weights) per (query, point),
# and two stage buffers of value rows padded to 16 bytes
K1_HEAD_BYTES = 2 * Q_BLOCK * 4 + 3 * (1 + _MAX_WINDOW) * _MAX_LEVELS * 4
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
# K5 and K7 on windows: the capacity plan and the windowed plain version
# ---------------------------------------------------------------------------

# The windowed backward block (csrc/msda_common.cuh, `msda_bwd_block`): 512
# threads; 128 bytes of box, scan totals and flag; per (query, point) 64
# bytes of tap (geometry, sums, the corners' places and sorted weights and
# queries) and 4 f32 dots a 16-byte channel chunk; the queries' output
# gradient slice as f32; 8 bytes per window row (its bin, the touched list)
BWD_THREADS = 512
BWD_HEAD_BYTES = 128
BWD_TAP_BYTES = 64
BWD_MAX_SLICE = 64            # channels a slice: at most 8 bf16 / 16 f32 lanes a query
BwdPlan = collections.namedtuple("BwdPlan", "qb tile slice lanes pitch cap smem")
_BWD_TILES = {128: (8, 16), 256: (16, 16), 512: (16, 32)}
BWD_GRID_ROWS = 4096
BWD_MIN_BLOCKS = 4 * 132    # two waves of two blocks an SM on an H100


def bwd_smem_bytes(qb: int, n_points: int, cap: int, pitch: int, vec: int) -> int:
    """Dynamic shared memory of one K5/K7 block, as the kernel lays it out
    (`vec` channels in 16 bytes of the value's dtype)."""
    return (BWD_HEAD_BYTES + qb * n_points * (BWD_TAP_BYTES + 16 * (pitch // vec))
            + qb * pitch * 4 + -(-cap * 8 // 16) * 16)


def bwd_plan(spatial_shapes, dtype, head_dim: int, n_points: int,
             query_grid=None) -> BwdPlan:
    """The capacity plan of K5 and K7. Channels in slices of at most
    `BWD_MAX_SLICE` (a multiple of 16 bytes of the value's dtype), one block
    a slice; `lanes` a query in the pass over corners past the capacity, each
    owning 16 bytes of a slice; `qb` queries a block (128, or 256 and 512
    where a query takes 2 and 1 lanes; twice that in a query grid where
    shared memory still holds `BWD_GRID_ROWS` window rows), in 2-D `tile`s
    (rows, columns) of the `query_grid` where one is given; `pitch` f32 of a
    query's staged output gradient; `cap` window rows a stage sorts its
    corners into (the first `cap` rows of the box in raster order), as many
    as let two blocks share an SM's shared memory (two are what the
    registers allow), at most the largest level. Raises where the taps alone
    do not fit. A caller may `_replace` `cap` (0: no window); the launchers
    check the bytes."""
    grid = None if query_grid is None else tuple(int(v) for v in query_grid)
    return _bwd_plan(normalize_shapes(spatial_shapes), dtype, int(head_dim), int(n_points),
                     grid)


@functools.lru_cache(maxsize=None)
def _bwd_plan(spatial_shapes, dtype, D, P, query_grid):
    vec = 16 // (torch.finfo(dtype).bits // 8)
    n_slices = -(-D // BWD_MAX_SLICE)
    slice_ = min(-(-(-(-D // n_slices)) // vec) * vec, D)
    lanes = 1
    while lanes * vec < slice_:
        lanes *= 2
    pitch = -(-slice_ // vec) * vec
    limit = SMEM_PER_SM // 2 - SMEM_RESERVED
    largest = max(h * w for h, w in spatial_shapes)
    qb = max(128, BWD_THREADS // lanes)
    # a query grid takes tiles twice as large where a window of BWD_GRID_ROWS
    # rows (or the whole level) still fits: fewer halo rows a query are read
    # and flushed
    if query_grid is not None and qb < 512 and \
            bwd_smem_bytes(2 * qb, P, min(BWD_GRID_ROWS, largest), pitch, vec) <= limit:
        qb *= 2
    if bwd_smem_bytes(qb, P, 0, pitch, vec) > limit or 4 * qb * P > 0xffff:
        raise ValueError(f"bwd_plan: {P} points a query leave no shared memory for "
                         f"{qb}-query blocks")
    cap = min((limit - bwd_smem_bytes(qb, P, 0, pitch, vec)) // 16 * 2, largest)
    return BwdPlan(qb, None if query_grid is None else _BWD_TILES[qb], slice_, lanes, pitch,
                   cap, bwd_smem_bytes(qb, P, cap, pitch, vec))


def _bwd_tiles(Q, plan, query_grid, device):
    """(tile of every query (Q,), tiles per (frame, head))."""
    q = torch.arange(Q, device=device)
    if query_grid is None:
        return q // plan.qb, -(-Q // plan.qb)
    gh, gw = query_grid
    th, tw = plan.tile
    tiles_x = -(-gw // tw)
    return (q // gw // th) * tiles_x + (q % gw) // tw, -(-gh // th) * tiles_x


def _bwd_windowed_plain(value, spatial_shapes, loc, att, grad_out, frames, plan,
                        query_grid):
    """The windowed backward of K5 and K7 in plain PyTorch, block by block as
    the kernel runs it: per block and stage the box of rows the live taps'
    corners touch (clipped to the level), rows of the box in raster order,
    row i staged where i < min(area, plan.cap); staged adds summed in the
    block's accumulator and its touched rows flushed once, every other
    corner added where it lies. `frames` (N, Lx / L) names the value frame
    of each frame slot of the queries of frame n. Returns (grad_value in the
    value's dtype, grad_loc f32, grad_att f32, adds): adds[0] the f32 values
    the flushes add to grad_value, adds[1] those added past the capacity."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    N, Q, M, Lx, P, _ = loc.shape
    F, S, _, D = value.shape
    L = len(spatial_shapes)
    dev = value.device
    starts = level_start_index(spatial_shapes)
    v = value.float().reshape(F * S * M, D)
    g = grad_out.float().reshape(N, Q, M, 1, D)
    g_value = torch.zeros(F * S * M, D, dtype=torch.float32, device=dev)
    g_loc = torch.zeros(loc.shape, dtype=torch.float32, device=dev)
    g_att = torch.zeros(att.shape, dtype=torch.float32, device=dev)
    tile, n_tiles = _bwd_tiles(Q, plan, query_grid, dev)
    mi = torch.arange(M, device=dev).view(1, 1, M, 1)
    blk = ((torch.arange(N, device=dev).view(N, 1, 1, 1) * M + mi) * n_tiles
           + tile.view(1, Q, 1, 1)).expand(N, Q, M, P)
    n_blocks = N * M * n_tiles
    adds = torch.zeros(2, dtype=torch.long)
    for s in range(Lx):
        j, l = divmod(s, L)
        h, w = spatial_shapes[l]
        x = loc[:, :, :, s, :, 0].float() * w - 0.5                # (N, Q, M, P)
        y = loc[:, :, :, s, :, 1].float() * h - 0.5
        live = (x >= -1) & (x < w) & (y >= -1) & (y < h)          # tap_geometry
        x0f = torch.floor(torch.where(live, x, 0.0))
        y0f = torch.floor(torch.where(live, y, 0.0))
        dx, dy = x - x0f, y - y0f
        x0, y0 = x0f.long(), y0f.long()
        a = att[:, :, :, s].float()

        def box(vals, init, how):
            out = torch.full((n_blocks,), init, dtype=torch.long, device=dev)
            return out.scatter_reduce(0, blk[live], vals[live], how)
        by0 = box(y0.clamp(min=0), 2 ** 62, "amin")
        by1 = box((y0 + 1).clamp(max=h - 1), -1, "amax")
        bx0 = box(x0.clamp(min=0), 2 ** 62, "amin")
        bx1 = box((x0 + 1).clamp(max=w - 1), -1, "amax")
        bw = torch.where(by1 >= 0, bx1 - bx0 + 1, 0)
        nst = torch.where(by1 >= 0, (by1 - by0 + 1) * bw, 0).clamp(max=plan.cap)
        acc = torch.zeros(n_blocks, plan.cap, D, dtype=torch.float32, device=dev)
        touched = torch.zeros(n_blocks, plan.cap, dtype=torch.bool, device=dev)
        base = (frames[:, j].view(N, 1, 1, 1) * S + starts[l]) * M + mi
        s_v, s_x, s_y = (torch.zeros_like(x) for _ in range(3))
        for oy, ox, wc, cx, cy in ((0, 0, (1 - dy) * (1 - dx), -(1 - dy), -(1 - dx)),
                                   (0, 1, (1 - dy) * dx, 1 - dy, -dx),
                                   (1, 0, dy * (1 - dx), -dy, 1 - dx),
                                   (1, 1, dy * dx, dy, dx)):
            yi, xi = y0 + oy, x0 + ox
            ok = live & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            rows = base + (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)) * M
            gv = torch.where(ok, (g * v[rows]).sum(-1), 0.0)
            s_v, s_x, s_y = s_v + wc * gv, s_x + cx * gv, s_y + cy * gv
            add = (a * wc)[..., None] * g                          # (N, Q, M, P, D)
            r = (yi - by0[blk]) * bw[blk] + (xi - bx0[blk])
            staged = ok & (r < nst[blk])
            over = ok & ~staged
            acc.index_put_((blk[staged], r[staged]), add[staged], accumulate=True)
            touched[blk[staged], r[staged]] = True
            g_value.index_add_(0, rows[over], add[over])
            adds[1] += int(over.sum()) * D
        bi, ri = touched.nonzero(as_tuple=True)
        nb, mb = bi // (M * n_tiles), bi // n_tiles % M
        ry, rx = by0[bi] + ri // bw[bi], bx0[bi] + ri % bw[bi]
        rows = (frames[nb, j] * S + starts[l] + ry * w + rx) * M + mb
        g_value.index_add_(0, rows, acc[bi, ri])
        adds[0] += bi.numel() * D
        g_att[:, :, :, s] = torch.where(live, s_v, 0.0)
        g_loc[:, :, :, s, :, 0] = torch.where(live, a * s_x * w, 0.0)
        g_loc[:, :, :, s, :, 1] = torch.where(live, a * s_y * h, 0.0)
    return g_value.reshape(value.shape).to(value.dtype), g_loc, g_att, adds


def msda_temporal_bwd_windowed_plain(value, spatial_shapes, loc, att, grad_out,
                                     rule=("all",), plan=None):
    """Plain K5 as the windowed kernel sums it (`_bwd_windowed_plain`), at
    `plan` (default `bwd_plan`). Returns (grad_value, grad_loc, grad_att,
    adds)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    T = value.shape[0]
    plan = plan or bwd_plan(spatial_shapes, value.dtype, value.shape[3], loc.shape[4])
    table = torch.as_tensor(temporal_frame_table(rule, T), dtype=torch.long,
                            device=value.device)
    frames = torch.cat([torch.arange(T, device=value.device)[:, None], table], 1)
    return _bwd_windowed_plain(value, spatial_shapes, loc, att, grad_out, frames, plan, None)


def msda_rows_bwd_windowed_plain(value, spatial_shapes, loc, att, grad_out, plan=None,
                                 query_grid=None):
    """Plain K7 as the windowed kernel sums it, in raster blocks or in 2-D
    tiles of `query_grid` (H, W). Returns (grad_value, grad_loc, grad_att,
    adds)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    plan = plan or bwd_plan(spatial_shapes, value.dtype, value.shape[3], loc.shape[4],
                            query_grid)
    frames = torch.arange(value.shape[0], device=value.device)[:, None]
    return _bwd_windowed_plain(value, spatial_shapes, loc, att, grad_out, frames, plan,
                               query_grid)


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


def _check_geometry(name, spatial_shapes, D, W):
    """Limits of the temporal kernels (one lane per channel)."""
    if len(spatial_shapes) > _MAX_LEVELS:
        raise ValueError(f"{name}: at most {_MAX_LEVELS} levels")
    if D > 32:
        raise ValueError(f"{name}: head dim {D} > 32 is not supported")
    if W > _MAX_WINDOW:
        raise ValueError(f"{name}: at most {_MAX_WINDOW} temporal frames")


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
    _check_geometry("msda_temporal_proj", spatial_shapes, D, W)
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
    if not ref.is_cuda:
        msda_tap_window.plain_calls += 1
        return msda_tap_window_plain(spatial_shapes, ref, c_off, t_off, n_heads)
    T, Q, L, _ = ref.shape
    M = n_heads
    P = c_off.shape[-1] // (M * L * 2)
    W = t_off.shape[-1] // (M * L * P * 2)
    _check_geometry("msda_tap_window", spatial_shapes, 0, W)
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


def _check_rows(name, value, spatial_shapes, loc, att, n_levels):
    """Shapes and types shared by K3, K5, K6 and K7."""
    B, S, M, D = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    _check_cuda(name, value.device, (value,), value.dtype)
    _check_cuda(name, value.device, (loc, att), torch.float32)
    if value.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {value.dtype}")
    if (S != sum(h * w for h, w in spatial_shapes)
            or tuple(loc.shape) != (B, Q, M, n_levels, P, 2)
            or tuple(att.shape) != (B, Q, M, n_levels, P)):
        raise ValueError(f"{name}: inconsistent shapes")
    return B, Q, S, M, D, P


def _launch_temporal(value, spatial_shapes, loc, att, rule):
    L = len(spatial_shapes)
    W = rule_window(rule, value.shape[0])
    _check_geometry("msda_temporal", spatial_shapes, value.shape[3], W)
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


def _grad_buffers(value, loc, att, sliced=False):
    """f32 gradient buffers of a backward kernel; the value's is zeroed for
    the atomic adds, and so are loc's and att's where the channels take
    several slices (each adds its share)."""
    rows = torch.zeros_like if sliced else torch.empty_like
    return (torch.zeros(value.shape, dtype=torch.float32, device=value.device),
            rows(loc), rows(att))


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
    if not value.is_cuda:
        msda_temporal.plain_calls += 1
        return ms_deform_attn_temporal_plain(value, spatial_shapes, loc, att,
                                             rule)
    return MSDATemporalFunction.apply(value, loc, att, spatial_shapes, rule)


msda_temporal.launches = 0
msda_temporal.plain_calls = 0


def bwd_stage_groups(n_blocks: int, n_stages: int) -> int:
    """Groups of stages (levels of frame slots) a K5/K7 launch splits over
    blocks: enough that `n_blocks` blocks a group reach `BWD_MIN_BLOCKS`,
    at most one a stage. The stages are independent; splitting them costs
    each extra block the staging of its queries' output gradient."""
    return max(1, min(n_stages, -(-BWD_MIN_BLOCKS // max(n_blocks, 1))))


def _check_bwd_plan(name, plan, n_points, dtype):
    vec = 16 // (torch.finfo(dtype).bits // 8)
    smem = bwd_smem_bytes(plan.qb, n_points, plan.cap, plan.pitch, vec)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{name}: plan {plan} needs {smem} bytes of shared memory, more "
                         f"than {SMEM_PER_BLOCK}")


def launch_temporal_bwd(value, spatial_shapes, loc, att, grad_out, rule, out, plan=None,
                        adds=None):
    """One K5 launch into `out` = (grad_value f32, zeroed; grad_loc; grad_att,
    zeroed where the plan cuts D into slices) at `plan` (default `bwd_plan`).
    `adds`, a zeroed (2,) int64 tensor on the device, receives the kernel's
    counts of f32 values added to grad_value (by flushes, past the
    capacity). Counts no launch."""
    L = len(spatial_shapes)
    W = rule_window(rule, value.shape[0])
    _check_geometry("msda_temporal_bwd", spatial_shapes, value.shape[3], W)
    T, Q, S, M, D, P = _check_rows("msda_temporal_bwd", value, spatial_shapes,
                                   loc, att, (1 + W) * L)
    _check_cuda("msda_temporal_bwd", value.device, (grad_out,), value.dtype)
    if tuple(grad_out.shape) != (T, Q, M * D):
        raise ValueError("msda_temporal_bwd: inconsistent shapes")
    plan = plan or bwd_plan(spatial_shapes, value.dtype, D, P)
    _check_bwd_plan("msda_temporal_bwd", plan, P, value.dtype)
    g_value, g_loc, g_att = out
    groups = bwd_stage_groups(T * M * -(-Q // plan.qb) * -(-D // plan.slice), (1 + W) * L)
    fn = _function(f"msda_temporal_bwd_{_DTYPES[value.dtype]}", 8, 12)
    rule_all, offsets = _rule_args(rule)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                        grad_out.data_ptr(), g_value.data_ptr(), g_loc.data_ptr(),
                        g_att.data_ptr(), None if adds is None else adds.data_ptr(),
                        T, Q, S, M, D, P, plan.qb, plan.cap, plan.slice, plan.pitch,
                        plan.lanes, groups, _levels(spatial_shapes), L, rule_all, offsets, W,
                        _stream(value)), "msda_temporal_bwd")


def msda_temporal_bwd(value, spatial_shapes, loc, att, grad_out, rule=("all",)):
    """K5 (see module docstring). Returns (grad_value in the value's dtype,
    grad_loc f32, grad_att f32)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        msda_temporal_bwd.plain_calls += 1
        return msda_temporal_bwd_plain(value, spatial_shapes, loc, att, grad_out,
                                       rule)
    plan = bwd_plan(spatial_shapes, value.dtype, value.shape[3], loc.shape[4])
    out = _grad_buffers(value, loc, att, plan.slice < value.shape[3])
    launch_temporal_bwd(value, spatial_shapes, loc, att, grad_out, rule, out, plan)
    msda_temporal_bwd.launches += 1
    return out[0].to(value.dtype), out[1], out[2]


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
    L = len(spatial_shapes)
    if L > _MAX_LEVELS:
        raise ValueError(f"msda_rows: at most {_MAX_LEVELS} levels")
    B, Q, S, M, D, P = _check_rows("msda_rows", value, spatial_shapes, loc, att, L)
    if loc.data_ptr() % 8:          # the kernel reads a tap's (x, y) as one float2
        loc = loc.clone()
    plan = rows_plan(D, value.dtype, value.data_ptr() % 16 == 0, M, L, P, B * Q)
    out = torch.empty((B, Q, M * D), dtype=value.dtype, device=value.device)
    fn = _function(f"msda_rows_{_DTYPES[value.dtype]}", 4, 13)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                        out.data_ptr(), B, Q, S, M, D, P, int(plan.vec), plan.lanes,
                        plan.groups, plan.slices, plan.chunks, plan.units, plan.threads,
                        _levels(spatial_shapes), L, _stream(value)), "msda_rows")
    msda_rows.launches += 1
    return out


class MSDARowsFunction(torch.autograd.Function):
    """K6 forward, K7 backward."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes, query_grid):
        ctx.spatial_shapes, ctx.query_grid = spatial_shapes, query_grid
        ctx.save_for_backward(value, loc, att)
        return _launch_rows(value, spatial_shapes, loc, att)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        grads = msda_rows_bwd(value, ctx.spatial_shapes, loc, att,
                              grad_out.contiguous(), ctx.query_grid)
        return (*(g if n else None for g, n in zip(grads, ctx.needs_input_grad)),
                None, None)


def msda_rows(value, spatial_shapes, loc, att, query_grid=None):
    """K6 (see module docstring). Returns (B, Q, M*D) in the value's dtype.
    `query_grid` (H, W) is passed to the backward (K7's 2-D tiles)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        msda_rows.plain_calls += 1
        return ms_deform_attn(value, spatial_shapes, loc, att)
    return MSDARowsFunction.apply(value, loc, att, spatial_shapes, query_grid)


msda_rows.launches = 0
msda_rows.plain_calls = 0


def launch_rows_bwd(value, spatial_shapes, loc, att, grad_out, out, plan=None,
                    query_grid=None, adds=None):
    """One K7 launch into `out` = (grad_value f32, zeroed; grad_loc; grad_att,
    zeroed where the plan cuts D into slices) at `plan` (default `bwd_plan`),
    in 2-D tiles of `query_grid` (H, W) where given, else in raster blocks;
    `adds` as in `launch_temporal_bwd`. Counts no launch."""
    L = len(spatial_shapes)
    if L > _MAX_LEVELS:
        raise ValueError(f"msda_rows_bwd: at most {_MAX_LEVELS} levels")
    B, Q, S, M, D, P = _check_rows("msda_rows_bwd", value, spatial_shapes, loc,
                                   att, L)
    _check_cuda("msda_rows_bwd", value.device, (grad_out,), value.dtype)
    if tuple(grad_out.shape) != (B, Q, M * D):
        raise ValueError("msda_rows_bwd: inconsistent shapes")
    if query_grid is not None and query_grid[0] * query_grid[1] != Q:
        raise ValueError(f"msda_rows_bwd: query grid {tuple(query_grid)} for {Q} queries")
    plan = plan or bwd_plan(spatial_shapes, value.dtype, D, P, query_grid)
    _check_bwd_plan("msda_rows_bwd", plan, P, value.dtype)
    if (plan.tile is None) != (query_grid is None):
        raise ValueError("msda_rows_bwd: a plan with tiles needs a query grid, and one "
                         "without tiles none")
    gh, gw = query_grid or (0, 0)
    th, tw = plan.tile if query_grid else (0, 0)
    n_tiles = -(-gh // th) * -(-gw // tw) if query_grid else -(-Q // plan.qb)
    groups = bwd_stage_groups(B * M * n_tiles * -(-D // plan.slice), L)
    g_value, g_loc, g_att = out
    fn = _function(f"msda_rows_bwd_{_DTYPES[value.dtype]}", 8, 16)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                        grad_out.data_ptr(), g_value.data_ptr(), g_loc.data_ptr(),
                        g_att.data_ptr(), None if adds is None else adds.data_ptr(),
                        B, Q, S, M, D, P, plan.qb, gh, gw, th, tw, plan.cap, plan.slice,
                        plan.pitch, plan.lanes, groups, _levels(spatial_shapes), L,
                        _stream(value)),
                     "msda_rows_bwd")


def msda_rows_bwd(value, spatial_shapes, loc, att, grad_out, query_grid=None):
    """K7 (see module docstring). `query_grid` (H, W): the queries are an
    H x W pixel grid (the DCN route), taken in 2-D tiles. Returns
    (grad_value in the value's dtype, grad_loc f32, grad_att f32)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        msda_rows_bwd.plain_calls += 1
        return msda_rows_bwd_plain(value, spatial_shapes, loc, att, grad_out)
    plan = bwd_plan(spatial_shapes, value.dtype, value.shape[3], loc.shape[4], query_grid)
    out = _grad_buffers(value, loc, att, plan.slice < value.shape[3])
    launch_rows_bwd(value, spatial_shapes, loc, att, grad_out, out, plan, query_grid)
    msda_rows_bwd.launches += 1
    return out[0].to(value.dtype), out[1], out[2]


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


# K9's launch (csrc/ms_deform_attn_taps.cu, `msda_taps_bwd_kernel`): a warp
# a (b, mg, q), its entries over 32 / lanes groups of `lanes` lanes, each
# lane `per` chunks of `cw` channels (16 bytes where `vec`, else one)
TapsPlan = collections.namedtuple("TapsPlan", "vec cw chunks lanes per")


@functools.lru_cache(maxsize=None)
def taps_plan(head_dim: int, dtype, aligned: bool) -> TapsPlan:
    """The split of a K9 entry's `head_dim` channels over a lane group:
    chunks of 16 bytes where the value, g and grad_value are `aligned` to
    16 bytes and D fills whole chunks, else of one channel; `per` chunks a
    lane (1, 2 or `K9_MAX_PER`: the fewest that put every chunk in one
    warp), `lanes` the least power of two with lanes * per >= chunks."""
    vn = 16 // (torch.finfo(dtype).bits // 8)
    vec = bool(aligned) and head_dim % vn == 0
    cw = vn if vec else 1
    chunks = -(-head_dim // cw)
    per = 1
    while per * 32 < chunks:
        per *= 2
    if per > _build.source_define("ms_deform_attn_taps", "K9_MAX_PER"):
        raise ValueError(f"taps_plan: head dim {head_dim} needs {chunks} chunks, more "
                         f"than a warp holds")
    lanes = 1
    while lanes * per < chunks:
        lanes *= 2
    return TapsPlan(vec, cw, chunks, lanes, per)


def taps_lanes(plan: TapsPlan, n_entries: int, head_dim: int, flush: bool = False):
    """K9's work split inside one warp, in the kernel's order: yields
    (entry, group, lane of the group, channels) for every chunk a lane
    loads (or, with `flush`, every piece of the f32 row it adds to),
    `channels` a range of the head's channels. Entries come in runs of 32;
    within a run group `grp` takes entries grp, grp + 32 / lanes, ...
    The flush splits
    chunks wider than 4 channels (bf16's 8) into pieces of 4, piece p to
    lane p % lanes."""
    width, per = plan.cw, plan.per
    if flush and plan.cw > 4:
        width, per = 4, plan.per * plan.cw // 4
    tpw = 32 // plan.lanes
    for base in range(0, n_entries, 32):
        cnt = min(32, n_entries - base)
        for j in range(cnt):
            for sub in range(plan.lanes):
                for k in range(per):
                    c0 = (sub + k * plan.lanes) * width
                    if c0 < head_dim:
                        yield base + j, j % tpw, sub, range(c0, min(c0 + width, head_dim))


def msda_taps_bwd_mirror(value, spatial_shapes, idx, wt, grad_out, plan=None):
    """K9's index arithmetic on the CPU: each warp's item (b, mg, q) decoded
    as the kernel decodes it, each entry resolved to a value row (or
    dropped), the lanes' chunks of `taps_lanes` summed per group for
    grad_wt, its flush pieces added onto grad_value. Returns what
    `msda_taps_bwd_plain` returns, in f32 arithmetic."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    B, S, M, D = value.shape
    _, MG, Q, L, K4 = idx.shape
    G = MG // M
    plan = plan or taps_plan(D, value.dtype, True)
    items = torch.arange(B * MG * Q)
    q, mg, b = items % Q, (items // Q) % MG, items // Q // MG
    m = mg // G
    n = L * K4
    ix = idx.reshape(-1, n).long()
    w = wt.reshape(-1, n).float()
    g = grad_out.float().reshape(B, Q, MG, D)[b, q, mg]                # (items, D)
    v = value.float()
    grad_v = torch.zeros((B, S, M, D), dtype=torch.float32)
    starts = level_start_index(spatial_shapes)
    sizes = [h * w_ for h, w_ in spatial_shapes]
    dots = torch.zeros((B * MG * Q, n, plan.lanes), dtype=torch.float32)

    def row(e):
        i = ix[:, e]
        live = (i >= 0) & (i < sizes[e // K4])
        return live, torch.where(live, starts[e // K4] + i, torch.zeros_like(i))

    for e, _grp, sub, chans in taps_lanes(plan, n, D):
        live, r = row(e)
        cs = torch.tensor(list(chans))
        vals = v[b[:, None], r[:, None], m[:, None], cs] * live[:, None]
        dots[:, e, sub] += (vals * g[:, cs]).sum(-1)
    for e, _grp, _sub, chans in taps_lanes(plan, n, D, flush=True):
        live, r = row(e)
        cs = torch.tensor(list(chans))
        add = live & (w[:, e] != 0)
        grad_v.index_put_((b[add][:, None], r[add][:, None], m[add][:, None], cs),
                          w[add, e][:, None] * g[add][:, cs], accumulate=True)
    grad_wt = dots.sum(-1).reshape(idx.shape)
    return grad_v.to(value.dtype), grad_wt


def msda_taps_bwd(value, spatial_shapes, idx, wt, grad_out):
    """K9 (see module docstring). Returns (grad_value in the value's dtype,
    grad_wt f32)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
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
    g_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    g_wt = torch.empty_like(wt)
    plan = taps_plan(D, value.dtype, all(t.data_ptr() % 16 == 0
                                         for t in (value, grad_out, g_value)))
    fn = _function(f"msda_taps_bwd_{_DTYPES[value.dtype]}", 6, 10)
    with torch.cuda.device(value.device):
        _build.check(fn(value.data_ptr(), idx.data_ptr(), wt.data_ptr(),
                        grad_out.data_ptr(), g_value.data_ptr(), g_wt.data_ptr(),
                        B, Q, S, M, MG // M, D, K4, plan.lanes, plan.per, int(plan.vec),
                        _levels(spatial_shapes), L, _stream(value)), "msda_taps_bwd")
    msda_taps_bwd.launches += 1
    return g_value.to(value.dtype), g_wt


msda_taps_bwd.launches = 0
msda_taps_bwd.plain_calls = 0


class MSDATapsFunction(torch.autograd.Function):
    """The q-major op: K6 forward; backward K9 on the taps of (loc, att),
    then the chain rule through `taps` for grad_loc and grad_att."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, att)
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


def msda_taps(value, spatial_shapes, loc, att):
    """The generic q-major attention `ms_deform_attn(value, shapes, loc, att)`
    of the JAX package's Pallas route: K6 forward, K9 backward. loc
    (B, Q, M, L, P, 2) f32, att (B, Q, M, L, P) f32 with the value's M heads
    (K6 has no grouped heads; K9 alone takes them). Returns (B, Q, M*D)."""
    spatial_shapes = normalize_shapes(spatial_shapes)
    if not value.is_cuda:
        msda_taps.plain_calls += 1
        return ms_deform_attn(value, spatial_shapes, loc, att)
    return MSDATapsFunction.apply(value, loc, att, spatial_shapes)


msda_taps.plain_calls = 0     # its launches count as K6's (`msda_rows`) and K9's
