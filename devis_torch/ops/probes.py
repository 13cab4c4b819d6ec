"""Probes of the card's costs for the mask head's DCNv2 kernel (K4/K10).

The port's counterparts of the JAX package's two micro-benchmarks, as
hand-written kernels in `csrc/probes.cu` (its header says what bounds each
and how it is built). They are measurement: no model path calls them.

  K12a `tent_band`      <- `benchmarks/bench_tent_gather.py` `_tent_kernel`:
                           bilinear sampling of a flat-strided (C, N + ncand·Wp)
                           array by enumerating an ncand² tent band
  K12b `corner_gather`  <- `_gather_kernel`: the same by floor and 4 corner reads
  K12c `mma_probe`      <- `benchmarks/mxu_probe.py` `probe`: n_dots bf16
                           (K×32)ᵀ·(K×N) products with an f32 accumulator, in
                           `grid` blocks that each store the same tile, on
                           warpgroup products (wgmma); `mma_probe_sync` is
                           the same probe on mma.sync, the instruction K4 uses

Each wrapper runs its plain PyTorch version (``*_plain``, the arithmetic of
the JAX kernel) on CPU tensors and launches its kernel on CUDA tensors, or
raises; `launches` and `plain_calls` count the two. `tent_band_tiled`,
`corner_gather_tiled` and `mma_probe_staged` repeat the kernels' index
arithmetic and shared-memory layouts on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

GRID = 912      # the TPU probe's grid: 48 x 19 steps of the encoder op
# blocks of a cluster that share K12c's streamed tiles by TMA multicast: 1,
# the fastest on the H100 (PERF.md, section 6: 2 and 4 were slower)
CLUSTER = 1
D = 32          # the probe's head width
SOURCE = "probes"


def _lib():
    lib = _build.library(SOURCE)
    if lib.mma_probe_bf16.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        for name in ("tent_band_f32", "corner_gather_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [P, P, P, P, I, I, I, I, I, P]
            fn.restype = I
        lib.mma_probe_bf16.argtypes = [P, P, P, I, I, I, I, I, P]
        lib.mma_probe_sync_bf16.argtypes = [P, P, P, I, I, I, I, P]
        lib.mma_probe_bf16.restype = lib.mma_probe_sync_bf16.restype = I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _band_shapes(name, u, dy, dx, ncand, Wp):
    if dy.dim() != 1 or dx.shape != dy.shape or u.dim() != 2:
        raise ValueError(f"{name}: u (C, N + ncand*Wp), dy and dx (N,)")
    N = dy.shape[0]
    if u.shape[1] != N + ncand * Wp:
        raise ValueError(f"{name}: u has {u.shape[1]} columns, want N + ncand*Wp = "
                         f"{N + ncand * Wp}")
    return u.shape[0], N


# ---------------------------------------------------------------------------
# K12a tent_band
# ---------------------------------------------------------------------------

def tent_band_plain(u, dy, dx, ncand: int, Wp: int, reps: int) -> torch.Tensor:
    """Σ_r Σ_{j,l<ncand} tent(dy + r·1e-6 − (j − lo)) · tent(dx − (l − lo)) ·
    u[:, lo + l + j·Wp + n], lo = (ncand − 1) // 2, tent(z) = max(0, 1 − |z|),
    in `_tent_kernel`'s order; (C, N) f32."""
    C, N = _band_shapes("tent_band", u, dy, dx, ncand, Wp)
    lo = (ncand - 1) // 2
    acc = torch.zeros((C, N), dtype=torch.float32, device=u.device)
    wxs = [torch.clamp(1.0 - (dx - (l - lo)).abs(), min=0.0) for l in range(ncand)]
    for r in range(reps):
        dyr = dy + r * 1e-6
        for j in range(ncand):
            wyj = torch.clamp(1.0 - (dyr - (j - lo)).abs(), min=0.0)
            for l in range(ncand):
                start = lo + l + j * Wp
                acc = acc + (wyj * wxs[l]) * u[:, start:start + N]
    return acc


TentTile = collections.namedtuple("TentTile", "rn cc tx ty tn tc reads pitch")


def tent_tile(ncand: int, vec: bool) -> TentTile:
    """K12a's tile from `csrc/probes.cu`'s `TENT_*` defines: `rn`
    consecutive n and `cc` channels a thread, `tx` x `ty` threads a block
    (`tn` n by `tc` channels); `reads` floats a thread reads of a staged
    band row (whole float4s holding its rn + ncand - 1 values, which start
    up to 3 columns in where rows are staged from a float4 boundary,
    `vec`) and `pitch` floats a staged row (where the last thread's reads
    end)."""
    define = functools.partial(_build.source_define, SOURCE)
    rn, cc, tx, ty = (define(f"TENT_{k}") for k in ("RN", "CC", "TX", "TY"))
    reads = -(-(rn + ncand - 1 + (3 if vec else 0)) // 4) * 4
    return TentTile(rn, cc, tx, ty, tx * rn, ty * cc, reads, (tx - 1) * rn + reads)


def tent_band_tiled(u, dy, dx, ncand: int, Wp: int, reps: int, vec=None):
    """K12a's index arithmetic on the CPU, in the kernel's order: each
    block's band row j of its channels staged as the kernel stages it (from
    the float4 at or below the row's first column where `vec`, which
    defaults to the kernel's choice for a 16-byte aligned u: rows of whole
    float4s; zero past the array; staged columns outside the block's band
    NaN, which no multiply-add may read), each thread's reads at its
    offsets and its segment picked from them, per rep each n's ncand
    weights of row j, the multiply-adds, and the stores. Returns (out (C,
    N), how often each output was stored)."""
    C, N = _band_shapes("tent_band", u, dy, dx, ncand, Wp)
    NW = u.shape[1]
    vec = NW % 4 == 0 if vec is None else vec
    t = tent_tile(ncand, vec)
    lo = (ncand - 1) // 2
    W = t.tn + ncand - 1
    span = t.rn + ncand - 1
    gx, gy = -(-N // t.tn), -(-C // t.tc)
    tx = torch.arange(t.tx)
    # every thread's n (gx, tx, rn) and channels (gy, ty, cc)
    n = (torch.arange(gx)[:, None, None] * t.tn + tx[None, :, None] * t.rn
         + torch.arange(t.rn))
    c = (torch.arange(gy)[:, None, None] * t.tc + torch.arange(t.ty)[None, :, None] * t.cc
         + torch.arange(t.cc))
    inn = n < N
    dyn = torch.where(inn, dy[n.clamp(max=N - 1)], torch.zeros(()))
    dxn = torch.where(inn, dx[n.clamp(max=N - 1)], torch.zeros(()))
    wx = [torch.clamp(1.0 - (dxn - float(l - lo)).abs(), min=0.0) for l in range(ncand)]
    acc = torch.zeros((gy, t.ty, t.cc, gx, t.tx, t.rn), dtype=torch.float32)
    col_t = torch.arange(t.pitch)
    ch = c.reshape(gy, t.tc)
    for j in range(ncand):
        col0 = lo + j * Wp + torch.arange(gx)[:, None] * t.tn             # (gx, 1)
        shift = col0 % 4 if vec else torch.zeros_like(col0)
        # the staged slot of every block: (gy, tc, gx, pitch)
        col = col0 - shift + col_t
        ok = (ch < C)[:, :, None, None] & (col < NW)[None, None]
        slot = u[ch.clamp(max=C - 1)][:, :, col.clamp(max=NW - 1)] * ok
        band = (col_t >= shift) & (col_t < shift + W)
        slot = torch.where(band, slot, torch.tensor(float("nan")))
        # each thread's reads (gy, ty, cc, gx, tx, reads), its segment from them
        at = tx[:, None] * t.rn + torch.arange(t.reads)
        raw = slot.reshape(gy, t.ty, t.cc, gx, t.pitch)[..., at]
        pick = shift[:, :, None] + torch.arange(span)                      # (gx, 1, span)
        seg = torch.gather(raw, -1, pick.expand(raw.shape[:-1] + (span,)))
        for r in range(reps):
            dyr = dyn + torch.tensor(r * 1e-6, dtype=torch.float32)
            wy = torch.clamp(1.0 - (dyr - float(j - lo)).abs(), min=0.0)
            for l in range(ncand):
                acc = acc + (wy * wx[l]) * seg[..., l:l + t.rn]
    out = torch.zeros((C, N), dtype=torch.float32)
    stored = torch.zeros((C, N), dtype=torch.int32)
    cc = c[:, :, :, None, None, None].expand(acc.shape)
    nn = n[None, None, None].expand(acc.shape)
    keep = (cc < C) & (nn < N)
    out.index_put_((cc[keep], nn[keep]), acc[keep])
    stored.index_put_((cc[keep], nn[keep]), torch.ones((), dtype=torch.int32),
                      accumulate=True)
    return out, stored


def tent_band(u, dy, dx, ncand: int, Wp: int, reps: int) -> torch.Tensor:
    """K12a (module docstring): u (C, N + ncand·Wp), dy, dx (N,) f32 → (C, N) f32."""
    if not u.is_cuda:
        tent_band.plain_calls += 1
        return tent_band_plain(u, dy, dx, ncand, Wp, reps)
    return _launch_band("tent_band_f32", tent_band, u, dy, dx, ncand, Wp, reps)


tent_band.launches = 0
tent_band.plain_calls = 0


# ---------------------------------------------------------------------------
# K12b corner_gather
# ---------------------------------------------------------------------------

def corner_gather_plain(u, dy, dx, ncand: int, Wp: int, reps: int) -> torch.Tensor:
    """The same function by 4 corner reads at idx = n + (⌊dy⌋ + lo)·Wp +
    ⌊dx⌋ + 2·lo, in `_gather_kernel`'s order. The corner index is clamped
    into the row as the kernel clamps it (a tap in the band never is)."""
    C, N = _band_shapes("corner_gather", u, dy, dx, ncand, Wp)
    lo = (ncand - 1) // 2
    NW = u.shape[1]
    acc = torch.zeros((C, N), dtype=torch.float32, device=u.device)
    lanes = torch.arange(N, device=u.device)
    for r in range(reps):
        dyr = dy + r * 1e-6
        jy, jx = torch.floor(dyr), torch.floor(dx)
        fy, fx = dyr - jy, dx - jx
        idx = lanes + (jy.long() + lo) * Wp + jx.long() + 2 * lo
        idx = idx.clamp(0, NW - Wp - 2)
        for sy in (0, 1):
            for sx in (0, 1):
                sel = u[:, idx + sy * Wp + sx]
                wy = (1.0 - fy) if sy == 0 else fy
                wx = (1.0 - fx) if sx == 0 else fx
                acc = acc + (wy * wx) * sel
    return acc


GatherTile = collections.namedtuple("GatherTile", "rn ch warps slots tn seg pitch ring")


def gather_tile(ncand: int) -> GatherTile:
    """K12b's tile from `csrc/probes.cu`'s `GATHER_*` defines: `rn`
    consecutive n and ch / 32 4-channel chunks (q, q + 8, ... of a column's
    ch / 4) a thread, 8 lanes along q by `slots` n slots a warp, `warps`
    warps a block (`tn` columns of a row by `ch` channels); a staged row
    holds `seg` = tn + ncand - 1 columns in `pitch` (rounded up to 8), in a
    `ring` of ncand + 1 rows."""
    define = functools.partial(_build.source_define, SOURCE)
    rn, ch, warps = (define(f"GATHER_{k}") for k in ("RN", "CH", "WARPS"))
    slots = 4
    tn = warps * slots * rn
    seg = tn + ncand - 1
    return GatherTile(rn, ch, warps, slots, tn, seg, -(-seg // 8) * 8, ncand + 1)


def gather_smem(ncand: int) -> int:
    """K12b's shared memory a block (`gather_smem` in `csrc/probes.cu`): the
    ring of staged rows, the rep table (`GATHER_RC` reps of int2) and dy, dx
    of two rows."""
    t = gather_tile(ncand)
    rc = _build.source_define(SOURCE, "GATHER_RC")
    return (t.ring * t.pitch * t.ch + 2 * rc * t.tn + 4 * t.tn) * 4


def corner_gather_tiled(u, dy, dx, ncand: int, Wp: int, reps: int):
    """K12b's index arithmetic on the CPU, in the kernel's order, for every
    strip of `tn` columns x0 .. of the rows of width Wp (n = y·Wp + x), every
    channel tile and every row y: the ring of staged rows as row y finds it
    (band row y + J in slot (y + J) mod ring, its column t at s = slot·pitch
    + t, 4-channel chunk h at chunk h ^ (s & 7); the slot being refilled,
    columns past `seg`, past the array and channels past C are NaN, which no
    stored output may read: the kernel leaves the first two unwritten or in
    flight and zero-fills the others), each thread's n and channel chunks,
    per rep each n's index, weights and staged column, its four corners
    from the ring or, where a corner pair leaves it, from u, the
    multiply-adds, and the stores. Returns (out (C, N), how often each
    output was stored)."""
    C, N = _band_shapes("corner_gather", u, dy, dx, ncand, Wp)
    NW = u.shape[1]
    t = gather_tile(ncand)
    lo, R = (ncand - 1) // 2, t.ring
    gx, gr, gy = -(-Wp // t.tn), -(-N // Wp), -(-C // t.ch)
    nan = torch.tensor(float("nan"))
    x0 = (torch.arange(gx) * t.tn)[:, None, None, None]                         # (gx, 1, 1, 1)
    y = torch.arange(gr)[:, None, None]                                          # (gr, 1, 1)
    sl, tc = torch.arange(R)[:, None], torch.arange(t.pitch)
    J = (sl - y) % R                                                             # (gr, R, 1)
    col = (y + J) * Wp + x0 + lo + tc                                            # (gx, gr, R, pitch)
    ch = torch.arange(gy)[:, None] * t.ch + torch.arange(t.ch)                  # (gy, ch)
    val = u[ch.clamp(max=C - 1)][:, :, col.clamp(0, NW - 1)]                    # (gy, ch, gx, gr, R, pitch)
    ok = ((ch < C)[:, :, None, None, None, None] & (col < NW) & (J < ncand) & (tc < t.seg))
    val = torch.where(ok, val, nan).permute(0, 2, 3, 4, 5, 1)                   # (gy, gx, gr, R, pitch, ch)
    S = R * t.pitch
    val = val.reshape(gy, gx, gr, S, t.ch)
    s = torch.arange(S)
    h, k = torch.arange(t.ch // 4), torch.arange(4)
    word = (4 * (h[None, :, None] ^ (s[:, None, None] & 7)) + k).reshape(S, t.ch)
    smem = torch.full((gy, gx, gr, S, t.ch), float("nan"))
    smem.scatter_(-1, word.expand(gy, gx, gr, S, t.ch), val)
    # every thread (strip gx, row gr, warp w, slot sl; lane q): its x and n
    # (gx, gr, w, sl, rn)
    x = (x0[..., None] + (torch.arange(t.warps)[:, None, None] * t.slots
                          + torch.arange(t.slots)[:, None]) * t.rn + torch.arange(t.rn))
    yy = torch.arange(gr)[:, None, None, None]
    n = yy * Wp + x
    inn = (x < Wp) & (n < N)
    dyn = torch.where(inn, dy[n.clamp(max=N - 1)], torch.zeros(()))
    dxn = torch.where(inn, dx[n.clamp(max=N - 1)], torch.zeros(()))
    base = n + torch.floor(dxn).long() + 2 * lo
    fx = dxn - torch.floor(dxn)
    # lane q's chunks q, q + 8, ... (its cc channels 4 q + k, 32 + 4 q + k, ...)
    cc = t.ch // 8
    q = torch.arange(8)[:, None]
    hq = q + 8 * (torch.arange(cc) >> 2)
    kq = torch.arange(cc) & 3
    c = torch.arange(gy)[:, None, None] * t.ch + 4 * hq + kq                     # (gy, 8, cc)
    ix = (torch.arange(gy)[:, None, None, None, None, None, None, None],
          torch.arange(gx)[:, None, None, None, None, None, None],
          torch.arange(gr)[:, None, None, None, None, None])
    acc = torch.zeros((gy, gx, gr, t.warps, t.slots, t.rn, 8, cc), dtype=torch.float32)
    for r in range(reps):
        dyr = dyn + torch.tensor(r * 1e-6, dtype=torch.float32)
        jy = torch.floor(dyr)
        fy = dyr - jy
        Jc = jy.long() + lo
        idx = (base + Jc * Wp).clamp(0, NW - Wp - 2)
        tt = idx - (yy + Jc) * Wp - x0[..., None] - lo
        fast = (Jc >= 0) & (Jc + 1 < ncand) & (tt >= 0) & (tt + 1 < t.seg)
        zero = torch.zeros((), dtype=torch.long)
        rows = [torch.where(fast, (yy + Jc + d) % R, zero) for d in (0, 1)]
        tt = torch.where(fast, tt, zero)
        w = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
        for (sy, sx), wc in zip(((0, 0), (0, 1), (1, 0), (1, 1)), w):
            sc = (rows[sy] * t.pitch + tt + sx)[..., None, None]
            staged = smem[ix + (sc, 4 * (hq ^ (sc & 7)) + kq)]
            g = (idx + sy * Wp + sx)[..., None, None]
            ch_ = c[:, None, None, None, None, None]                              # (gy, 1, ..., 8, cc)
            glob = torch.where(ch_ < C, u[ch_.clamp(max=C - 1), g], torch.zeros(()))
            acc = acc + wc[..., None, None] * torch.where(fast[..., None, None], staged, glob)
    cs = c[:, None, None, None, None, None].expand(acc.shape)
    ns = n[None, ..., None, None].expand(acc.shape)
    keep = (cs < C) & inn[None, ..., None, None].expand(acc.shape)
    out = torch.zeros((C, N), dtype=torch.float32)
    stored = torch.zeros((C, N), dtype=torch.int32)
    out.index_put_((cs[keep], ns[keep]), acc[keep])
    stored.index_put_((cs[keep], ns[keep]), torch.ones((), dtype=torch.int32), accumulate=True)
    return out, stored

def corner_gather(u, dy, dx, ncand: int, Wp: int, reps: int) -> torch.Tensor:
    """K12b (module docstring): the arguments and result of `tent_band`."""
    if not u.is_cuda:
        corner_gather.plain_calls += 1
        return corner_gather_plain(u, dy, dx, ncand, Wp, reps)
    return _launch_band("corner_gather_f32", corner_gather, u, dy, dx, ncand, Wp, reps)


corner_gather.launches = 0
corner_gather.plain_calls = 0


def _launch_band(symbol, op, u, dy, dx, ncand, Wp, reps):
    C, N = _band_shapes(op.__name__, u, dy, dx, ncand, Wp)
    for t in (u, dy, dx):
        if t.device != u.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op.__name__}: contiguous f32 tensors on one device")
    if not 2 <= ncand <= 6 or Wp < 2 * ncand or reps < 1:
        raise ValueError(f"{op.__name__}: ncand 2..6, Wp >= 2*ncand, reps >= 1")
    out = torch.empty((C, N), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        _build.check(getattr(_lib(), symbol)(u.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                             out.data_ptr(), C, N, Wp, ncand, reps,
                                             _stream(u)), op.__name__)
    op.launches += 1
    return out


# ---------------------------------------------------------------------------
# K12c mma_probe
# ---------------------------------------------------------------------------

def mma_probe_plain(v, w, n_dots: int) -> torch.Tensor:
    """n_dots products vᵀ·w of f32 upcasts summed in f32, cast to bf16:
    `probe`'s body; (D, N) bf16."""
    prod = v.float().t() @ w.float()
    acc = torch.zeros_like(prod)
    for _ in range(n_dots):
        acc = acc + prod
    return acc.to(torch.bfloat16)


def _mma_shapes(op, v, w, n_dots, grid):
    K, N = w.shape
    if tuple(v.shape) != (K, D) or v.device != w.device:
        raise ValueError(f"{op.__name__}: v ({K}, {D}) and w ({K}, N) on one device")
    for t in (v, w):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op.__name__}: contiguous 16-byte aligned bf16 operands")
    if K % 16 or K < 16 or N % 64 or N > 256 or n_dots < 1 or grid < 1:
        raise ValueError(f"{op.__name__}: K a multiple of 16, N a multiple of 64 up to 256")
    return K, N


def _launch_mma(symbol, op, v, w, n_dots, grid, *extra):
    K, N = w.shape
    out = torch.empty((D, N), dtype=torch.bfloat16, device=v.device)
    with torch.cuda.device(v.device):
        _build.check(getattr(_lib(), symbol)(v.data_ptr(), w.data_ptr(), out.data_ptr(),
                                             K, N, n_dots, grid, *extra, _stream(v)),
                     op.__name__)
    op.launches += 1
    return out


def mma_probe(v, w, n_dots: int, grid: int = GRID, *, cluster: int = CLUSTER) -> torch.Tensor:
    """K12c (module docstring) on warpgroup products: v (K, 32), w (K, N)
    bf16 → (32, N) bf16. Where K streams, `cluster` blocks (1, 2 or 4,
    dividing grid) share each tile's TMA loads."""
    if not v.is_cuda:
        mma_probe.plain_calls += 1
        return mma_probe_plain(v, w, n_dots)
    _mma_shapes(mma_probe, v, w, n_dots, grid)
    if cluster not in (1, 2, 4) or grid % cluster:
        raise ValueError("mma_probe: a cluster of 1, 2 or 4 blocks that divides grid")
    return _launch_mma("mma_probe_bf16", mma_probe, v, w, n_dots, grid, cluster)


mma_probe.launches = 0
mma_probe.plain_calls = 0


def mma_probe_sync(v, w, n_dots: int, grid: int = GRID) -> torch.Tensor:
    """K12c on mma.sync (m16n8k16), the instruction K4 uses: the arguments
    and result of `mma_probe`."""
    if not v.is_cuda:
        mma_probe_sync.plain_calls += 1
        return mma_probe_plain(v, w, n_dots)
    K, N = _mma_shapes(mma_probe_sync, v, w, n_dots, grid)
    if not mma_sync_resident(K, N) and K % 64:
        raise ValueError("mma_probe_sync: a K that does not fit shared memory must be a "
                         "multiple of 64 (the streamed tile)")
    return _launch_mma("mma_probe_sync_bf16", mma_probe_sync, v, w, n_dots, grid)


mma_probe_sync.launches = 0
mma_probe_sync.plain_calls = 0


def mma_sync_resident(K: int, N: int) -> bool:
    """Whether the mma.sync form keeps v and w in shared memory for all dots
    (else K tiles stream from L2 for every dot): K·(32 + N + 16)·2 bytes <=
    227 KB, the rule of `mma_sync_smem` in `csrc/probes.cu`."""
    return K * (D + N + 16) * 2 <= 232448


WgmmaPlan = collections.namedtuple(
    "WgmmaPlan", "kt stages tiles resident slots tile v_tile w_box zero smem")


def wgmma_plan(K: int, N: int) -> WgmmaPlan:
    """The wgmma form's shared memory (`wg_smem`, `mma_probe_wgmma_kernel`),
    in bytes from the 1024-aligned base: `slots` K tiles of `kt` = min(K,
    MMA_KT) rows, each `tile` bytes (v twice, `v_tile` bytes a copy, then
    N / 64 boxes of w, `w_box` bytes each), the zero tile at `zero`, `smem`
    in all (at least the epilogue's 8 KB a 64 columns). Resident (every
    tile loaded once) where that fits `MMA_SMEM_DATA`, else a ring of
    `stages` slots."""
    define = functools.partial(_build.source_define, SOURCE)
    kt, stages = min(K, define("MMA_KT")), define("MMA_STAGES")
    v_tile, w_box = kt * 64, kt * 128
    tile = 2 * v_tile + N // 64 * w_box
    tiles = -(-K // kt)
    resident = tiles * tile + v_tile <= define("MMA_SMEM_DATA")
    slots = tiles if resident else stages
    return WgmmaPlan(kt, stages, tiles, resident, slots, tile, v_tile, w_box, slots * tile,
                     max(slots * tile + v_tile, 8192 * N // 64))


def mma_probe_resident(K: int, N: int) -> bool:
    """Whether `mma_probe` (the wgmma form) loads its K tiles once, or
    streams them from L2 for every pass: `wgmma_plan(K, N).resident`."""
    return wgmma_plan(K, N).resident


def swizzle(addr, atom_bytes: int):
    """A shared-memory byte address under the 128- or 64-byte swizzle (TMA's
    and wgmma's alike): bits 7.. of the address, 3 or 2 of them, XOR its
    16-byte chunk index."""
    bits = {128: 3, 64: 2}[atom_bytes]
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def tma_box(dst: int, rows: int, atom_bytes: int):
    """Where a TMA box of `rows` rows of `atom_bytes` bytes (bf16), loaded
    with the same swizzle at `dst` (1024-aligned), puts element (r, e):
    byte addresses (rows, atom_bytes // 2)."""
    r = torch.arange(rows)[:, None]
    e = torch.arange(atom_bytes // 2)
    return swizzle(dst + r * atom_bytes + 2 * e, atom_bytes)


def wgmma_desc(addr: int, lbo: int, sbo: int, atom_bytes: int) -> int:
    """`wg_desc`: the 64-bit shared-memory matrix descriptor."""
    layout = {128: 1, 64: 2}[atom_bytes]
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | (((sbo >> 4) & 0x3FFF) << 32) | (layout << 62))


def wgmma_walk(desc: int, mn: int):
    """The byte addresses an MN-major bf16 operand of a k16 product is read
    from, by the descriptor's fields: element (i, k), i < mn along M or N,
    k < 16, at start + core-matrix column (i mod atom) + atom (i // atom) ·
    leading offset + row (k mod 8) · atom bytes + (k // 8) · stride offset,
    then swizzled. Returns (mn, 16) addresses."""
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    atom_bytes = {1: 128, 2: 64}[desc >> 62]
    atom = atom_bytes // 2
    i = torch.arange(mn)[:, None]
    k = torch.arange(16)
    return swizzle(start + (i % atom) * 2 + (i // atom) * lbo + (k % 8) * atom_bytes
                   + (k // 8) * sbo, atom_bytes)


def wgmma_load(smem, v, w, plan: WgmmaPlan, slot: int, t: int):
    """The TMA boxes of K tile t into the slot at byte `slot` of `smem`
    (bf16 values as f32, by byte address // 2): v's rows twice (64-byte
    swizzle), w's as N / 64 boxes of 64 columns (128-byte swizzle); rows
    past K read as zero."""
    K, N = w.shape
    rows = t * plan.kt + torch.arange(plan.kt)
    live = (rows < K)[:, None]
    vt = torch.where(live, v.float()[rows.clamp(max=K - 1)], torch.zeros(()))
    wt = torch.where(live, w.float()[rows.clamp(max=K - 1)], torch.zeros(()))
    for copy in range(2):
        smem[tma_box(slot + copy * plan.v_tile, plan.kt, 64) // 2] = vt
    for b in range(N // 64):
        smem[tma_box(slot + 2 * plan.v_tile + b * plan.w_box, plan.kt, 128) // 2] = \
            wt[:, 64 * b:64 * b + 64]


def wgmma_step(plan: WgmmaPlan, slot: int, k: int, odd: bool, N: int):
    """The descriptors of the kernel's k16 step k of the tile in `slot`: A
    (v's copies, or v and the zero tile where `odd`) and B (w's boxes)."""
    lbo_a = plan.zero - slot if odd else plan.v_tile
    return (wgmma_desc(slot + 1024 * k, lbo_a, 512, 64),
            wgmma_desc(slot + 2 * plan.v_tile + 2048 * k, plan.w_box, 1024, 128))


def mma_probe_staged(v, w, n_dots: int):
    """The wgmma form's arithmetic on the CPU, in the kernel's order: tiles
    loaded into their slots as TMA writes them (slots NaN before, the zero
    tile zero), every pass's k16 products read through the descriptors'
    walk (A 64 × 16, B 16 × N) and summed in f32, rows 32-63 added onto rows
    0-31, the bf16 store. Returns (out (32, N) bf16, how often each
    shared-memory element was read, by byte address // 2)."""
    K, N = w.shape
    plan = wgmma_plan(K, N)
    smem = torch.full((plan.smem // 2,), float("nan"))
    smem[plan.zero // 2:(plan.zero + plan.v_tile) // 2] = 0.0
    reads = torch.zeros(plan.smem // 2, dtype=torch.int64)
    acc = torch.zeros((64, N), dtype=torch.float32)
    passes = -(-n_dots // 2)
    for i in range(passes * plan.tiles):
        t = i % plan.tiles
        slot = (t if plan.resident else i % plan.stages) * plan.tile
        if not plan.resident or i < plan.tiles:
            wgmma_load(smem, v, w, plan, slot, t)
        odd = n_dots % 2 == 1 and i // plan.tiles == passes - 1
        # every tile's kt / 16 steps: the last tile's rows past K are zero
        for k in range(plan.kt // 16):
            da, db = wgmma_step(plan, slot, k, odd, N)
            a, b = wgmma_walk(da, 64) // 2, wgmma_walk(db, N) // 2
            reads += torch.bincount(torch.cat([a.flatten(), b.flatten()]),
                                    minlength=plan.smem // 2)
            acc = acc + smem[a] @ smem[b].t()
    return (acc[:32] + acc[32:]).to(torch.bfloat16), reads
