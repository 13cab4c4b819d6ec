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
                           `grid` blocks that each store the same tile

Each wrapper runs its plain PyTorch version (``*_plain``, the arithmetic of
the JAX kernel) on CPU tensors and launches its kernel on CUDA tensors, or
raises; `launches` and `plain_calls` count the two.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

GRID = 912      # the TPU probe's grid: 48 x 19 steps of the encoder op
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
        lib.mma_probe_bf16.argtypes = [P, P, P, I, I, I, I, P]
        lib.mma_probe_bf16.restype = I
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


def mma_probe(v, w, n_dots: int, grid: int = GRID) -> torch.Tensor:
    """K12c (module docstring): v (K, 32), w (K, N) bf16 → (32, N) bf16."""
    if not v.is_cuda:
        mma_probe.plain_calls += 1
        return mma_probe_plain(v, w, n_dots)
    K, N = w.shape
    if tuple(v.shape) != (K, D) or v.device != w.device:
        raise ValueError(f"mma_probe: v ({K}, {D}) and w ({K}, N) on one device")
    for t in (v, w):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("mma_probe: contiguous bf16 operands")
    if K % 16 or N % 64 or N > 256 or n_dots < 1 or grid < 1:
        raise ValueError("mma_probe: K a multiple of 16, N a multiple of 64 up to 256")
    if not mma_probe_resident(K, N) and K % 64:
        raise ValueError("mma_probe: a K that does not fit shared memory must be a "
                         "multiple of 64 (the streamed tile)")
    out = torch.empty((D, N), dtype=torch.bfloat16, device=v.device)
    with torch.cuda.device(v.device):
        _build.check(_lib().mma_probe_bf16(v.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           K, N, n_dots, grid, _stream(v)), "mma_probe")
    mma_probe.launches += 1
    return out


mma_probe.launches = 0
mma_probe.plain_calls = 0


def mma_probe_resident(K: int, N: int) -> bool:
    """Whether v and w stay in shared memory for all dots (else K tiles
    stream from L2 for every dot): K·(32 + N + 16)·2 bytes <= 227 KB, the
    rule of `mma_smem` in `csrc/probes.cu`."""
    return K * (D + N + 16) * 2 <= 232448
