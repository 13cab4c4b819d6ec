"""The windowed backward of K5 and K7 on the CPU, f32: the plain versions that
repeat the kernels' tiles, boxes, capacity, overflow and flush
(`msda_rows_bwd_windowed_plain`, `msda_temporal_bwd_windowed_plain`) against
the plain backward and against the JAX package's `_bwd_kernel_rows` and
`_bwd_kernel_rows_temporal` (the VJPs of the Pallas rows ops, interpret mode),
at 1e-5 of the reference's largest magnitude; the capacity plan; and the DCN
route's query grid."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_tpu.ops.ms_deform_attn_pallas import (ms_deform_attn_rows,
                                                 ms_deform_attn_rows_temporal)
from devis_torch.ops import deform_conv as dc
from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.ms_deform_attn import rule_window

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_train_ops import jit_vjp

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
GRID = (7, 18)                        # the DCN route's query grid: 126 pixels
DCN_SHAPES = (GRID,) * 9
Q_PAD = 128
RULES = [("all",), ("window", (-1, 1))]
REL = 1e-5                            # f32 on both sides, sums in other orders


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err, np.abs(want).max())


def _rows(x):
    """Port layout (B, Q, M, Lx, P) → the JAX rows layout (B*M, Lx*P, q_pad)."""
    B, Q, M, Lx, P = x.shape
    r = jnp.transpose(x, (0, 2, 3, 4, 1)).reshape(B * M, Lx * P, Q)
    return jnp.pad(r, ((0, 0), (0, 0), (0, Q_PAD - Q)))


def _jax_grads(fn, value, loc, att, cot, Q):
    """The JAX VJP of a Pallas rows op at (value, loc, att); padded queries
    sample outside the map. Jitted: the interpret-mode kernels then run as
    one XLA program instead of op by op (the same gradients, 3-4x sooner)."""
    def f(v, l, a):
        lx = _rows(l[..., 0]).at[:, :, Q:].set(-10.0)
        ly = _rows(l[..., 1]).at[:, :, Q:].set(-10.0)
        return fn(v, lx, ly, _rows(a))
    _, grads = jit_vjp(f, (value, loc, att), cot)
    return [np.asarray(g) for g in grads]


def _dcn_loc(rng, B, px=1.5):
    """The DCN route's locations (`deform_conv2d_rows`): every pixel of GRID
    shifted by its kernel position and an offset of N(0, px) pixels, some off
    the map, as 9 one-point levels of one head."""
    h, w = GRID
    ys, xs = np.mgrid[0:h, 0:w].reshape(2, -1).astype(np.float32)
    k = np.arange(9)
    off = rng.randn(B, h * w, 9, 2).astype(np.float32) * px
    lx = (xs[None, :, None] + (k % 3 - 1) + off[..., 1] + 0.5) / w
    ly = (ys[None, :, None] + (k // 3 - 1) + off[..., 0] + 0.5) / h
    return np.stack([lx, ly], -1).reshape(B, h * w, 1, 9, 1, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rows_case(D, route):
    """Seeded inputs and the JAX gradients of single-frame attention: at
    random locations over SHAPES (M = 2, P = 2, Q = 100), or on the DCN
    route's grid (M = 1, P = 1, 9 levels)."""
    rng = np.random.RandomState(D)
    if route == "dcn":
        shapes, B, M = DCN_SHAPES, 2, 1
        loc = _dcn_loc(rng, B)
        Q = loc.shape[1]
    else:
        shapes, B, Q, M = SHAPES, 2, 100, 2
        loc = (rng.rand(B, Q, M, L, 2, 2) * 1.4 - 0.2).astype(np.float32)
    value = rng.randn(B, sum(h * w for h, w in shapes), M, D).astype(np.float32)
    att = rng.rand(*loc.shape[:-1]).astype(np.float32)
    cot = rng.randn(B, Q, M * D).astype(np.float32)
    want = _jax_grads(lambda v, lx, ly, a: ms_deform_attn_rows(v, shapes, lx, ly, a, Q),
                      value, loc, att, cot, Q)
    return shapes, (value, loc, att, cot), want


@pytest.mark.parametrize("tiles", ["raster", "grid"])
@pytest.mark.parametrize("plan", ["fitted", "overflow"])
@pytest.mark.parametrize("D", [1, 5, 16, 32, 72])
def test_windowed_rows_bwd_matches_plain_and_jax(D, plan, tiles):
    """K7's windowed plain version in raster blocks and in 2-D tiles of the
    DCN route's query grid, with a plan that holds every window and one of 6
    rows (most corners add past the capacity): the plain backward's and the
    JAX `_bwd_kernel_rows`'s gradients, and the adds it counts."""
    route = "dcn" if tiles == "grid" else "attn"
    shapes, arrays, want = _rows_case(D, route)
    value, loc, att, cot = (torch.from_numpy(a) for a in arrays)
    grid = GRID if tiles == "grid" else None
    p = K.bwd_plan(shapes, torch.float32, D, loc.shape[4], grid)
    p = p._replace(cap=6) if plan == "overflow" else p
    assert (p.tile is None) == (grid is None)
    assert -(-D // p.slice) == (2 if D == 72 else 1)
    *got, adds = K.msda_rows_bwd_windowed_plain(value, shapes, loc, att, cot, p, grid)
    plain = K.msda_rows_bwd_plain(value, shapes, loc, att, cot)
    for name, g, pl, w in zip(("value", "loc", "att"), got, plain, want):
        _close(g, pl, f"grad {name} vs plain")
        _close(g, w, f"grad {name} vs JAX")
    # every live in-level corner adds D values: staged ones once per row at
    # the flush, the others where they lie
    live = K.msda_rows_bwd_windowed_plain(value, shapes, loc, att, cot,
                                          p._replace(cap=0), grid)[3]
    assert live[0] == 0 and 0 < adds[0] + adds[1] <= live[1]
    assert (adds[1] > 0) == (plan == "overflow")
    assert adds[0] > 0


@functools.lru_cache(maxsize=None)
def _temporal_case(rule):
    rng = np.random.RandomState(7)
    T, Q, M, D, P = 3, 40, 2, 16, 2
    Lf = (1 + rule_window(rule, T)) * L
    value = rng.randn(T, S, M, D).astype(np.float32)
    loc = (rng.rand(T, Q, M, Lf, P, 2) * 1.4 - 0.2).astype(np.float32)
    att = rng.rand(T, Q, M, Lf, P).astype(np.float32)
    cot = rng.randn(T, Q, M * D).astype(np.float32)
    want = _jax_grads(
        lambda v, lx, ly, a: ms_deform_attn_rows_temporal(v, SHAPES, lx, ly, a, Q, rule),
        value, loc, att, cot, Q)
    return (value, loc, att, cot), want


@pytest.mark.parametrize("plan", ["fitted", "overflow"])
@pytest.mark.parametrize("rule", RULES)
def test_windowed_temporal_bwd_matches_plain_and_jax(rule, plan):
    """K5's windowed plain version under both frame rules (every other frame;
    offsets with edge reflection): the plain backward's and the JAX
    `_bwd_kernel_rows_temporal`'s gradients."""
    arrays, want = _temporal_case(rule)
    value, loc, att, cot = (torch.from_numpy(a) for a in arrays)
    p = K.bwd_plan(SHAPES, torch.float32, 16, 2)
    p = p._replace(cap=8) if plan == "overflow" else p
    *got, adds = K.msda_temporal_bwd_windowed_plain(value, SHAPES, loc, att, cot, rule, p)
    plain = K.msda_temporal_bwd_plain(value, SHAPES, loc, att, cot, rule)
    for name, g, pl, w in zip(("value", "loc", "att"), got, plain, want):
        _close(g, pl, f"grad {name} vs plain")
        _close(g, w, f"grad {name} vs JAX")
    assert adds[0] > 0 and (adds[1] > 0) == (plan == "overflow")


def test_windowed_temporal_bwd_reads_the_rule_s_frames():
    """A frame slot's adds land on the frame its rule names: with the output
    gradient of frame 0's queries alone nonzero, frame 2 (which no slot of
    frame 0 names) gets none, and the windowed version agrees row for row."""
    arrays, _ = _temporal_case(("window", (-1, 1)))
    value, loc, att, cot = (torch.from_numpy(a) for a in arrays)
    cot[1:] = 0.0
    got = K.msda_temporal_bwd_windowed_plain(value, SHAPES, loc, att, cot, ("window", (-1, 1)))
    want = K.msda_temporal_bwd_plain(value, SHAPES, loc, att, cot, ("window", (-1, 1)))
    assert got[0][2].abs().max() == 0 and want[0][2].abs().max() == 0   # frame 2: no slot of 0
    _close(got[0], want[0], "grad value")


def test_windowed_bwd_on_the_lines_x_and_y_minus_one():
    """Taps exactly on x = -1 and y = -1 keep their one-sided location
    gradient; their in-level corners (weight 0) are flushed like any other."""
    shapes, arrays, _ = _rows_case(16, "attn")
    value, loc, att, cot = (torch.from_numpy(a).clone() for a in arrays)
    for lvl, (h, w) in enumerate(SHAPES):
        loc[:, :, :, lvl, 0, 0] = -0.5 / w
        loc[:, :, :, lvl, 1, 1] = -0.5 / h
    got = K.msda_rows_bwd_windowed_plain(value, SHAPES, loc, att, cot)
    want = K.msda_rows_bwd_plain(value, SHAPES, loc, att, cot)
    assert want[1][..., :2, :].abs().amax() > 0
    for g, w in zip(got[:3], want):
        _close(g, w, "grads")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,D,P,grid", [
    (((48, 80), (24, 40), (12, 20), (6, 10)), 32, 4, None),       # the clip encoder
    (((104, 168), (52, 84), (26, 42), (13, 21)), 32, 4, None),    # the image encoder
    (((26, 42),) * 9, 264, 1, (26, 42)),                          # lay1 of the image
    (((96, 160),) * 9, 16, 1, (96, 160)),                         # lay5 of the clip
    (((208, 336),) * 9, 1, 1, (208, 336)),                        # out_lay of the image
    (((12, 20),) * 9, 128, 1, (12, 20)),
])
def test_bwd_plan_fits_shared_memory(dtype, shapes, D, P, grid):
    """The default plan: bytes as the kernel lays them out, within 227 KB
    and within half an SM's 228 KB (two blocks an SM); the channel slice a
    multiple of 16 bytes of channels, lanes enough for it; the window rows
    at most the largest level."""
    p = K.bwd_plan(shapes, dtype, D, P, grid)
    vec = 16 // (torch.finfo(dtype).bits // 8)
    assert p.smem == K.bwd_smem_bytes(p.qb, P, p.cap, p.pitch, vec)
    assert p.smem <= K.SMEM_PER_SM // 2 - K.SMEM_RESERVED <= K.SMEM_PER_BLOCK
    assert p.slice == D or p.slice % vec == 0
    assert p.slice <= K.BWD_MAX_SLICE and p.lanes * vec >= p.slice
    assert p.pitch % vec == 0 and p.slice <= p.pitch < p.slice + vec
    assert 0 < p.cap <= max(h * w for h, w in shapes)
    assert (p.tile is None) == (grid is None) and (grid is None or p.tile[0] * p.tile[1] == p.qb)


def test_bwd_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        K.bwd_plan(SHAPES, torch.float32, 32, 64)          # 128 x 64 taps: 256 KB
    with pytest.raises(ValueError, match="shared memory"):
        K.bwd_plan(((8, 8),), torch.bfloat16, 1, 40)       # 512 x 40 taps


def test_deform_conv2d_rows_passes_its_query_grid(monkeypatch):
    """The DCN route hands `msda_rows` its pixel grid (K7's 2-D tiles on the
    card); with or without it the CPU gradients are the same."""
    rng = np.random.RandomState(3)
    B, cin, cout, (h, w) = 2, 8, 6, GRID
    fan = np.sqrt(9 * cin)
    a = [rng.randn(B, cin, h, w), rng.randn(B, 18, h, w) * 1.5, rng.rand(B, 9, h, w) * 2,
         rng.randn(3, 3, cin, cout) / fan, rng.randn(cout)]
    cot = torch.from_numpy(rng.randn(B, cout, h, w).astype(np.float32))
    seen = []

    def run(keep_grid):
        def spy(value, shapes, loc, att, query_grid=None):
            seen.append(query_grid)
            return K.msda_rows(value, shapes, loc, att, query_grid if keep_grid else None)
        monkeypatch.setattr(dc, "msda_rows", spy)
        leaves = [torch.tensor(t, dtype=torch.float32, requires_grad=True) for t in a]
        out = dc.deform_conv2d_rows(*leaves)
        return torch.autograd.grad(out, leaves, cot)

    with_grid, without = run(True), run(False)
    assert seen == [GRID, GRID]
    for g, w in zip(with_grid, without):
        assert torch.equal(g, w)
    # and the windowed K7 on the route's rows sums the same in tiles and rows
    shapes, arrays, _ = _rows_case(16, "dcn")
    value, loc, att, cot = (torch.from_numpy(t) for t in arrays)
    tiled = K.msda_rows_bwd_windowed_plain(value, shapes, loc, att, cot, query_grid=GRID)
    raster = K.msda_rows_bwd_windowed_plain(value, shapes, loc, att, cot)
    for g, w in zip(tiled[:3], raster[:3]):
        _close(g, w, "tiles against raster blocks")
