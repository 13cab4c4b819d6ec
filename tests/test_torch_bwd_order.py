"""The backward of K5 and K7 in the kernels' fixed order, on the CPU, f32:
`msda_bwd_mirror` (the corners' entries, the stable radix sort by value row,
one warp's sums a row, the taps' gradients from their dots; csrc/msda_bwd.cuh)
against the plain backward at 1e-6 of its largest magnitude and against the
JAX package's `_bwd_kernel_rows` and `_bwd_kernel_rows_temporal` (the VJPs of
the Pallas rows ops, interpret mode) at 1e-5 (sums in other orders); the same
bits whatever order the sort's tiles and the gather's rows run in; the sort's
plan and scratch at the paths' shapes. The run-wise route (each run of one
(head, stage, query frame) sorted on its level's pixels, a row's runs walked
in run order: `_run_sort_mirror`, `_run_rows_mirror`, `run_walk_mirror`)
gives every row the global sort's entries in the same order and the same
split over the gather's lane groups, in one pass or two, whatever order the
runs are sorted in."""
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_tpu.ops.ms_deform_attn_pallas import (ms_deform_attn_rows,
                                                 ms_deform_attn_rows_temporal)
from devis_torch.ops import _build
from devis_torch.ops import deform_conv as dc
from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.ms_deform_attn import rule_window, temporal_frame_table

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_train_ops import jit_vjp

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
GRID = (7, 18)                        # the DCN route's query grid: 126 pixels
DCN_SHAPES = (GRID,) * 9
Q_PAD = 128
RULES = [("all",), ("window", (-1, 1))]
REL_PLAIN = 1e-6                      # f32 on both sides, sums in other orders
REL_JAX = 1e-5                        # the JAX kernels' MXU sums in f32


def _close(got, want, what, rel):
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
    one XLA program instead of op by op."""
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


def _orders(n_entries, n_rows, seed):
    """A shuffled order of the sort's tiles and of the gather's rows."""
    tiles = list(range(-(-n_entries // _build.source_define("msda_bwd.cuh", "BWD_TILE"))))
    random.Random(seed).shuffle(tiles)
    return tiles, torch.randperm(n_rows, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("order", ["in order", "shuffled"])
@pytest.mark.parametrize("route", ["attn", "dcn"])
@pytest.mark.parametrize("D", [1, 5, 16, 32, 72])
def test_rows_bwd_mirror_matches_plain_and_jax(D, route, order):
    """K7's order at random locations and on the DCN route's grid (several
    tiles of the sort each): the plain backward's and the JAX
    `_bwd_kernel_rows`'s gradients; with the tiles and rows shuffled, the
    same bits."""
    shapes, arrays, want = _rows_case(D, route)
    value, loc, att, cot = (torch.from_numpy(a) for a in arrays)
    got = K.msda_bwd_mirror(value, shapes, loc, att, cot)
    assert -(-4 * att.numel() // 4096) >= 3
    if order == "shuffled":
        tiles, rows = _orders(4 * att.numel(), value.shape[0] * value.shape[1] * value.shape[2],
                              D)
        again = K.msda_bwd_mirror(value, shapes, loc, att, cot, tile_order=tiles,
                                  row_order=rows)
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        return
    plain = K.msda_rows_bwd_plain(value, shapes, loc, att, cot)
    for name, g, pl, w in zip(("value", "loc", "att"), got, plain, want):
        _close(g, pl, f"grad {name} vs plain", REL_PLAIN)
        _close(g, w, f"grad {name} vs JAX", REL_JAX)


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


def _frames(rule, T):
    table = torch.as_tensor(temporal_frame_table(rule, T), dtype=torch.long)
    return torch.cat([torch.arange(T)[:, None], table], 1)


@pytest.mark.parametrize("order", ["in order", "shuffled"])
@pytest.mark.parametrize("rule", RULES)
def test_temporal_bwd_mirror_matches_plain_and_jax(rule, order):
    """K5's order under both frame rules (every other frame; offsets with
    edge reflection): the plain backward's and the JAX
    `_bwd_kernel_rows_temporal`'s gradients; shuffled, the same bits."""
    arrays, want = _temporal_case(rule)
    value, loc, att, cot = (torch.from_numpy(a) for a in arrays)
    frames = _frames(rule, value.shape[0])
    got = K.msda_bwd_mirror(value, SHAPES, loc, att, cot, frames)
    if order == "shuffled":
        tiles, rows = _orders(4 * att.numel(), value.shape[0] * S * value.shape[2], 3)
        assert len(tiles) >= 3
        again = K.msda_bwd_mirror(value, SHAPES, loc, att, cot, frames, tile_order=tiles,
                                  row_order=rows)
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        return
    plain = K.msda_temporal_bwd_plain(value, SHAPES, loc, att, cot, rule)
    for name, g, pl, w in zip(("value", "loc", "att"), got, plain, want):
        _close(g, pl, f"grad {name} vs plain", REL_PLAIN)
        _close(g, w, f"grad {name} vs JAX", REL_JAX)


def test_temporal_bwd_mirror_reads_the_rule_s_frames():
    """A frame slot's sums land on the frame its rule names: with the output
    gradient of frame 0's queries alone nonzero, frame 2 (which no slot of
    frame 0 names) gets none, and the mirror agrees row for row."""
    rule = ("window", (-1, 1))
    arrays, _ = _temporal_case(rule)
    value, loc, att, cot = (torch.from_numpy(a) for a in arrays)
    cot[1:] = 0.0
    got = K.msda_bwd_mirror(value, SHAPES, loc, att, cot, _frames(rule, 3))
    want = K.msda_temporal_bwd_plain(value, SHAPES, loc, att, cot, rule)
    assert got[0][2].abs().max() == 0 and want[0][2].abs().max() == 0
    _close(got[0], want[0], "grad value", REL_PLAIN)


def test_bwd_mirror_on_the_lines_x_and_y_minus_one():
    """Taps exactly on x = -1 and y = -1 keep their one-sided location
    gradient: their in-level corners (weight 0) still get entries and dots."""
    shapes, arrays, _ = _rows_case(16, "attn")
    value, loc, att, cot = (torch.from_numpy(a).clone() for a in arrays)
    for lvl, (h, w) in enumerate(SHAPES):
        loc[:, :, :, lvl, 0, 0] = -0.5 / w
        loc[:, :, :, lvl, 1, 1] = -0.5 / h
    got = K.msda_bwd_mirror(value, SHAPES, loc, att, cot)
    want = K.msda_rows_bwd_plain(value, SHAPES, loc, att, cot)
    assert want[1][..., :2, :].abs().amax() > 0
    for g, w in zip(got, want):
        _close(g, w, "grads", REL_PLAIN)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,entries,D", [
    (6 * 5100 * 8, 6 * 5100 * 8 * 24 * 4 * 4, 32),   # the clip encoder (K5)
    (6 * 5100 * 8, 6 * 10 * 8 * 24 * 4 * 4, 32),     # the clip decoder (K5)
    (2 * 22848 * 8, 2 * 22848 * 8 * 16 * 4, 32),     # the image encoder (K7)
    (50 * 9 * 1092, 50 * 1092 * 9 * 4, 264),         # lay1 of the image, 50 masks (K7)
    (50 * 9 * 69888, 50 * 69888 * 9 * 4, 16),        # lay5 of the image, 50 masks (K7)
    (2 * 22848 * 8, 2 * 300 * 8 * 16 * 4, 32),       # the image decoder (K9)
])
def test_bwd_sort_plan_and_gather_split_at_the_paths_shapes(dtype, rows, entries, D):
    """The sort: digits of at most 8 bits whose passes hold every key up to
    n_rows (the corners outside their level); the tiles' histograms within
    the one-block top scan; entries within int32. The gather: its lanes and
    chunks hold the row's D channels in one warp. The run-wise route where
    `bwd_route` takes it (K5 and K7 but the clip decoder's 160 entries a
    run and the image encoder's 64 runs; K9 has no runs): every pass within RUN_BINS bins a block and its
    counters within the shared memory of a block, the blocks, the tables and
    the entries within int32, and its scratch beside the global sort's."""
    passes, bits = K.bwd_sort_plan(rows)
    assert bits <= 8 and (rows >> (passes * bits)) == 0 and passes * bits < 32
    assert passes == -(-rows.bit_length() // 8)
    assert entries < 2 ** 31
    tiles = -(-entries // _build.source_define("msda_bwd.cuh", "BWD_TILE"))
    assert -(-256 * tiles // _build.source_define("msda_bwd.cuh", "BWD_SCAN_TILE")) <= \
        _build.source_define("msda_bwd.cuh", "BWD_SCAN_TOP")
    plan = K.taps_plan(D, dtype, True)
    assert plan.lanes * plan.per * plan.cw >= D and 32 % plan.lanes == 0
    runs = _PATH_RUNS.get((rows, entries))
    if runs is None:                                  # K9
        return
    shapes, Q, P, N, J, M, route = runs
    assert sum(h * w for h, w in shapes) * N * M == rows and 4 * Q * P * N * M * J * len(shapes) \
        == entries
    assert K.bwd_route(shapes, Q, P, N, J, M) == route
    if route < 0:
        return
    rp = K.run_plan(shapes, Q, P, N, J, M)
    bins_max = _build.source_define("msda_bwd.cuh", "RUN_BINS")
    for mode, blocks, bins, warps, smem in rp.passes():
        assert bins <= bins_max and warps * bins <= \
            _build.source_define("msda_bwd.cuh", "RUN_SMEM_INTS")
        assert smem + K.SMEM_RESERVED <= K.SMEM_PER_BLOCK and blocks < 2 ** 31
    assert rp.runs * rp.E == entries and rp.offs_size < 2 ** 31
    new, old = K.bwd_scratch_bytes(entries, rows, rp), K.bwd_scratch_bytes(entries, rows)
    assert new < 2 ** 31 * 4 * 8 and new <= 1.25 * old


# (spatial shapes, Q, P, N, J, M, route) of the run-wise route at the
# shapes above: the clip pyramid; for the image encoder a four-level pyramid
# of S 22 848 (COCO's at 800x1216 is 23 205); the mask heads' grids as 9
# one-point levels
_PATH_RUNS = {
    (6 * 5100 * 8, 6 * 5100 * 8 * 24 * 4 * 4):
        (((48, 80), (24, 40), (12, 20), (6, 10)), 5100, 4, 6, 6, 8, 0),
    (6 * 5100 * 8, 6 * 10 * 8 * 24 * 4 * 4):
        (((48, 80), (24, 40), (12, 20), (6, 10)), 10, 4, 6, 6, 8, -1),
    (2 * 22848 * 8, 2 * 22848 * 8 * 16 * 4):
        (((98, 175), (49, 88), (25, 44), (13, 22)), 22848, 4, 2, 1, 8, -1),
    (50 * 9 * 1092, 50 * 1092 * 9 * 4): (((26, 42),) * 9, 1092, 1, 50, 1, 1, 0),
    (50 * 9 * 69888, 50 * 69888 * 9 * 4): (((208, 336),) * 9, 69888, 1, 50, 1, 1, 0),
}


def test_bwd_sort_plan_small_and_the_scratch_limit():
    """One key bit still takes one pass; more entries than the top scan
    takes are refused before any launch."""
    assert K.bwd_sort_plan(1) == (1, 1)
    assert K.bwd_sort_plan(255) == (1, 8) and K.bwd_sort_plan(256) == (2, 5)
    with pytest.raises(ValueError, match="more than the scan takes"):
        K.bwd_scratch(2 ** 31, 10, "cpu")


def test_deform_conv2d_rows_gradients_through_the_plain_rows():
    """The DCN route (`deform_conv2d_rows`) differentiates through
    `msda_rows` on the CPU: its value, location and weight gradients are the
    plain K7's, which the mirror of the kernels' order matches."""
    rng = np.random.RandomState(3)
    B, cin, cout, (h, w) = 2, 8, 6, GRID
    fan = np.sqrt(9 * cin)
    a = [rng.randn(B, cin, h, w), rng.randn(B, 18, h, w) * 1.5, rng.rand(B, 9, h, w) * 2,
         rng.randn(3, 3, cin, cout) / fan, rng.randn(cout)]
    cot = torch.from_numpy(rng.randn(B, cout, h, w).astype(np.float32))
    leaves = [torch.tensor(t, dtype=torch.float32, requires_grad=True) for t in a]
    before = K.msda_rows.plain_calls
    out = dc.deform_conv2d_rows(*leaves)
    grads = torch.autograd.grad(out, leaves, cot)
    assert K.msda_rows.plain_calls == before + 1
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    shapes, arrays, _ = _rows_case(16, "dcn")
    value, loc, att, cot = (torch.from_numpy(t) for t in arrays)
    for g, p in zip(K.msda_bwd_mirror(value, shapes, loc, att, cot),
                    K.msda_rows_bwd_plain(value, shapes, loc, att, cot)):
        _close(g, p, "the DCN route's rows", REL_PLAIN)


# ---------------------------------------------------------------------------
# The run-wise route of K5 and K7
# ---------------------------------------------------------------------------

def _run_case(case):
    """(spatial shapes, value, loc, att, cot, frames) of one run-wise case:
    K5 under the `all` rule and under a window rule that repeats frame 1 at
    both edges of a 3-frame clip; K7 at random locations (dead taps and
    corners outside their level among them), with runs of more than one
    global sort tile; the DCN route's grid."""
    rng = np.random.RandomState(11)
    if case.startswith("K5"):
        rule = ("all",) if case == "K5 all" else ("window", (-1, 1))
        T, Q, M, D, P = 3, 40, 2, 4, 2
        Lf = (1 + rule_window(rule, T)) * L
        loc = (rng.rand(T, Q, M, Lf, P, 2) * 1.4 - 0.2).astype(np.float32)
        shapes, B, frames = SHAPES, T, _frames(rule, T)
    elif case == "K7 dcn":
        shapes, B, M, D = DCN_SHAPES, 2, 1, 4
        loc, frames = _dcn_loc(rng, B), None
    else:
        shapes, B, Q, M, D = SHAPES, 2, 600, 1, 4
        loc = (rng.rand(B, Q, M, L, 2, 2) * 1.4 - 0.2).astype(np.float32)
        frames = None
    Sv = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(B, Sv, M, D).astype(np.float32))
    att = torch.from_numpy(rng.rand(*loc.shape[:-1]).astype(np.float32))
    cot = torch.from_numpy(rng.randn(B, loc.shape[1], M * D).astype(np.float32))
    return shapes, value, torch.from_numpy(loc), att, cot, frames


RUN_CASES = ["K5 all", "K5 window", "K7 attn", "K7 dcn"]


@pytest.mark.parametrize("bucket", [0, 100, 7])
@pytest.mark.parametrize("case", RUN_CASES)
def test_run_sort_mirror_gives_the_global_sort_s_rows(case, bucket):
    """Every value row's entries, in the order the run-wise gather walks
    them (its frame's runs in run order, each run's segment at the row's
    pixel), are the global stable sort's, and so is each lane group's share
    at every `gpr`; in one pass (RUN_BUCKET: these runs are short) or two
    (buckets of about 100 or 7 entries), with the runs sorted in a shuffled
    order. The dead corners are in no row."""
    shapes, value, loc, att, cot, frames = _run_case(case)
    F, S_v, M, _ = value.shape
    N, Q, _, Lx, P, _ = loc.shape
    frames = torch.arange(N)[:, None] if frames is None else frames
    n_rows = F * S_v * M
    keys, _, _ = K._tap_entries(shapes, loc, att, frames, S_v, M, n_rows)
    g_keys, g_order = K._radix_sort_mirror(keys, n_rows)
    plan = K.run_plan(shapes, Q, P, N, Lx // len(shapes), M, bucket)
    assert plan.two == (bucket > 0 or plan.E > _build.source_define("msda_bwd.cuh", "RUN_BUCKET"))
    if case == "K7 attn":
        assert plan.E > _build.source_define("msda_bwd.cuh", "BWD_TILE")
    local = K.local_keys(keys, shapes, frames, S_v, M, n_rows)
    assert (local == K.RUN_DEAD).sum() == (keys == n_rows).sum() > 0
    runs = list(range(plan.runs))
    random.Random(bucket).shuffle(runs)
    ids, offs = K._run_sort_mirror(local, plan, run_order=runs)
    again = K._run_sort_mirror(local, plan)
    assert torch.equal(ids, again[0]) and torch.equal(offs, again[1])
    feeds = K.run_feeds(frames, F)
    r_keys, r_order = K._run_rows_mirror(ids, offs, plan, feeds, shapes, S_v, n_rows)
    assert torch.equal(r_keys, g_keys) and torch.equal(r_order, g_order)
    live = g_keys < n_rows
    begin = torch.searchsorted(g_keys[live], torch.arange(n_rows))
    end = torch.searchsorted(g_keys[live], torch.arange(n_rows), right=True)
    for gpr in (1, 2, 8):
        for row in torch.randperm(n_rows, generator=torch.Generator().manual_seed(gpr))[:60]:
            seg = g_order[live][begin[row]:end[row]]
            walk = K.run_walk_mirror(ids, offs, plan, feeds, shapes, S_v, int(row), gpr)
            assert walk == [seg[j::gpr].tolist() for j in range(gpr)]


@pytest.mark.parametrize("case", RUN_CASES)
def test_bwd_mirror_run_wise_equals_the_global_sort_s_bits(case):
    """The whole backward through the run-wise route (one pass and two, the
    runs shuffled) equals the global sort's bit for bit."""
    shapes, value, loc, att, cot, frames = _run_case(case)
    want = K.msda_bwd_mirror(value, shapes, loc, att, cot, frames)
    runs = list(range(value.shape[2] * loc.shape[3] * loc.shape[0]))
    random.Random(3).shuffle(runs)
    for bucket in (0, 9):
        got = K.msda_bwd_mirror(value, shapes, loc, att, cot, frames, sort=bucket,
                                run_order=runs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_run_feeds_list_a_frame_s_runs_in_run_order():
    """A value frame's runs (frame slot j of query frame n, items j * N + n)
    in run order: under `all` one per query frame; under a window rule that
    repeats frame 1 at both edges of a 3-frame clip, frame 1 five times (the
    current slot of query frame 1, both slots of query frames 0 and 2), in
    slot order, then query frame order."""
    ptr, feed = K.run_feeds(_frames(("all",), 6), 6)
    assert torch.equal(ptr, torch.arange(0, 37, 6, dtype=torch.int32))
    assert all((feed[6 * f:6 * f + 6].diff() > 0).all() for f in range(6))
    ptr, feed = K.run_feeds(_frames(("window", (-1, 1)), 3), 3)
    N = 3
    assert ptr.tolist() == [0, 2, 7, 9]
    assert [(int(i) // N, int(i) % N) for i in feed[2:7]] == [(0, 1), (1, 0), (1, 2), (2, 0),
                                                               (2, 2)]
