"""The probes K12a-K12c (`devis_torch/ops/probes.py`) against the JAX
package's micro-benchmarks, on the CPU: the plain versions of K12a and K12b
against `benchmarks/bench_tent_gather.py`'s `_tent_kernel` and
`_gather_kernel` run through `pl.pallas_call(..., interpret=True)`, and
K12c's against `benchmarks/mxu_probe.py`'s body through XLA. The kernels'
index arithmetic and shared-memory layouts are mirrored on the CPU
(`tent_band_tiled`, `corner_gather_tiled`, `mma_probe_staged` and the wgmma
descriptors' walk) and held to the plain versions here; the kernels
themselves are held to the plain versions on the card
(`tests/test_torch_kernels_cuda.py`)."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from devis_torch.ops import probes

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, WP, NCAND, REPS = 4, 16, 4, 2
N = 4 * WP


def _bench_tent_gather():
    """The JAX script, imported by path (it does nothing at import)."""
    path = os.path.join(ROOT, "benchmarks", "bench_tent_gather.py")
    spec = importlib.util.spec_from_file_location("bench_tent_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _band_inputs(seed):
    rs = np.random.RandomState(seed)
    u = rs.rand(C, N + NCAND * WP).astype(np.float32)
    dy = (rs.rand(N) * 2 - 1).astype(np.float32)
    dx = (rs.rand(N) * 2 - 1).astype(np.float32)
    return u, dy, dx


def _pallas(kernel, u, dy, dx):
    f = pl.pallas_call(functools.partial(kernel, ncand=NCAND, Wp=WP, N=N, reps=REPS),
                       out_shape=jax.ShapeDtypeStruct((C, N), jnp.float32), interpret=True)
    return np.asarray(f(jnp.asarray(u), jnp.asarray(dy[None]), jnp.asarray(dx[None])))


def _close(got, want, rel):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= rel * np.abs(np.asarray(want, np.float64)).max(), err


@pytest.mark.parametrize("name", ["tent_band", "corner_gather"])
def test_band_plain_matches_the_pallas_kernel(name):
    """f32 on both sides; XLA may fuse multiply-adds the plain version
    rounds twice: 1e-5 of max|ref|."""
    mod = _bench_tent_gather()
    kernel = {"tent_band": mod._tent_kernel, "corner_gather": mod._gather_kernel}[name]
    u, dy, dx = _band_inputs(0)
    want = _pallas(kernel, u, dy, dx)
    op = getattr(probes, name)
    before = op.plain_calls
    got = op(torch.from_numpy(u), torch.from_numpy(dy), torch.from_numpy(dx), NCAND, WP, REPS)
    assert op.plain_calls == before + 1 and got.shape == (C, N)
    _close(got.numpy(), want, 1e-5)


def test_tent_band_equals_corner_gather_in_the_band():
    """With every tap in the band, enumeration and gather are one function,
    summed in another order."""
    u, dy, dx = (torch.from_numpy(a) for a in _band_inputs(1))
    _close(probes.tent_band_plain(u, dy, dx, NCAND, WP, 3).numpy(),
           probes.corner_gather_plain(u, dy, dx, NCAND, WP, 3).numpy(), 1e-5)


def test_band_rejects_a_wrong_width():
    u, dy, dx = (torch.from_numpy(a) for a in _band_inputs(2))
    with pytest.raises(ValueError, match="columns"):
        probes.tent_band(u[:, 1:], dy, dx, NCAND, WP, REPS)


@pytest.mark.parametrize("n_dots,K,Nw", [(3, 32, 64), (2, 64, 128), (5, 48, 64)])
def test_mma_probe_plain_matches_xla(n_dots, K, Nw):
    """`probe`'s body through XLA (`dot_general` contracting dim 0 of both,
    f32 accumulator n_dots times, cast to bf16) on seeded bf16 operands;
    the f32 sums may round differently before the final bf16 rounding, so
    1e-2 of max|ref| (about two bf16 steps)."""
    rs = np.random.RandomState(n_dots)
    v32 = rs.randn(K, probes.D).astype(np.float32)
    w32 = rs.randn(K, Nw).astype(np.float32)
    v, w = jnp.asarray(v32, jnp.bfloat16), jnp.asarray(w32, jnp.bfloat16)
    acc = jnp.zeros((probes.D, Nw), jnp.float32)
    for _ in range(n_dots):
        acc = acc + jax.lax.dot_general(v, w, (((0,), (0,)), ((), ())),
                                        preferred_element_type=jnp.float32)
    want = np.asarray(acc.astype(jnp.bfloat16).astype(jnp.float32))
    got = probes.mma_probe(torch.from_numpy(v32).to(torch.bfloat16),
                           torch.from_numpy(w32).to(torch.bfloat16), n_dots)
    assert got.dtype == torch.bfloat16 and got.shape == (probes.D, Nw)
    _close(got.float().numpy(), want, 1e-2)


def test_mma_probe_residency_rule():
    """The wgmma form keeps its K tiles (two copies of v's rows, w's rows,
    and a zero tile) in shared memory up to `MMA_SMEM_DATA`; the TPU probe's
    K 512 and K 3072 at N 256 stream their K tiles. The mma.sync form's rule
    (v and w up to 227 KB) gives the same split at these shapes."""
    assert probes.mma_probe_resident(256, 256)
    assert not probes.mma_probe_resident(512, 256)
    assert not probes.mma_probe_resident(3072, 256)
    for K, want in ((256, True), (512, False), (3072, False)):
        assert probes.mma_sync_resident(K, 256) == want


@pytest.mark.parametrize("C,Wp,N,ncand,reps", [
    (16, 384, 32 * 384, 4, 9),        # bench_tent_gather.py's shape
    (512, 384, 96 * 384, 4, 9),       # chip_smoke.py's large shape
    (20, 40, 300, 2, 3), (20, 40, 301, 3, 3), (33, 40, 129, 4, 2),
    (7, 40, 127, 5, 3), (40, 40, 257, 6, 2),
    (20, 41, 301, 3, 3), (33, 42, 128, 4, 2), (7, 43, 133, 5, 3), (40, 45, 262, 6, 2)])
def test_tent_band_tiled_mirror_matches_plain(C, Wp, N, ncand, reps):
    """K12a's tiled index arithmetic (`tent_band_tiled`: staged band rows,
    each thread's reads and its segment, the stores) equals
    `tent_band_plain` to 1e-5 of max|plain| (f32 sums in another order),
    stores every output exactly once and reads no staged column outside the
    band (those are NaN); ragged N and C against the tile, ncand 2-6, rows
    staged by 16-byte copies (N + ncand Wp a multiple of 4, at one offset
    into a float4 or, Wp 41-45, at several) and by 4-byte copies."""
    rs = np.random.RandomState(ncand)
    u = torch.from_numpy(rs.rand(C, N + ncand * Wp).astype(np.float32))
    dy = torch.from_numpy((rs.rand(N) * 2 - 1).astype(np.float32))
    dx = torch.from_numpy((rs.rand(N) * 2 - 1).astype(np.float32))
    got, stored = probes.tent_band_tiled(u, dy, dx, ncand, Wp, reps)
    assert bool((stored == 1).all()) and bool(torch.isfinite(got).all())
    _close(got.numpy(), probes.tent_band_plain(u, dy, dx, ncand, Wp, reps).numpy(), 1e-5)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("ncand", [2, 3, 4, 5, 6])
def test_tent_tile_geometry(ncand, vec):
    """A thread's reads hold its rn + ncand - 1 band values in whole float4s,
    from up to 3 columns in where rows are staged from a float4 boundary,
    and the last thread's reads end at the staged row's pitch."""
    t = probes.tent_tile(ncand, vec)
    assert t.rn % 4 == 0 and t.reads % 4 == 0 and t.pitch % 4 == 0
    span = t.rn + ncand - 1 + (3 if vec else 0)
    assert span <= t.reads < span + 4
    assert (t.tx - 1) * t.rn + t.reads == t.pitch >= t.tn + ncand - 1


@pytest.mark.parametrize("C,Wp,N,ncand,reps,spread", [
    (16, 384, 32 * 384, 4, 9, 1),     # bench_tent_gather.py's shape
    (20, 40, 300, 2, 3, 1), (20, 40, 301, 3, 3, 1), (33, 40, 129, 4, 2, 1),
    (7, 43, 133, 5, 3, 1), (70, 45, 262, 6, 2, 1), (65, 130, 1000, 3, 20, 1),
    (40, 64, 640, 4, 2, 1),
    (20, 40, 300, 4, 3, 5), (33, 43, 257, 6, 2, 5), (20, 40, 300, 2, 17, 40)])
def test_corner_gather_tiled_mirror_matches_plain(C, Wp, N, ncand, reps, spread):
    """K12b's tiled index arithmetic (`corner_gather_tiled`: the ring of
    staged rows as each row finds it, each thread's n and channel chunks,
    the rep table's columns, the corners from the ring or from u, the
    stores) equals `corner_gather_plain` to 1e-5 of max|plain| (f32 sums in
    the same order, multiply-adds fused or not), stores every output exactly
    once and reads no slot the ring does not hold for the row (those are
    NaN); ragged C (past a channel tile) and N (a partial last row, Wp not a
    multiple of the strip, and one that is), ncand 2-6, taps in the band and outside it
    (spread 5: corners from u; spread 40: the clamp), more reps than the rep
    table holds at once."""
    rs = np.random.RandomState(ncand + spread)
    u = torch.from_numpy(rs.rand(C, N + ncand * Wp).astype(np.float32))
    dy = torch.from_numpy(((rs.rand(N) * 2 - 1) * spread).astype(np.float32))
    dx = torch.from_numpy(((rs.rand(N) * 2 - 1) * spread).astype(np.float32))
    got, stored = probes.corner_gather_tiled(u, dy, dx, ncand, Wp, reps)
    assert bool((stored == 1).all()) and bool(torch.isfinite(got).all())
    _close(got.numpy(), probes.corner_gather_plain(u, dy, dx, ncand, Wp, reps).numpy(), 1e-5)


@pytest.mark.parametrize("ncand", [2, 3, 4, 5, 6])
def test_gather_tile_geometry(ncand):
    """A staged row's pitch is a multiple of 8 (a column of another row keeps
    its swizzle) holding the strip and its ncand - 1 columns; a column's
    chunks are a permutation of its channels; a warp's staging copies (8
    columns x 4 channels of a chunk) and a quarter-warp's reads (8 chunks of
    one column) each fall on 32 banks; the ring and tables fit a block."""
    t = probes.gather_tile(ncand)
    assert t.pitch % 8 == 0 and t.seg <= t.pitch < t.seg + 8 and t.ring == ncand + 1
    assert t.tn == t.warps * t.slots * t.rn and t.ch % 32 == 0
    h = torch.arange(t.ch // 4)
    for col in range(t.ring * t.pitch):
        assert sorted((h ^ (col & 7)).tolist()) == list(range(t.ch // 4))
    base = torch.arange(0, t.pitch, 8)[:, None] + torch.arange(8)                       # 8 columns
    words = base[..., None] * t.ch + 4 * (3 ^ (base[..., None] & 7)) + torch.arange(4)  # chunk 3
    assert all(len(set((w % 32).flatten().tolist())) == 32 for w in words)
    reads = 5 * t.ch + 4 * (torch.arange(8) ^ (5 & 7))[:, None] + torch.arange(4)       # column 5
    assert len(set((reads % 32).flatten().tolist())) == 32
    assert probes.gather_smem(ncand) <= 232448


@pytest.mark.parametrize("atom", [64, 128])
def test_swizzle_is_a_permutation_of_each_pattern(atom):
    """The 64- and 128-byte swizzles move 16-byte chunks only within their
    repeating pattern (512 and 1024 bytes) and are one-to-one there."""
    addr = torch.arange(0, 4 * 1024, 2)
    sw = probes.swizzle(addr, atom)
    rep = 8 * atom
    assert torch.equal(sw // rep, addr // rep) and torch.equal(sw % 16, addr % 16)
    assert len(set(sw.tolist())) == len(addr)


@pytest.mark.parametrize("K,N,odd", [(128, 64, False), (128, 128, True), (128, 192, False),
                                     (256, 256, True), (32, 256, False), (48, 64, True),
                                     (512, 256, False), (3072, 256, True), (80, 128, False)])
def test_wgmma_descriptor_walk_rebuilds_the_operands(K, N, odd):
    """K12c's wgmma form: a K tile loaded as TMA writes it (64-byte swizzle
    for v's two copies, 128-byte swizzle for w's 64-column boxes), read back
    through the descriptors of each k16 step (start address, leading and
    stride byte offsets, the core-matrix walk) is A = [vᵀ; vᵀ] (rows 32-63
    zero on an odd n_dots' last pass) and B = w's rows; over the tile's
    steps the walk reads each element of v's copy (or both copies), of the
    zero tile where odd, and of w's boxes exactly once: a bijection onto the
    tile. Resident and streamed plans, N 64-256, K below the tile rows and
    past K (zero rows)."""
    rs = np.random.RandomState(K + N)
    v = torch.from_numpy(rs.randn(K, probes.D).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rs.randn(K, N).astype(np.float32)).to(torch.bfloat16)
    plan = probes.wgmma_plan(K, N)
    assert plan.resident == probes.mma_probe_resident(K, N)
    assert plan.smem <= probes._build.source_define(probes.SOURCE, "MMA_SMEM_DATA") \
        or not plan.resident
    t = plan.tiles - 1                                  # the last tile: rows past K are zero
    slot = (t if plan.resident else t % plan.stages) * plan.tile
    smem = torch.full((plan.smem // 2,), float("nan"))
    smem[plan.zero // 2:(plan.zero + plan.v_tile) // 2] = 0.0
    probes.wgmma_load(smem, v, w, plan, slot, t)
    rows = t * plan.kt + torch.arange(plan.kt)
    live = (rows < K)[:, None]
    vt = torch.where(live, v.float()[rows.clamp(max=K - 1)], torch.zeros(()))
    wt = torch.where(live, w.float()[rows.clamp(max=K - 1)], torch.zeros(()))
    reads = torch.zeros(plan.smem // 2, dtype=torch.int64)
    for k in range(plan.kt // 16):
        da, db = probes.wgmma_step(plan, slot, k, odd, N)
        a, b = probes.wgmma_walk(da, 64) // 2, probes.wgmma_walk(db, N) // 2
        ks = slice(16 * k, 16 * k + 16)
        top = vt[ks].t()
        assert torch.equal(smem[a], torch.cat([top, torch.zeros_like(top) if odd else top]))
        assert torch.equal(smem[b], wt[ks].t())
        reads += torch.bincount(torch.cat([a.flatten(), b.flatten()]), minlength=plan.smem // 2)
    tile = torch.zeros_like(reads)
    tile[slot // 2:(slot + plan.v_tile) // 2] = 1
    second = (plan.zero, plan.zero + plan.v_tile) if odd else \
        (slot + plan.v_tile, slot + 2 * plan.v_tile)
    tile[second[0] // 2:second[1] // 2] = 1
    tile[(slot + 2 * plan.v_tile) // 2:(slot + plan.tile) // 2] = 1
    assert torch.equal(reads, tile)


@pytest.mark.parametrize("n_dots,K,N", [(1, 128, 256), (2, 64, 64), (3, 32, 128),
                                        (5, 48, 64), (3, 512, 256), (2, 3072, 192),
                                        (1, 80, 128)])
def test_mma_probe_staged_matches_plain(n_dots, K, N):
    """K12c's wgmma form on the CPU (`mma_probe_staged`: tiles loaded into
    their slots, resident or through the ring, every pass's products read
    through the descriptors, rows 32-63 added onto rows 0-31, odd n_dots
    through the zero tile) against `mma_probe_plain`: f32 sums in another
    order before the bf16 rounding, 1e-2 of max|plain| (two bf16 steps); no
    product reads a slot before it is loaded (NaN)."""
    rs = np.random.RandomState(n_dots + K)
    v = torch.from_numpy(rs.randn(K, probes.D).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rs.randn(K, N).astype(np.float32)).to(torch.bfloat16)
    got, reads = probes.mma_probe_staged(v, w, n_dots)
    assert got.dtype == torch.bfloat16 and got.shape == (probes.D, N)
    assert bool(torch.isfinite(got.float()).all()) and int(reads.sum()) > 0
    _close(got.float().numpy(), probes.mma_probe_plain(v, w, n_dots).float().numpy(), 1e-2)


def test_mma_probe_sync_runs_the_plain_version_on_the_cpu():
    """The mma.sync form's wrapper: on CPU tensors its plain version (the
    same function as `mma_probe`'s), counted in its own `plain_calls`."""
    rs = np.random.RandomState(7)
    v = torch.from_numpy(rs.randn(64, probes.D).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rs.randn(64, 128).astype(np.float32)).to(torch.bfloat16)
    before = (probes.mma_probe_sync.plain_calls, probes.mma_probe.plain_calls)
    got = probes.mma_probe_sync(v, w, 3)
    assert (probes.mma_probe_sync.plain_calls, probes.mma_probe.plain_calls) == \
        (before[0] + 1, before[1])
    assert torch.equal(got, probes.mma_probe_plain(v, w, 3))
