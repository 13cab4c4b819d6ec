"""The probes K12a-K12c (`devis_torch/ops/probes.py`) against the JAX
package's micro-benchmarks, on the CPU: the plain versions of K12a and K12b
against `benchmarks/bench_tent_gather.py`'s `_tent_kernel` and
`_gather_kernel` run through `pl.pallas_call(..., interpret=True)`, and
K12c's against `benchmarks/mxu_probe.py`'s body through XLA. The kernels
themselves are held to these plain versions on the card
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
    """v and w stay in shared memory up to 227 KB; the TPU probe's K 512 and
    K 3072 at N 256 stream their K tiles."""
    assert probes.mma_probe_resident(256, 256)
    assert not probes.mma_probe_resident(512, 256)
    assert not probes.mma_probe_resident(3072, 256)


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
