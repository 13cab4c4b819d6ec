"""The image model's ops in the PyTorch port against the JAX package on the
CPU, f32: the projection-fused attention (plain K8) against
`ms_deform_attn_proj`, the q-major op and its tap backward (plain K9) against
`ms_deform_attn_pallas` and `_bwd_call`, and the deformable convolution from
given fields (plain K10) against `_deform_conv2d_xla` and the banded kernel.
The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port runs its plain versions (the tensors lie on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.deform_conv import deform_conv2d, deform_conv2d_plain
from devis_torch.ops.ms_deform_attn import ms_deform_attn

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
Q_PAD = 128


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err)


# ---------------------------------------------------------------------------
# K8: projection-fused single-frame attention
# ---------------------------------------------------------------------------

def _proj_case(seed, B=2, M=2, D=16, P=3, Q=40):
    rs = np.random.RandomState(seed)
    f = np.float32
    return dict(value=rs.randn(B, S, M, D).astype(f),
                ref=rs.rand(B, Q, L, 2).astype(f),
                off=(rs.randn(B, Q, M, L, P, 2) * 3).astype(f),
                logit=rs.randn(B, Q, M, L, P).astype(f))


def _jax_proj(case):
    """`ms_deform_attn_proj` as a function of (value, ref, off, logit) in the
    port's layouts: the operands are padded to one 128-query tile (padded
    references at -10) and tiled head-major as the JAX module does."""
    from devis_tpu.ops.ms_deform_attn_pallas import (_tile_headmajor,
                                                     ms_deform_attn_proj)
    B, Q, M = case["off"].shape[:3]

    def rows(x):                                   # (B, Q, M, L, P) -> tiled
        x = jnp.transpose(x, (0, 2, 3, 4, 1)).reshape(B * M, -1, Q)
        x = jnp.pad(x, ((0, 0), (0, 0), (0, Q_PAD - Q)))
        return _tile_headmajor(x, M, Q_PAD)

    def refs(r):                                   # (B, Q, L) -> (B, 1, L, 128)
        r = jnp.pad(jnp.transpose(r, (0, 2, 1)), ((0, 0), (0, 0), (0, Q_PAD - Q)),
                    constant_values=-10.0)
        return r[:, None]

    def f(value, ref, off, logit):
        return ms_deform_attn_proj(value, SHAPES, refs(ref[..., 0]), refs(ref[..., 1]),
                                   rows(off[..., 0]), rows(off[..., 1]), rows(logit), Q)
    return f


def _port_proj(value, ref, off, logit):
    B, Q = ref.shape[:2]
    return K.msda_proj(value, SHAPES, ref, off.reshape(B, Q, -1), logit.reshape(B, Q, -1))


def test_proj_forward_matches_jax_kernel():
    case = _proj_case(0)
    want = _jax_proj(case)(*(jnp.asarray(v) for v in case.values()))
    before = K.msda_proj.plain_calls
    got = _port_proj(*(torch.from_numpy(v) for v in case.values()))
    assert K.msda_proj.plain_calls == before + 1
    # f32 on both sides; the TPU kernel sums its taps as a matrix product
    _close(got, want, 1e-5)


def test_proj_gradients_match_jax():
    """Gradients to value, references, offsets and logits (the JAX backward
    rebuilds the rows and runs `_bwd_kernel_rows`)."""
    case = _proj_case(1, B=1)
    cot = np.random.RandomState(2).randn(1, 40, 2 * 16).astype(np.float32)
    _, vjp = jax.vjp(_jax_proj(case), *(jnp.asarray(v) for v in case.values()))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in case.values()]
    got = torch.autograd.grad(_port_proj(*leaves), leaves, torch.from_numpy(cot))
    for name, g, w in zip(case, got, want):
        assert float(g.abs().max()) > 0, name
        _close(g, w, 1e-4, name)                  # f32; summation order differs


def test_proj_locations_floor_like_the_jax_kernel():
    """One-hot attention on one tap of a value that is its own raster index:
    a location that floors to another pixel than the JAX kernel's would move
    the output by a whole pixel. Both multiply by the f32 reciprocal of the
    level size."""
    case = _proj_case(3, B=1, M=1, D=1, P=1, Q=128)
    case["value"] = np.arange(S, dtype=np.float32).reshape(1, S, 1, 1)
    case["logit"][:] = -30.0
    case["logit"][:, :, :, 0] = 30.0
    # offsets in whole pixels around references on the pixel grid, where
    # ref + off / size lands within rounding of a pixel boundary
    h, w = SHAPES[0]
    rs = np.random.RandomState(4)
    case["ref"][..., 0] = (rs.randint(0, w, (1, 128, 1)) + 0.5) / w
    case["ref"][..., 1] = (rs.randint(0, h, (1, 128, 1)) + 0.5) / h
    case["off"][:] = rs.randint(-3, 4, case["off"].shape) + 0.5
    want = _jax_proj(case)(*(jnp.asarray(v) for v in case.values()))
    got = _port_proj(*(torch.from_numpy(v) for v in case.values()))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-2


# ---------------------------------------------------------------------------
# the q-major op and K9
# ---------------------------------------------------------------------------

def _rows_case(seed, B=2, Q=20, M=2, G=1, D=16, P=2):
    rs = np.random.RandomState(seed)
    f = np.float32
    loc = (rs.rand(B, Q, M * G, L, P, 2) * 1.4 - 0.2).astype(f)
    loc[:, 0] = -3.0                                # every tap of query 0 is dead
    return dict(value=rs.randn(B, S, M, D).astype(f), loc=loc,
                att=rs.rand(B, Q, M * G, L, P).astype(f))


def test_qmajor_op_matches_jax_pallas_forward_and_grad():
    """`msda_taps` (plain on the CPU) against `ms_deform_attn_pallas`; its
    `jax.grad` runs `_bwd_kernel` and the `_taps` chain rule."""
    from devis_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_pallas
    case = _rows_case(5)
    cot = np.random.RandomState(6).randn(2, 20, 2 * 16).astype(np.float32)
    want, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_pallas(v, SHAPES, l, a),
                        *(jnp.asarray(v) for v in case.values()))
    want_g = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in case.values()]
    before = K.msda_taps.plain_calls
    got = K.msda_taps(leaves[0], SHAPES, leaves[1], leaves[2])
    assert K.msda_taps.plain_calls == before + 1
    _close(got.detach(), want, 1e-5)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for name, g, w in zip(case, got_g, want_g):
        _close(g, w, 1e-4, name)


def test_taps_chain_rule_gives_the_plain_gradients():
    """The backward the card runs, on the CPU: `taps`, plain K9, autograd
    through `taps`. Equal to autograd of the plain attention, and exactly
    zero for the locations and weights of taps outside the map."""
    case = _rows_case(7)
    cot = torch.from_numpy(np.random.RandomState(8).randn(2, 20, 32).astype(np.float32))
    value, loc, att = (torch.from_numpy(v).requires_grad_(True) for v in case.values())
    want = torch.autograd.grad(ms_deform_attn(value, SHAPES, loc, att),
                               [value, loc, att], cot)
    idx, wt = K.taps(SHAPES, loc, att)
    assert idx.dtype == torch.int32 and idx.shape == (2, 2, 20, L, 8)
    g_value, g_wt = K.msda_taps_bwd(value.detach(), SHAPES, idx, wt.detach(), cot)
    g_loc, g_att = torch.autograd.grad(wt, [loc, att], g_wt)
    for name, g, w in zip(case, (g_value, g_loc, g_att), want):
        _close(g, w, 1e-5, name)
    assert not g_loc[:, 0].any() and not g_att[:, 0].any()
    assert g_wt[:, :, 0].abs().max() > 0          # the kernel's grad_wt is not masked


@pytest.mark.parametrize("groups", [1, 2])
def test_taps_bwd_plain_matches_jax_bwd_call(groups):
    """Plain K9 against `_bwd_call` on the same taps: the JAX package's
    parity-packed entries are unpacked to raster indices (entry k of a point
    lies in parity class k & 1 at packed index m: raster = 2 m + (k & 1)).
    grad_value everywhere; grad_wt on live entries (a dead entry's value is
    not defined by the TPU kernel and is masked by the chain rule), and zero
    where the index lies outside its level."""
    from devis_tpu.ops.ms_deform_attn_pallas import (S_TILE, _bwd_call, _prep,
                                                     _unpack_levels)
    M, D, Q, B = 2, 16, 20, 2
    case = _rows_case(9 + groups, B=B, Q=Q, M=M, G=groups, D=D)
    MG = M * groups
    cot = np.random.RandomState(11).randn(B, Q, MG * D).astype(np.float32)
    value = jnp.asarray(case["value"])
    ve, vo, idx, wt, ranges, _, K4, q_pad = _prep(
        value, SHAPES, jnp.asarray(case["loc"]), jnp.asarray(case["att"]), 128, S_TILE)
    g_bm = jnp.transpose(jnp.asarray(cot).reshape(B, Q, MG, D), (0, 2, 1, 3)) \
        .reshape(B * MG, Q, D)
    g_bm = jnp.pad(g_bm, ((0, 0), (0, q_pad - Q), (0, 0)))
    gve, gvo, gwt = _bwd_call(SHAPES, ve, vo, idx, wt, ranges, g_bm, 128, S_TILE, groups)
    want_v = np.asarray(_unpack_levels(gve, gvo, SHAPES, S_TILE)) \
        .reshape(B, M, S, D).transpose(0, 2, 1, 3)

    def qmajor(x):                                  # (B*MG, L*K4, q_pad) -> (B, MG, Q, L, K4)
        return np.asarray(x).reshape(B, MG, L, K4, q_pad)[..., :Q].transpose(0, 1, 4, 2, 3)

    want_w, wt_q, packed = qmajor(gwt), qmajor(wt), qmajor(idx)
    raster = (2 * packed + (np.arange(K4) & 1)).astype(np.int32)
    got_v, got_w = K.msda_taps_bwd_plain(
        torch.from_numpy(case["value"]), SHAPES, torch.from_numpy(raster),
        torch.from_numpy(wt_q.copy()), torch.from_numpy(cot))
    _close(got_v, want_v, 1e-5, "grad_value")
    live = wt_q != 0
    assert live.mean() > 0.3 and (~live).mean() > 0.05
    _close(got_w.numpy() * live, want_w * live, 1e-5, "grad_wt")
    sizes = np.asarray([h * w for h, w in SHAPES]).reshape(1, 1, 1, L, 1)
    outside = (raster < 0) | (raster >= sizes)
    assert outside.any() and not got_w.numpy()[outside].any()


# ---------------------------------------------------------------------------
# K10: deformable convolution from given fields
# ---------------------------------------------------------------------------

B, CIN, COUT, H, W = 2, 8, 6, 10, 12


def _fields(seed, spread):
    rs = np.random.RandomState(seed)
    f = np.float32
    return dict(x=rs.randn(B, CIN, H, W).astype(f),
                offset=(rs.randn(B, 18, H, W) * spread).astype(f),
                mask=(rs.rand(B, 9, H, W) * 2).astype(f),
                weight=(rs.randn(3, 3, CIN, COUT) / np.sqrt(9 * CIN)).astype(f),
                bias=rs.randn(COUT).astype(f))


def _nhwc(a):
    return [jnp.asarray(a[k].transpose(0, 2, 3, 1)) for k in ("x", "offset", "mask")] \
        + [jnp.asarray(a["weight"]), jnp.asarray(a["bias"])]


def test_deform_conv2d_matches_exact_jax_version():
    from devis_tpu.ops.deform_conv import _deform_conv2d_xla
    a = _fields(12, spread=2.5)                    # taps pixels out, some off the map
    want = np.asarray(_deform_conv2d_xla(*_nhwc(a), 1)).transpose(0, 3, 1, 2)
    before = (deform_conv2d.plain_calls, deform_conv2d.launches)
    got = deform_conv2d(*(torch.from_numpy(v) for v in a.values()))
    assert (deform_conv2d.plain_calls, deform_conv2d.launches) == (before[0] + 1, before[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)   # f32, summation order


def test_deform_conv2d_matches_banded_kernel_in_band():
    from devis_tpu.ops.deform_conv_banded import deform_conv2d_banded
    a = _fields(13, spread=0.2)
    a["offset"] = np.clip(a["offset"], -0.9, 0.9)  # inside the band [-1, 1) of ncand 4 x 3
    assert abs(a["offset"][:, 0::2].mean()) < 0.5
    want = np.asarray(deform_conv2d_banded(*_nhwc(a), 1, ncand=4, ncand_y=3))
    got = deform_conv2d(*(torch.from_numpy(v) for v in a.values()))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=0, atol=1e-4)


def test_deform_conv2d_with_gradient_takes_the_rows_route():
    """With a gradient wanted the op runs the K6/K7 composition; its output
    and its five gradients equal autograd of the plain version."""
    a = _fields(14, spread=2.5)
    cot = torch.from_numpy(np.random.RandomState(15).randn(B, COUT, H, W).astype(np.float32))

    def run(fn):
        leaves = [torch.from_numpy(v).requires_grad_(True) for v in a.values()]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, cot)

    before = (K.msda_rows.plain_calls, deform_conv2d.plain_calls)
    out, grads = run(deform_conv2d)
    assert (K.msda_rows.plain_calls, deform_conv2d.plain_calls) == (before[0] + 1, before[1])
    want, want_g = run(lambda x, o, m, w, b: deform_conv2d_plain(x, o, m, w)
                       + b[None, :, None, None])
    _close(out, want, 1e-5)
    for name, g, w in zip(a, grads, want_g):
        _close(g, w, 1e-4, name)
