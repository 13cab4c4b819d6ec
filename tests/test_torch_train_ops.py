"""Forward and gradients of the port's differentiable ops against the JAX
package on the CPU, f32: the plain temporal and single-frame deformable
attention against the Pallas rows ops and their custom VJPs (interpret mode),
the DCNv2 layer's differentiable route against `jax.grad` of `_mdc_reference`.
On CPU tensors the port's wrappers run their plain versions under autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_tpu.ops.deform_conv import _mdc_reference
from devis_tpu.ops.ms_deform_attn_pallas import (
    ms_deform_attn_rows, ms_deform_attn_rows_temporal,
    ms_deform_attn_temporal_proj)
from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                         modulated_deform_conv2d_plain,
                                         modulated_deform_conv2d_rows)
from devis_torch.ops.ms_deform_attn import rule_window

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
RULES = [("all",), ("window", (-1, 1))]
Q_PAD = 128


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, what, rel=1e-4):
    # f32 on both sides; the two sum taps and corners in different orders, so
    # agreement is to 1e-4 of the reference's largest magnitude
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err, np.abs(want).max())


def _rows(x):
    """Port layout (B, Q, M, Lx, P) → the JAX rows layout (B*M, Lx*P, q_pad),
    padded queries zero (differentiable)."""
    B, Q, M, Lx, P = x.shape
    r = jnp.transpose(x, (0, 2, 3, 4, 1)).reshape(B * M, Lx * P, Q)
    return jnp.pad(r, ((0, 0), (0, 0), (0, Q_PAD - Q)))


def _pad_out_of_range(r, Q):
    """Padded queries of a location row sample outside the map."""
    return r.at[:, :, Q:].set(-10.0)


def _torch_grads(fn, arrays, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _rows_case(rng, B, Q, M, D, P, n_levels):
    value = rng.rand(B, S, M, D).astype(np.float32)
    loc = (rng.rand(B, Q, M, n_levels, P, 2) * 1.2 - 0.1).astype(np.float32)
    att = rng.rand(B, Q, M, n_levels, P).astype(np.float32)
    cot = rng.randn(B, Q, M * D).astype(np.float32)
    return value, loc, att, cot


@pytest.mark.parametrize("rule", RULES)
def test_temporal_attention_gradients_match_pallas(rng, rule):
    """K3's and K5's plain versions against `ms_deform_attn_rows_temporal`
    and its VJP (`_bwd_kernel_rows_temporal`)."""
    T, Q, M, D, P = 3, 10, 2, 16, 2
    Lf = (1 + rule_window(rule, T)) * L
    value, loc, att, cot = _rows_case(rng, T, Q, M, D, P, Lf)

    def jax_fn(v, l, a):
        lx = _pad_out_of_range(_rows(l[..., 0]), Q)
        ly = _pad_out_of_range(_rows(l[..., 1]), Q)
        return ms_deform_attn_rows_temporal(v, SHAPES, lx, ly, _rows(a), Q, rule)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (value, loc, att)))
    want_grads = vjp(jnp.asarray(cot))
    got, got_grads = _torch_grads(
        lambda v, l, a: K.msda_temporal(v, SHAPES, l, a, rule), (value, loc, att), cot)
    _close(got, want, "out")
    for name, g, w in zip(("value", "loc", "att"), got_grads, want_grads):
        _close(g, w, f"grad {name}")
    # the backward wrapper on its own gives the same gradients on the CPU
    direct = K.msda_temporal_bwd(*(torch.from_numpy(a) for a in (value,)), SHAPES,
                                 torch.from_numpy(loc), torch.from_numpy(att),
                                 torch.from_numpy(cot), rule)
    for g, w in zip(direct, got_grads):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("M,D", [(2, 16), (1, 5)])
def test_single_frame_attention_gradients_match_pallas(rng, M, D):
    """K6's and K7's plain versions against `ms_deform_attn_rows`
    (`_fwd_kernel_fused`) and its VJP (`_bwd_kernel_rows`)."""
    B, Q, P = 2, 40, 2
    value, loc, att, cot = _rows_case(rng, B, Q, M, D, P, L)

    def jax_fn(v, l, a):
        lx = _pad_out_of_range(_rows(l[..., 0]), Q)
        ly = _pad_out_of_range(_rows(l[..., 1]), Q)
        return ms_deform_attn_rows(v, SHAPES, lx, ly, _rows(a), Q)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (value, loc, att)))
    want_grads = vjp(jnp.asarray(cot))
    before = (K.msda_rows.plain_calls, K.msda_rows.launches)
    got, got_grads = _torch_grads(lambda v, l, a: K.msda_rows(v, SHAPES, l, a),
                                  (value, loc, att), cot)
    assert (K.msda_rows.plain_calls, K.msda_rows.launches) == (before[0] + 1, before[1])
    _close(got, want, "out")
    for name, g, w in zip(("value", "loc", "att"), got_grads, want_grads):
        _close(g, w, f"grad {name}")
    direct = K.msda_rows_bwd(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                             torch.from_numpy(att), torch.from_numpy(cot))
    for g, w in zip(direct, got_grads):
        np.testing.assert_array_equal(g.numpy(), w)


def _tiled(x, fill=0.0):
    """q-major (T, Q, C) → the JAX op's pre-tiled (T, nqt, C, q_tile)
    (differentiable)."""
    T, Q, C = x.shape
    x = jnp.pad(x, ((0, 0), (0, Q_PAD - Q), (0, 0)), constant_values=fill)
    return jnp.transpose(x.reshape(T, Q_PAD // 128, 128, C), (0, 1, 3, 2))


@pytest.mark.parametrize("rule", RULES)
def test_temporal_proj_gradients_match_pallas(rng, rule):
    """K1's plain version, differentiated from the raw projections, against
    `ms_deform_attn_temporal_proj` and its VJP: gradients of the value, the
    references, both offset and both logit projections."""
    T, Q, M, D, P = 3, 40, 2, 16, 2
    W = rule_window(rule, T)
    arrays = (rng.rand(T, S, M, D).astype(np.float32),
              rng.rand(T, Q, L, 2).astype(np.float32),
              (rng.randn(T, Q, M * L * P * 2) * 3).astype(np.float32),
              (rng.randn(T, Q, M * W * L * P * 2) * 3).astype(np.float32),
              rng.randn(T, Q, M * L * P).astype(np.float32),
              rng.randn(T, Q, M * W * L * P).astype(np.float32))
    cot = rng.randn(T, Q, M * D).astype(np.float32)

    def jax_fn(value, ref, c_off, t_off, c_logit, t_logit):
        return ms_deform_attn_temporal_proj(
            value, SHAPES, _tiled(ref[..., 0], -10.0), _tiled(ref[..., 1], -10.0),
            _tiled(c_off[..., 0::2]), _tiled(c_off[..., 1::2]),
            _tiled(t_off[..., 0::2]), _tiled(t_off[..., 1::2]),
            _tiled(c_logit), _tiled(t_logit), Q, rule)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in arrays))
    want_grads = vjp(jnp.asarray(cot))
    got, got_grads = _torch_grads(
        lambda *t: K.msda_temporal_proj(t[0], SHAPES, *t[1:], rule), arrays, cot)
    _close(got, want, "out")
    names = ("value", "ref", "c_off", "t_off", "c_logit", "t_logit")
    for name, g, w in zip(names, got_grads, want_grads):
        _close(g, w, f"grad {name}")


B, CIN, COUT, H, W_, KS = 2, 8, 6, 10, 12, 3
DCN_NAMES = ("x", "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")


def _layer(rng, cout=COUT):
    fan = np.sqrt(KS * KS * CIN)
    return [rng.randn(B, CIN, H, W_).astype(np.float32),
            (rng.randn(KS, KS, CIN, 2 * KS * KS) * 3.0 / fan).astype(np.float32),
            (rng.randn(2 * KS * KS) * 0.3).astype(np.float32),
            (rng.randn(KS, KS, CIN, KS * KS) / fan).astype(np.float32),
            rng.randn(KS * KS).astype(np.float32),
            (rng.randn(KS, KS, CIN, cout) / fan).astype(np.float32),
            rng.randn(cout).astype(np.float32)]


@pytest.mark.parametrize("cout", [COUT, 1])
def test_dcn_layer_gradients_match_jax(rng, cout):
    """The layer under grad (field convs, mix before the gather, K6/K7's
    plain versions) against `jax.grad` of `_mdc_reference`: x, the three
    weights and the three biases. Taps land a few pixels out, some off the
    map."""
    a = _layer(rng, cout)
    cot = rng.randn(B, cout, H, W_).astype(np.float32)

    def jax_fn(x, *rest):
        out = _mdc_reference(jnp.transpose(x, (0, 2, 3, 1)), *rest, 1)
        return jnp.transpose(out, (0, 3, 1, 2))

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in a))
    want_grads = vjp(jnp.asarray(cot))
    before = (K.msda_rows.plain_calls, modulated_deform_conv2d.plain_calls)
    got, got_grads = _torch_grads(modulated_deform_conv2d, a, cot)
    # under grad the layer takes the rows route, not K4's plain version
    assert (K.msda_rows.plain_calls, modulated_deform_conv2d.plain_calls) == \
        (before[0] + 1, before[1])
    _close(got, want, "out")
    for name, g, w in zip(DCN_NAMES, got_grads, want_grads):
        _close(g, w, f"grad {name}")


def test_dcn_routes_agree(rng):
    """The differentiable route and K4's plain version are the same
    function: outputs and gradients."""
    a = _layer(rng)
    cot = rng.randn(B, COUT, H, W_).astype(np.float32)
    out_r, g_r = _torch_grads(modulated_deform_conv2d_rows, a, cot)
    out_p, g_p = _torch_grads(modulated_deform_conv2d_plain, a, cot)
    _close(out_r, out_p, "out")
    for name, g, w in zip(DCN_NAMES, g_r, g_p):
        _close(g, w, f"grad {name}")
    with torch.no_grad():
        before = modulated_deform_conv2d.plain_calls
        modulated_deform_conv2d(*(torch.from_numpy(t) for t in a))
        assert modulated_deform_conv2d.plain_calls == before + 1
