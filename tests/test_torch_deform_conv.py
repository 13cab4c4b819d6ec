"""Plain version of the port's fused DCNv2 kernel (K4) against the JAX
package: the exact composition `_mdc_reference` at any offsets, and the
banded TPU kernel (interpret mode) where every tap is in its band. f32. And
the plain emulation of the bf16 tensor-core kernel's arithmetic on its
packed operands (the kernel itself runs only on the card) against
`_mdc_reference`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from devis_tpu.ops.deform_conv import _mdc_reference
from devis_tpu.ops.deform_conv_banded import deform_conv2d_banded_fused
from devis_torch.ops.deform_conv import (mma_plan, modulated_deform_conv2d,
                                         modulated_deform_conv2d_emulated,
                                         modulated_deform_conv2d_plain)

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, CIN, COUT, H, W, K = 2, 8, 6, 10, 12, 3


@pytest.fixture(autouse=True)
def _no_tf32():
    # references run in full f32 (cuDNN convolutions default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _layer(rng, off_scale):
    """x (B, Cin, H, W) and layer weights; `off_scale` sets the offset
    field's spread in pixels (for unit-variance x)."""
    fan = np.sqrt(K * K * CIN)
    return dict(
        x=rng.randn(B, CIN, H, W).astype(np.float32),
        w_off=(rng.randn(K, K, CIN, 2 * K * K) * off_scale / fan).astype(np.float32),
        b_off=(rng.randn(2 * K * K) * 0.1 * off_scale).astype(np.float32),
        w_mod=(rng.randn(K, K, CIN, K * K) / fan).astype(np.float32),
        b_mod=rng.randn(K * K).astype(np.float32),
        weight=(rng.randn(K, K, CIN, COUT) / fan).astype(np.float32),
        bias=rng.randn(COUT).astype(np.float32))


def _port(a):
    return modulated_deform_conv2d_plain(*(torch.from_numpy(a[k]) for k in (
        "x", "w_off", "b_off", "w_mod", "b_mod", "weight", "bias"))).numpy()


def test_plain_matches_exact_reference(rng):
    a = _layer(rng, off_scale=3.0)       # taps a few pixels out, some off the map
    x_nhwc = jnp.asarray(a["x"].transpose(0, 2, 3, 1))
    want = _mdc_reference(x_nhwc, *(jnp.asarray(a[k]) for k in (
        "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")), 1)
    # f32; accumulation order differs
    np.testing.assert_allclose(_port(a), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-4)


def test_plain_matches_banded_kernel_in_band(rng):
    a = _layer(rng, off_scale=0.15)
    # the banded kernel (ncand=4, ncand_y=3, rebase round(mean Δy) = 0 here)
    # covers Δx in [-1, 2) and Δy in [-1, 1): check the field stays inside
    offset = F.conv2d(torch.from_numpy(a["x"]),
                      torch.from_numpy(a["w_off"]).permute(3, 2, 0, 1),
                      torch.from_numpy(a["b_off"]), padding=1).numpy()
    dy, dx = offset[:, 0::2], offset[:, 1::2]
    assert abs(dy.mean()) < 0.5 and np.abs(dy).max() < 1 and np.abs(dx).max() < 1
    want = deform_conv2d_banded_fused(*(jnp.asarray(a[k]) for k in (
        "x", "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")), 1,
        ncand=4, ncand_y=3, channel_first=True)
    # f32; accumulation order differs
    np.testing.assert_allclose(_port(a), np.asarray(want), rtol=0, atol=1e-4)


def test_wrapper_runs_plain_on_cpu(rng):
    a = {k: torch.from_numpy(v) for k, v in _layer(rng, 1.0).items()}
    before = (modulated_deform_conv2d.plain_calls, modulated_deform_conv2d.launches)
    out = modulated_deform_conv2d(*a.values())
    assert out.shape == (B, COUT, H, W) and out.dtype == torch.float32
    assert (modulated_deform_conv2d.plain_calls, modulated_deform_conv2d.launches) == \
        (before[0] + 1, before[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_plain_keeps_input_dtype(rng, dtype):
    a = {k: torch.from_numpy(v) for k, v in _layer(rng, 1.0).items()}
    out = modulated_deform_conv2d_plain(a["x"].to(dtype), *(a[k].to(dtype) for k in (
        "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")))
    ref = modulated_deform_conv2d_plain(*(a[k].to(dtype).float() for k in (
        "x", "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")))
    assert out.dtype == dtype
    # the plain version computes in f32 and rounds its output once to bf16
    torch.testing.assert_close(out.float(), ref.to(dtype).float(), rtol=0, atol=0)


@pytest.mark.parametrize("cin,cout,plan", [
    (264, 264, (272, 9, 2)), (264, 128, (272, 8, 1)), (136, 64, (144, 4, 1)),
    (72, 32, (80, 2, 1)), (32, 16, (32, 1, 1)), (16, 1, (16, 1, 1)), (33, 24, (48, 2, 1))])
def test_mma_plan(cin, cout, plan):
    """The bf16 kernel's padding and channel tiles at the mask head's widths
    (and a ragged Cin): Cin to a multiple of 16, at most 144 output channels
    a block, the fewest blocks."""
    cin_pad, nt, n_tiles = mma_plan(cin, cout)
    assert (cin_pad, nt, n_tiles) == plan
    assert 16 * nt * n_tiles >= cout > 16 * nt * n_tiles - 16 * n_tiles


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("cin,cout,plan", [(40, 150, (48, 5, 2)), (32, 16, (32, 1, 1))])
def test_kernel_emulation_matches_exact_reference(rng, dtype, tol, cin, cout, plan):
    """The bf16 kernel's arithmetic on the operands its wrapper packs: Cin 40
    zero-padded to 48 and Cout 150 in two 80-wide channel tiles; Cin 32 with
    no padding and Cout 16 in one 16-wide tile (lay5's widths). Taps a few
    pixels out and some off the map. f32 rounds nothing: summation order
    only, 1e-5 of max|ref|. bf16 (inputs rounded to bf16, the reference run
    on the same values in f32): each sampled column and the output are
    rounded to bf16 once, 1e-2 of max|ref| (about 4e-3 here)."""
    b, h, w = 2, 6, 7
    assert mma_plan(cin, cout) == plan
    fan = np.sqrt(K * K * cin)
    a = dict(x=rng.randn(b, cin, h, w), w_off=rng.randn(K, K, cin, 2 * K * K) * 3 / fan,
             b_off=rng.randn(2 * K * K) * 0.3, w_mod=rng.randn(K, K, cin, K * K) / fan,
             b_mod=rng.randn(K * K), weight=rng.randn(K, K, cin, cout) / fan,
             bias=rng.randn(cout))
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in a.items()}
    for k in ("x", "w_off", "w_mod", "weight"):
        t[k] = t[k].to(dtype)
    got = modulated_deform_conv2d_emulated(*(t[k] for k in (
        "x", "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")))
    assert got.dtype == dtype and got.shape == (b, cout, h, w)
    want = np.asarray(_mdc_reference(
        jnp.asarray(t["x"].float().numpy().transpose(0, 2, 3, 1)),
        *(jnp.asarray(t[k].float().numpy()) for k in (
            "w_off", "b_off", "w_mod", "b_mod", "weight", "bias")), 1)).transpose(0, 3, 1, 2)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max()
