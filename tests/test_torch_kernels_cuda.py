"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes (D below 32, a partial q-block, Cout 1, window rules).
Skipped without a GPU; on one: `python -m pytest -m cuda tests/test_torch_kernels_cuda.py`."""
import pytest
import torch

from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.deform_conv import (modulated_deform_conv2d,
                                         modulated_deform_conv2d_plain)
from devis_torch.ops.ms_deform_attn import ms_deform_attn_temporal_plain, rule_window

pytestmark = pytest.mark.cuda
SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
# f32 with TF32 off: summation order only; bf16: one output rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item()


def _proj(dev, rule, T=3, Q=150, M=2, D=16, P=2, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(0)
    W = rule_window(rule, T)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=dev) * k).to(dtype)  # noqa: E731
    return (r(T, S, M, D), torch.rand(T, Q, L, 2, generator=g, device=dev),
            r(T, Q, M * L * P * 2, k=3.0), r(T, Q, M * W * L * P * 2, k=3.0),
            r(T, Q, M * L * P), r(T, Q, M * W * L * P))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", [("all",), ("window", (-1, 1))])
def test_temporal_proj_kernel(dev, dtype, rule):
    a = _proj(dev, rule, dtype=dtype)
    _close(K.msda_temporal_proj(a[0], SHAPES, *a[1:], rule),
           K.msda_temporal_proj_plain(a[0], SHAPES, *a[1:], rule), dtype)


@pytest.mark.parametrize("rule", [("all",), ("window", (-1, 1))])
def test_tap_window_kernel(dev, rule):
    _, ref, c_off, t_off, _, _ = _proj(dev, rule)
    assert torch.equal(K.msda_tap_window(SHAPES, ref, c_off, t_off, 2),
                       K.msda_tap_window_plain(SHAPES, ref, c_off, t_off, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    T, Q, M, D, P = 3, 7, 2, 32, 2
    Lf = T * L
    value = torch.randn(T, S, M, D, generator=g, device=dev).to(dtype)
    loc = torch.rand(T, Q, M, Lf, P, 2, generator=g, device=dev) * 1.4 - 0.2
    att = torch.rand(T, Q, M, Lf, P, generator=g, device=dev)
    _close(K.msda_temporal(value, SHAPES, loc, att),
           ms_deform_attn_temporal_plain(value, SHAPES, loc, att, ("all",)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,h,w", [(40, 24, 7, 9), (16, 1, 20, 30)])
def test_dcn_kernel(dev, dtype, cin, cout, h, w):
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    fan = (9 * cin) ** 0.5
    a = [r(3, cin, h, w).to(dtype), r(3, 3, cin, 18, k=3.0 / fan).to(dtype), r(18),
         r(3, 3, cin, 9, k=1 / fan).to(dtype), r(9), r(3, 3, cin, cout, k=1 / fan).to(dtype),
         r(cout)]
    _close(modulated_deform_conv2d(*a), modulated_deform_conv2d_plain(*a), dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    a = _proj(dev, ("all",), D=48)
    with pytest.raises(ValueError, match="head dim"):
        K.msda_temporal_proj(a[0], SHAPES, *a[1:], ("all",))
    a = _proj(dev, ("all",))
    with pytest.raises(ValueError, match="float32"):
        K.msda_temporal_proj(a[0], SHAPES, a[1].double(), *a[2:], ("all",))
