"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes (D below 32 and above it, a partial q-block, Cout 1, window
rules), forward and backward, and the autograd Functions around them.
Skipped without a GPU; on one: `python -m pytest -m cuda tests/test_torch_kernels_cuda.py`."""
import pytest
import torch

from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.deform_conv import (deform_conv2d, deform_conv2d_plain,
                                         modulated_deform_conv2d,
                                         modulated_deform_conv2d_plain)
from devis_torch.ops.ms_deform_attn import (ms_deform_attn,
                                            ms_deform_attn_temporal_plain,
                                            rule_window)

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


def test_tap_window_kernel_takes_an_empty_temporal_part(dev):
    """F = 1: the windows of the single-frame projection-fused attention."""
    _, ref, c_off, _, _, _ = _proj(dev, ("all",))
    t_off = c_off.new_zeros(c_off.shape[:2] + (0,))
    got = K.msda_tap_window(SHAPES, ref, c_off, t_off, 2)
    assert got.shape == (3, 2, 2, L, 2)
    assert torch.equal(got, K.msda_tap_window_plain(SHAPES, ref, c_off, t_off, 2))


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


# DCNv2 layer shapes, B = 3: Cin not a multiple of 16 (33, 40) and above one
# 64-wide depth chunk (72, 136, 264); Cout 1, 24 and 264 (two 144-wide
# channel tiles of the bf16 kernel); H*W never a multiple of its 128-pixel
# tile. Offsets of 2-3 pixels, some landing off the map. bf16: the tensor-core
# kernel rounds each sampled column to bf16 (within the bf16 tolerance).
DCN_SHAPES = [(40, 24, 7, 9), (16, 1, 20, 30), (33, 264, 9, 11), (72, 24, 13, 10),
              (136, 1, 6, 25), (264, 264, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,h,w", DCN_SHAPES)
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
    # the bf16 DCNv2 kernel's field GEMM holds 3KK <= 32 channels: K <= 3
    r = lambda *s: torch.randn(*s, device=dev, dtype=torch.bfloat16)  # noqa: E731
    with pytest.raises(ValueError, match="K <= 3"):
        modulated_deform_conv2d(r(1, 8, 6, 6), r(5, 5, 8, 50), r(50), r(5, 5, 8, 25), r(25),
                                r(5, 5, 8, 4), r(4), 2)


# ---------------------------------------------------------------------------
# backward kernels (K5, K7), the forward K6, and the autograd Functions.
# The value gradient is summed with f32 atomics in an order that changes from
# run to run; the f32 tolerance covers that, the bf16 one the output rounding.
# ---------------------------------------------------------------------------

def _rows_inputs(dev, dtype, B, Q, M, D, P, n_levels, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    value = torch.randn(B, S, M, D, generator=g, device=dev).to(dtype)
    loc = torch.rand(B, Q, M, n_levels, P, 2, generator=g, device=dev) * 1.4 - 0.2
    att = torch.rand(B, Q, M, n_levels, P, generator=g, device=dev)
    grad = torch.randn(B, Q, M * D, generator=g, device=dev).to(dtype)
    return value, loc, att, grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule,D", [(("all",), 32), (("window", (-1, 1)), 16)])
def test_temporal_bwd_kernel(dev, dtype, rule, D):
    T = 3
    Lf = (1 + rule_window(rule, T)) * L
    value, loc, att, grad = _rows_inputs(dev, dtype, T, 7, 2, D, 2, Lf)
    got = K.msda_temporal_bwd(value, SHAPES, loc, att, grad, rule)
    want = K.msda_temporal_bwd_plain(value, SHAPES, loc, att, grad, rule)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,Q", [(1, 1, 70), (1, 5, 33), (2, 32, 9), (1, 72, 40)])
def test_rows_kernels(dev, dtype, M, D, Q):
    value, loc, att, grad = _rows_inputs(dev, dtype, 2, Q, M, D, 2, L)
    _close(K.msda_rows(value, SHAPES, loc, att),
           ms_deform_attn(value, SHAPES, loc, att), dtype)
    got = K.msda_rows_bwd(value, SHAPES, loc, att, grad)
    want = K.msda_rows_bwd_plain(value, SHAPES, loc, att, grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, dtype)


def _grads(fn, tensors):
    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in tensors]
    out = fn(*leaves)
    g = torch.Generator(device=out.device).manual_seed(9)
    cot = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)
    return torch.autograd.grad(out, [t for t in leaves if t.requires_grad], cot)


@pytest.mark.parametrize("rule", [("all",), ("window", (-1, 1))])
def test_temporal_proj_function_gives_gradients(dev, rule):
    """K1 on inputs that require grad: gradients of the value, references,
    offsets and logits, none of them zero, equal to the plain version's."""
    a = _proj(dev, rule)
    got = _grads(lambda *t: K.msda_temporal_proj(t[0], SHAPES, *t[1:], rule), a)
    want = _grads(lambda *t: K.msda_temporal_proj_plain(t[0], SHAPES, *t[1:], rule), a)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        _close(g, w, torch.float32)


def test_temporal_function_gives_gradients(dev):
    value, loc, att, _ = _rows_inputs(dev, torch.float32, 3, 7, 2, 32, 2, 3 * L)
    got = _grads(lambda v, l, a: K.msda_temporal(v, SHAPES, l, a), (value, loc, att))
    want = _grads(lambda v, l, a: ms_deform_attn_temporal_plain(v, SHAPES, l, a, ("all",)),
                  (value, loc, att))
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        _close(g, w, torch.float32)


@pytest.mark.parametrize("cin,cout", [(40, 24), (16, 1)])
def test_dcn_layer_gives_gradients(dev, cin, cout):
    """The DCNv2 layer on inputs that require grad takes the K6/K7 route:
    its output equals K4's and its seven gradients the plain version's."""
    g = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    fan = (9 * cin) ** 0.5
    a = [r(3, cin, 7, 9), r(3, 3, cin, 18, k=3.0 / fan), r(18), r(3, 3, cin, 9, k=1 / fan),
         r(9), r(3, 3, cin, cout, k=1 / fan), r(cout)]
    before = (K.msda_rows.launches, K.msda_rows_bwd.launches, modulated_deform_conv2d.launches)
    got = _grads(lambda *t: modulated_deform_conv2d(*t), a)
    assert (K.msda_rows.launches, K.msda_rows_bwd.launches,
            modulated_deform_conv2d.launches) == (before[0] + 1, before[1] + 1, before[2])
    want = _grads(lambda *t: modulated_deform_conv2d_plain(*t), a)
    assert len(got) == 7
    for gg, w in zip(got, want):
        assert gg.abs().max() > 0
        _close(gg, w, torch.float32)
    with torch.no_grad():
        k4 = modulated_deform_conv2d(*a)
    leaves = [t.detach().requires_grad_(True) for t in a]
    _close(modulated_deform_conv2d(*leaves), k4, torch.float32)


# ---------------------------------------------------------------------------
# the image model's kernels: K8 (projection-fused forward), K9 (backward from
# precomputed taps) and K10 (deformable conv from given fields)
# ---------------------------------------------------------------------------

def _proj_single(dev, B=2, Q=150, M=2, D=16, P=2, dtype=torch.float32, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=dev) * k).to(dtype)  # noqa: E731
    return (r(B, S, M, D), torch.rand(B, Q, L, 2, generator=g, device=dev),
            r(B, Q, M * L * P * 2, k=3.0), r(B, Q, M * L * P))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,P,Q", [(2, 16, 2, 150), (8, 32, 4, 37), (1, 5, 3, 9)])
def test_proj_kernel(dev, dtype, M, D, P, Q):
    a = _proj_single(dev, Q=Q, M=M, D=D, P=P, dtype=dtype)
    before = K.msda_proj.launches
    got = K.msda_proj(a[0], SHAPES, *a[1:])
    assert K.msda_proj.launches == before + 1
    _close(got, K.msda_proj_plain(a[0], SHAPES, *a[1:]), dtype)


def test_proj_kernel_and_plain_version_share_their_locations(dev):
    """Equal f32 locations: with one-hot attention on one tap and a value
    that is its own raster index, a tap that floors differently would move
    the output by a whole pixel."""
    value, ref, off, logit = _proj_single(dev, M=1, D=1, P=1, Q=4000)
    logit = torch.full_like(logit, -30.0)
    logit[..., 0] = 30.0
    value = torch.arange(S, device=dev, dtype=torch.float32).reshape(1, S, 1, 1).repeat(2, 1, 1, 1)
    got = K.msda_proj(value, SHAPES, ref, off, logit)
    want = K.msda_proj_plain(value, SHAPES, ref, off, logit)
    assert (got - want).abs().max() < 1e-3


def test_proj_function_gives_gradients(dev):
    """K8 on inputs that require grad: K7 gives the gradients of the value,
    references, offsets and logits, none zero, equal to the plain version's."""
    a = _proj_single(dev)
    before = (K.msda_proj.launches, K.msda_rows_bwd.launches)
    got = _grads(lambda *t: K.msda_proj(t[0], SHAPES, *t[1:]), a)
    assert (K.msda_proj.launches, K.msda_rows_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = _grads(lambda *t: K.msda_proj_plain(t[0], SHAPES, *t[1:]), a)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        _close(g, w, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,G,D,Q", [(2, 1, 32, 9), (1, 3, 5, 33), (2, 2, 72, 20)])
def test_taps_bwd_kernel(dev, dtype, M, G, D, Q):
    """K9 at grouped heads and ragged widths; bf16 against the plain version
    on the upcast inputs. Some indices lie outside their level."""
    value, loc, att, grad = _rows_inputs(dev, dtype, 2, Q, M * G, D, 2, L, seed=6)
    value = value[:, :, :M].contiguous()
    idx, wt = K.taps(SHAPES, loc, att)
    idx[:, :, ::3, :, 0] = -1
    idx[:, :, 1::3, :, 1] = 10 ** 6
    got_v, got_w = K.msda_taps_bwd(value, SHAPES, idx, wt, grad)
    want_v, want_w = K.msda_taps_bwd_plain(value.float(), SHAPES, idx, wt, grad.float())
    assert got_v.dtype == dtype and got_w.dtype == torch.float32
    _close(got_v, want_v, dtype)
    _close(got_w, want_w, torch.float32)
    assert (got_w[:, :, ::3, :, 0] == 0).all() and (got_w[:, :, 1::3, :, 1] == 0).all()


def test_taps_function_gives_gradients(dev):
    """The q-major op on inputs that require grad: K6 forward, K9 backward,
    gradients of the value, locations and weights equal to the plain
    version's; taps outside the map get exactly zero."""
    value, loc, att, _ = _rows_inputs(dev, torch.float32, 2, 9, 2, 32, 2, L, seed=7)
    loc[:, 0] = -3.0                                     # every tap of query 0 is dead
    before = (K.msda_rows.launches, K.msda_taps_bwd.launches, K.msda_rows_bwd.launches)
    got = _grads(lambda v, l, a: K.msda_taps(v, SHAPES, l, a), (value, loc, att))
    assert (K.msda_rows.launches, K.msda_taps_bwd.launches, K.msda_rows_bwd.launches) \
        == (before[0] + 1, before[1] + 1, before[2])
    want = _grads(lambda v, l, a: ms_deform_attn(v, SHAPES, l, a), (value, loc, att))
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        _close(g, w, torch.float32)
    assert (got[1][:, 0] == 0).all() and (got[2][:, 0] == 0).all()


def _fields(dev, dtype, cin, cout, h, w, seed=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    return [r(3, cin, h, w).to(dtype), r(3, 18, h, w, k=2.5).to(dtype),
            (torch.rand(3, 9, h, w, generator=g, device=dev) * 2).to(dtype),
            r(3, 3, cin, cout, k=1 / (9 * cin) ** 0.5).to(dtype), r(cout)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,h,w", DCN_SHAPES)
def test_deform_conv2d_kernel(dev, dtype, cin, cout, h, w):
    x, offset, mask, weight, bias = _fields(dev, dtype, cin, cout, h, w)
    before = deform_conv2d.launches
    got = deform_conv2d(x, offset, mask, weight, bias)
    assert deform_conv2d.launches == before + 1 and got.dtype == dtype
    want = deform_conv2d_plain(x, offset, mask, weight) + bias[None, :, None, None]
    _close(got, want, dtype)


def test_deform_conv2d_gives_gradients(dev):
    """With a gradient wanted the op takes the K6/K7 route, not K10."""
    a = _fields(dev, torch.float32, 40, 24, 7, 9)
    before = (K.msda_rows.launches, K.msda_rows_bwd.launches, deform_conv2d.launches)
    got = _grads(lambda *t: deform_conv2d(*t), a)
    assert (K.msda_rows.launches, K.msda_rows_bwd.launches, deform_conv2d.launches) \
        == (before[0] + 1, before[1] + 1, before[2])
    want = _grads(lambda x, o, m, w, b: deform_conv2d_plain(x, o, m, w)
                  + b[None, :, None, None], a)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        _close(g, w, torch.float32)
