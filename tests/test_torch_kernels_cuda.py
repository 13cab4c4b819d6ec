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


LINES = ((8, 16), (4, 8), (2, 4))      # powers of two: x = -1 and y = -1 exactly


def _tap_window_inputs(dev, rule, dtype, case):
    """K2's inputs: "random" as `_proj` gives them (M 2, P 2, Q 150, a
    partial q-block); "heads8" at the clip's head geometry (M 8, P 4, T 6:
    W 5 under the rule "all"); "partial" one q-block of 37 queries;
    "dead_block" the second of three q-blocks with references far outside
    the image (no live tap); "lines" a third of the queries with every tap
    on the line x = -1, a third on y = -1 (reference 0, offset -0.5 pixel).
    Returns (shapes, ref, c_off, t_off, M)."""
    if case in ("random", "dead_block", "lines"):
        T, Q, M, P = 3, (300 if case == "dead_block" else 150), 2, 2
    else:
        T, Q, M, P = 6, (37 if case == "partial" else 300), 8, 4
    shapes = LINES if case == "lines" else SHAPES
    g = torch.Generator(device=dev).manual_seed(5)
    W = rule_window(rule, T)
    ref = torch.rand(T, Q, L, 2, generator=g, device=dev)
    c_off = torch.randn(T, Q, M * L * P * 2, generator=g, device=dev) * 3
    t_off = torch.randn(T, Q, M * W * L * P * 2, generator=g, device=dev) * 3
    if case == "dead_block":
        ref[:, 128:256] = -5.0
    if case == "lines":
        for axis in (0, 1):
            q = torch.arange(axis, Q, 3, device=dev)
            ref[:, q, :, axis] = 0.0
            c_off.view(T, Q, -1, 2)[:, q, :, axis] = -0.5
            t_off.view(T, Q, -1, 2)[:, q, :, axis] = -0.5
    return shapes, ref, c_off.to(dtype), t_off.to(dtype), M


@pytest.mark.parametrize("case", ["random", "heads8", "partial", "dead_block", "lines"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", [("all",), ("window", (-1, 1))])
def test_tap_window_kernel(dev, rule, dtype, case):
    shapes, ref, c_off, t_off, M = _tap_window_inputs(dev, rule, dtype, case)
    got = K.msda_tap_window(shapes, ref, c_off, t_off, M)
    want = K.msda_tap_window_plain(shapes, ref, c_off, t_off, M)
    assert torch.equal(got, want)
    if case == "dead_block":
        assert (want[:, :, 1, :, 1] == -1).all() and (want[:, :, 1, :, 0] == 0).all()
    assert (want[..., 1] >= 0).any()


def _off_16_bytes(t):
    """A copy of `t` that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,P,aligned", [(8, 8, True), (8, 4, False), (2, 3, True),
                                         (2, 33, True)])
def test_tap_window_kernel_geometries(dev, dtype, M, P, aligned):
    """Each launch geometry `tap_window_plan` gives, through the op: heads
    split over blocks (M 8, P 8), offsets off 16 bytes and P not a multiple
    of the pairs in 16 bytes (one pair a load), and a query's loads
    outnumbering a block's threads (P 33)."""
    g = torch.Generator(device=dev).manual_seed(6)
    T, Q, W = 6, 150, 5
    ref = torch.rand(T, Q, L, 2, generator=g, device=dev)
    c_off = (torch.randn(T, Q, M * L * P * 2, generator=g, device=dev) * 3).to(dtype)
    t_off = (torch.randn(T, Q, M * W * L * P * 2, generator=g, device=dev) * 3).to(dtype)
    if not aligned:
        c_off, t_off = _off_16_bytes(c_off), _off_16_bytes(t_off)
    assert torch.equal(K.msda_tap_window(SHAPES, ref, c_off, t_off, M),
                       K.msda_tap_window_plain(SHAPES, ref, c_off, t_off, M))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_window_launcher_refuses_misaligned_vector_loads(dev, dtype):
    """The C launcher returns an error, and does not launch, where a plan of
    16-byte loads meets offsets off 16 bytes (a misaligned vector load would
    lose the context)."""
    shapes, ref, c_off, t_off, M = _tap_window_inputs(dev, ("all",), dtype, "heads8")
    T, Q = ref.shape[:2]
    W = t_off.shape[-1] // c_off.shape[-1]
    G, threads, vp = K.tap_window_plan(M, W, L, 4, dtype)
    assert vp > 1
    out = torch.empty((T, M, -(-Q // K.Q_BLOCK), (1 + W) * L, 2), dtype=torch.int32,
                      device=dev)
    fn = K._function(f"msda_tap_window_{K._DTYPES[dtype]}", 4, 8)
    for c, t in ((_off_16_bytes(c_off), t_off), (c_off, _off_16_bytes(t_off))):
        status = fn(ref.data_ptr(), c.data_ptr(), t.data_ptr(), out.data_ptr(), T, Q, M, 4,
                    K.Q_BLOCK, G, threads, vp, K._levels(shapes), L, W, K._stream(ref))
        assert status != 0
    torch.cuda.synchronize()
    assert torch.equal(K.msda_tap_window(shapes, ref, c_off, t_off, M),
                       K.msda_tap_window_plain(shapes, ref, c_off, t_off, M))


def test_tap_window_kernel_takes_an_empty_temporal_part(dev):
    """F = 1: the windows of the single-frame projection-fused attention."""
    _, ref, c_off, _, _, _ = _proj(dev, ("all",))
    t_off = c_off.new_zeros(c_off.shape[:2] + (0,))
    got = K.msda_tap_window(SHAPES, ref, c_off, t_off, 2)
    assert got.shape == (3, 2, 2, L, 2)
    assert torch.equal(got, K.msda_tap_window_plain(SHAPES, ref, c_off, t_off, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", [("all",), ("window", (-1, 1))])
@pytest.mark.parametrize("T,Q,M,D,P", [(3, 7, 2, 32, 2), (6, 1, 8, 32, 4), (6, 10, 8, 32, 4),
                                       (6, 10, 8, 16, 4), (3, 7, 2, 5, 2)])
def test_temporal_kernel(dev, dtype, rule, T, Q, M, D, P):
    """K3 at the decoder's head geometry (M 8, D 32, P 4, T 6) at Q 1 and
    10, at D 16, and at D 5 (rows not a whole number of 16-byte chunks)."""
    g = torch.Generator(device=dev).manual_seed(1)
    Lf = (1 + rule_window(rule, T)) * L
    value = torch.randn(T, S, M, D, generator=g, device=dev).to(dtype)
    loc = torch.rand(T, Q, M, Lf, P, 2, generator=g, device=dev) * 1.4 - 0.2
    att = torch.rand(T, Q, M, Lf, P, generator=g, device=dev)
    _close(K.msda_temporal(value, SHAPES, loc, att, rule),
           ms_deform_attn_temporal_plain(value, SHAPES, loc, att, rule), dtype)



# ---------------------------------------------------------------------------
# K1 on K2's windows: raster and random references, a plan that stages every
# window whole and one that stages a line a level (most windows overflow and
# their other corners are read from global memory), D whose rows are and are
# not 16-byte multiples; the kernel lab's modes
# ---------------------------------------------------------------------------

FITTED = tuple(h * w for h, w in SHAPES)
OVERFLOW = (16, 8, 4)


def _windowed(dev, refs, dtype, D=16, rule=("all",), T=3, M=2, P=2):
    """K1's inputs at every pixel of the pyramid as a query (raster-ordered
    pixel-centre references, as the encoder's) or at random references, and
    K2's windows of them."""
    g = torch.Generator(device=dev).manual_seed(11)
    W = rule_window(rule, T)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=dev) * k).to(dtype)  # noqa: E731
    if refs == "raster":
        ref = torch.cat([torch.stack(torch.meshgrid(
            (torch.arange(w, device=dev) + 0.5) / w, (torch.arange(h, device=dev) + 0.5) / h,
            indexing="xy"), -1).reshape(-1, 2) for h, w in SHAPES])
        ref = ref[None, :, None].expand(T, S, L, 2).contiguous()
    else:
        ref = torch.rand(T, S, L, 2, generator=g, device=dev)
    a = (r(T, S, M, D), ref, r(T, S, M * L * P * 2, k=2.0), r(T, S, M * W * L * P * 2, k=2.0),
         r(T, S, M * L * P), r(T, S, M * W * L * P))
    return a, K.msda_tap_window(SHAPES, ref, a[2], a[3], M)


@pytest.mark.parametrize("plan", [FITTED, OVERFLOW])
@pytest.mark.parametrize("refs", ["raster", "random"])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 16), (torch.bfloat16, 32),
                                     (torch.bfloat16, 12), (torch.float32, 5)])
def test_windowed_temporal_proj_kernel(dev, dtype, D, refs, plan):
    """The windowed K1 against the plain K1; in `count` mode its corners
    read from global memory are the windowed plain version's, none of them
    in a window that fits."""
    a, windows = _windowed(dev, refs, dtype, D)
    got, _ = K.launch_k1(a[0], SHAPES, *a[1:], ("all",), windows, plan)
    _close(got, K.msda_temporal_proj_plain(a[0], SHAPES, *a[1:], ("all",)), dtype)
    _, reads = K.launch_k1(a[0], SHAPES, *a[1:], ("all",), windows, plan, "count")
    _, want = K.msda_temporal_proj_windowed_plain(a[0], SHAPES, *a[1:], ("all",), windows,
                                                  plan)
    assert reads.tolist() == want.tolist() and reads[0] == 0
    assert (reads[1] > 0) == (plan == OVERFLOW)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", [("all",), ("window", (-1, 1))])
def test_windowed_temporal_proj_nostage_equals_full(dev, dtype, rule):
    """Reading every corner from global memory gives the staged kernel's
    result to the bit; the op launches K2 and then K1 on its windows."""
    a, windows = _windowed(dev, "raster", dtype, rule=rule)
    plan = K.window_plan(SHAPES, dtype, 16, 2)
    full, _ = K.launch_k1(a[0], SHAPES, *a[1:], rule, windows, plan)
    nostage, _ = K.launch_k1(a[0], SHAPES, *a[1:], rule, windows, plan, "nostage")
    assert torch.equal(full, nostage)
    before = (K.msda_temporal_proj.launches, K.msda_tap_window.launches)
    assert torch.equal(K.msda_temporal_proj(a[0], SHAPES, *a[1:], rule), full)
    assert (K.msda_temporal_proj.launches, K.msda_tap_window.launches) == \
        (before[0] + 1, before[1] + 1)


def test_lab_modes_launch(dev):
    from devis_torch.ops.msda_lab import MODES, lab_temporal_proj
    a, windows = _windowed(dev, "raster", torch.bfloat16)
    plan = K.window_plan(SHAPES, torch.bfloat16, 16, 2)
    before = lab_temporal_proj.launches
    for mode in MODES:
        out, reads = lab_temporal_proj(a[0], SHAPES, *a[1:], ("all",), windows, plan, mode)
        assert out.shape == (3, S, 32) and (reads is not None) == (mode == "count")
    torch.cuda.synchronize()
    assert lab_temporal_proj.launches == before + len(MODES)
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_k1(a[0], SHAPES, *a[1:], ("all",), windows, (8000, 10, 10))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_kernels_at_36_frames_on_one_level(dev, dtype):
    """K1 (on K2's windows), K3 and K5 at ablation 0's geometry: 36 frames
    under the rule "all" (W = 35, past the 16 offsets a window rule may
    hold), one level (the /32 map of the 320x576 canvas), M 8, D 32, P 4:
    36 stages a query, 144 taps."""
    shapes, rule, T, M, D, P = ((10, 18),), ("all",), 36, 8, 32, 4
    Q, W, Sx = 180, 35, 180
    g = torch.Generator(device=dev).manual_seed(11)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=dev) * k).to(dtype)  # noqa: E731
    args = (r(T, Sx, M, D), shapes, torch.rand(T, Q, 1, 2, generator=g, device=dev),
            r(T, Q, M * P * 2, k=2.0), r(T, Q, M * W * P * 2, k=2.0), r(T, Q, M * P),
            r(T, Q, M * W * P), rule)
    win = K.msda_tap_window(shapes, *args[2:5], M)
    assert win.shape == (T, M, 2, 36, 2)
    assert torch.equal(win, K.msda_tap_window_plain(shapes, *args[2:5], M))
    _close(K.msda_temporal_proj(*args), K.msda_temporal_proj_plain(*args), dtype)
    value, loc, att, grad = _rows_inputs(dev, dtype, T, 10, M, D, P, 36)
    value = r(T, Sx, M, D)
    _close(K.msda_temporal(value, shapes, loc, att, rule),
           ms_deform_attn_temporal_plain(value, shapes, loc, att, rule), dtype)
    got = K.msda_temporal_bwd(value, shapes, loc, att, grad, rule)
    want = K.msda_temporal_bwd_plain(value.float(), shapes, loc, att, grad.float(), rule)
    for a, b in zip(got, want):
        _close(a, b, dtype)
    with pytest.raises(ValueError, match="at most 16 offsets"):
        K.msda_temporal(value, shapes, loc, att, ("window", tuple(range(1, 36))))


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
# The kernels sum in another order than the plain versions; the f32 tolerance
# covers that, the bf16 one the output rounding.
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
@pytest.mark.parametrize("M,D,Q,case", [
    (1, 1, 70, "random"), (1, 5, 33, "random"), (2, 32, 9, "random"), (1, 72, 40, "random"),
    (1, 16, 40, "random"), (1, 264, 35, "random"), (1, 264, 40, "random"),
    (8, 32, 37, "random"), (1, 16, 48, "lines"), (1, 1, 48, "lines"), (1, 264, 48, "lines"),
    (8, 32, 37, "lines"), (1, 16, 48, "unaligned"), (8, 32, 48, "unaligned"),
    (1, 264, 48, "unaligned")])
def test_rows_kernels(dev, dtype, M, D, Q, case):
    """K6 in both regimes (a thread a chunk; taps spread over a warp, M 8,
    D 32), D 264 (33 or 66 chunks a unit); "lines": taps exactly on the
    pixel lines x = -1 and y = -1 (their corners inside the level weigh 0)
    and off the map; "unaligned": value and loc views off 16 and 8 bytes
    (element-by-element chunks; the wrapper copies loc). K7 on the same
    inputs."""
    value, loc, att, grad = _rows_inputs(dev, dtype, 2, Q, M, D, 2, L)
    if case == "lines":
        for lvl, (h, w) in enumerate(SHAPES):
            loc[:, 0::4, :, lvl, :, 0] = -0.5 / w          # on x = -1
            loc[:, 1::4, :, lvl, :, 1] = -0.5 / h          # on y = -1
            loc[:, 2::4, :, lvl, :, :] = 1.7               # off the map
    v_k, loc_k = value, loc
    if case == "unaligned":
        v_k, loc_k = _off_16_bytes(value), _off_16_bytes(loc)
        assert v_k.data_ptr() % 16 and loc_k.data_ptr() % 8
        assert not K.rows_plan(D, dtype, False, M, L, 2, 2 * Q).vec
    _close(K.msda_rows(v_k, SHAPES, loc_k, att),
           ms_deform_attn(value, SHAPES, loc, att), dtype)
    got = K.msda_rows_bwd(v_k, SHAPES, loc_k, att, grad)
    want = K.msda_rows_bwd_plain(value, SHAPES, loc, att, grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,D,P", [(2, 1, 32, 2), (4, 2, 16, 1), (2, 1, 264, 1),
                                     (4, 1, 5, 3)])
def test_rows_grouped_heads(dev, dtype, G, M, D, P):
    """K6 with G query heads a value head against the plain version (the
    value heads repeated), and its backward (K9) against autograd of the
    plain version; at the gates of the kernel tests."""
    value, loc, att, _ = _rows_inputs(dev, dtype, 2, 37, M * G, D, P, L)
    value = value[:, :, :M].contiguous()
    out = K.msda_taps(value, SHAPES, loc, att)
    assert out.shape == (2, 37, M * G * D) and out.dtype == dtype
    _close(out, ms_deform_attn(value, SHAPES, loc, att), dtype)
    rep = value.repeat_interleave(G, dim=2)
    _close(out, ms_deform_attn(rep, SHAPES, loc, att), dtype)
    vg, lg, ag = (t.detach().clone().requires_grad_() for t in (value, loc, att))
    grad = torch.randn_like(out)
    torch.autograd.backward(K.msda_taps(vg, SHAPES, lg, ag), grad)
    vp, lp, ap = (t.detach().clone().requires_grad_() for t in (value, loc, att))
    torch.autograd.backward(ms_deform_attn(vp, SHAPES, lp, ap), grad)
    for got, want in ((vg.grad, vp.grad), (ag.grad, ap.grad)):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_and_proj_launchers_refuse_misaligned_vector_access(dev, dtype):
    """The C launchers return an error, and do not launch, where a plan of
    16-byte access meets a value off 16 bytes."""
    value, loc, att, _ = _rows_inputs(dev, dtype, 2, 48, 1, 16, 1, L)
    shifted = _off_16_bytes(value)
    plan = K.rows_plan(16, dtype, True, 1, L, 1, 96)
    assert plan.vec
    out = torch.empty((2, 48, 16), dtype=dtype, device=dev)
    fn = K._function(f"msda_rows_{K._DTYPES[dtype]}", 4, 14)
    status = fn(shifted.data_ptr(), loc.data_ptr(), att.data_ptr(), out.data_ptr(), 2, 48, S,
                1, 1, 16, 1, 1, plan.lanes, plan.groups, plan.slices, plan.chunks, plan.units,
                plan.threads, K._levels(SHAPES), L, K._stream(value))
    assert status != 0
    a = _proj_single(dev, Q=20, M=8, D=32, P=4, dtype=dtype)
    out = torch.empty((2, 20, 8 * 32), dtype=dtype, device=dev)
    lanes = K.proj_plan(32, dtype, True).lanes
    fn = K._function(f"msda_proj_{K._DTYPES[dtype]}", 5, 8)
    status = fn(_off_16_bytes(a[0]).data_ptr(), a[1].data_ptr(), a[2].data_ptr(),
                a[3].data_ptr(), out.data_ptr(), 2, 20, S, 8, 32, 4, lanes, 1,
                K._levels(SHAPES), L, K._stream(out))
    assert status != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel", ["temporal", "rows"])
def test_backward_on_the_lines_x_and_y_minus_one(dev, kernel):
    """Taps exactly on the pixel lines x = -1 and y = -1: their corners
    inside the level carry weight 0, but the location's gradient is the
    plain version's (the JAX kernels' per-corner rule), not 0."""
    T = 3
    n_levels = T * L if kernel == "temporal" else L
    value, loc, att, grad = _rows_inputs(dev, torch.float32, T, 7, 2, 16, 2, n_levels, seed=12)
    for lvl in range(n_levels):
        h, w = SHAPES[lvl % L]
        loc[:, :, :, lvl, 0, 0] = -0.5 / w          # point 0 on x = -1
        loc[:, :, :, lvl, 1, 1] = -0.5 / h          # point 1 on y = -1
        assert (loc[:, :, :, lvl, 0, 0] * w - 0.5 == -1).all()
        assert (loc[:, :, :, lvl, 1, 1] * h - 0.5 == -1).all()
    if kernel == "temporal":
        got = K.msda_temporal_bwd(value, SHAPES, loc, att, grad, ("all",))
        want = K.msda_temporal_bwd_plain(value, SHAPES, loc, att, grad, ("all",))
    else:
        got = K.msda_rows_bwd(value, SHAPES, loc, att, grad)
        want = K.msda_rows_bwd_plain(value, SHAPES, loc, att, grad)
    assert want[1][..., :2, :].abs().amax() > 0
    for g, w in zip(got, want):
        _close(g, w, torch.float32)


# ---------------------------------------------------------------------------
# K5 and K7 in their fixed order (csrc/msda_bwd.cuh): raster references
# (every pixel of the pyramid a query at its centre, offsets of a pixel or
# two), random ones, the DCN route's grid, D from 1 to 264. Five launches on
# the same inputs give the same bits, and those bits are the CPU mirror's
# (`msda_bwd_mirror`: the same sort, the same order of every sum, each
# product and sum rounded on its own).
# ---------------------------------------------------------------------------

GRID = (9, 21)
REPEATS = 5


def _bwd_inputs(dev, dtype, refs, D, n_frames=2, rule=None, seed=13):
    """(shapes, value, loc, att, grad) of K7 (rule None) or K5."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    n_levels = L if rule is None else (1 + rule_window(rule, n_frames)) * L
    if refs == "grid":
        h, w = GRID
        shapes, M, P, n_levels = (GRID,) * 9, 1, 1, 9
        ys = torch.arange(h, device=dev).repeat_interleave(w).float()
        xs = torch.arange(w, device=dev).repeat(h).float()
        k = torch.arange(9, device=dev)
        off = r(n_frames, h * w, 9, 2) * 1.5
        loc = torch.stack([(xs[:, None] + (k % 3 - 1) + off[..., 1] + 0.5) / w,
                           (ys[:, None] + (k // 3 - 1) + off[..., 0] + 0.5) / h], -1)
        loc = loc.reshape(n_frames, h * w, M, 9, P, 2)
    else:
        shapes, M, P = SHAPES, 1 if D > 32 else 2, 2
        if refs == "raster":
            centre = torch.cat([torch.stack(torch.meshgrid(
                (torch.arange(w, device=dev) + 0.5) / w, (torch.arange(h, device=dev) + 0.5) / h,
                indexing="xy"), -1).reshape(-1, 2) for h, w in SHAPES])     # (S, 2)
            size = torch.tensor([[w, h] for h, w in SHAPES], device=dev, dtype=torch.float32)
            size = size[torch.arange(n_levels, device=dev) % L]
            loc = centre[None, :, None, None, None] + r(n_frames, S, M, n_levels, P, 2) * 1.5 \
                / size[:, None, :]
        else:
            loc = torch.rand(n_frames, 150, M, n_levels, P, 2, generator=g, device=dev) * 1.4 - 0.2
    S_v = sum(h * w for h, w in shapes)
    Q = loc.shape[1]
    return (shapes, r(n_frames, S_v, M, D).to(dtype), loc.contiguous(),
            torch.rand(n_frames, Q, M, n_levels, P, generator=g, device=dev),
            r(n_frames, Q, M * D).to(dtype))


def _bwd_close(got, want, dtype):
    # f32: sums in another order; bf16: the value gradient is rounded once
    # to bf16 (against the plain version on the inputs upcast to f32), the
    # row gradients stay f32
    tols = (1e-4, 1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-4, 1e-4)
    for gg, w, tol in zip(got, want, tols):
        assert gg.shape == w.shape
        err = (gg.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item()


def _repeat_equal(fn):
    """`fn()` REPEATS times: every run's tensors equal the first's, bit for
    bit. Returns the first."""
    first = [t.clone() for t in fn()]
    for _ in range(REPEATS - 1):
        again = fn()
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    return first


def _mirror(value, shapes, loc, att, grad, frames=None):
    cpu = [t.cpu() for t in (value, loc, att, grad)]
    return K.msda_bwd_mirror(cpu[0], shapes, cpu[1], cpu[2], cpu[3], frames)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("refs", ["raster", "random", "grid"])
@pytest.mark.parametrize("D", [1, 16, 32, 264])
def test_rows_bwd_kernel_in_a_fixed_order(dev, dtype, refs, D):
    shapes, value, loc, att, grad = _bwd_inputs(dev, dtype, refs, D)
    got = _repeat_equal(lambda: K.launch_rows_bwd(value, shapes, loc, att, grad))
    want = K.msda_rows_bwd_plain(value.float(), shapes, loc, att, grad.float())
    _bwd_close(got, want, dtype)
    for g, m in zip(got, _mirror(value, shapes, loc, att, grad)):
        assert torch.equal(g.cpu(), m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("refs", ["raster", "random"])
@pytest.mark.parametrize("rule,D", [(("all",), 32), (("window", (-1, 1)), 16)])
def test_temporal_bwd_kernel_in_a_fixed_order(dev, dtype, refs, rule, D):
    from devis_torch.ops.ms_deform_attn import temporal_frame_table
    shapes, value, loc, att, grad = _bwd_inputs(dev, dtype, refs, D, 3, rule)
    got = _repeat_equal(lambda: K.launch_temporal_bwd(value, shapes, loc, att, grad, rule))
    want = K.msda_temporal_bwd_plain(value.float(), shapes, loc, att, grad.float(), rule)
    _bwd_close(got, want, dtype)
    frames = torch.cat([torch.arange(3)[:, None],
                        torch.as_tensor(temporal_frame_table(rule, 3), dtype=torch.long)], 1)
    for g, m in zip(got, _mirror(value, shapes, loc, att, grad, frames)):
        assert torch.equal(g.cpu(), m)


@pytest.mark.parametrize("sort", [-1, 0, 100, 7])
@pytest.mark.parametrize("case", ["K5 all", "K5 window", "K7 random", "K7 grid"])
def test_bwd_routes_give_the_mirror_s_bits(dev, case, sort):
    """Every sort route of K5 and K7 (-1 the global radix sort; else the
    run-wise one, with buckets of RUN_BUCKET entries (0), of 100 or of 7:
    one pass or two) gives the CPU mirror's bits, five times: under `all`,
    under a window rule that repeats frames at the clip's edges, at random
    locations (dead taps, corners outside their level) and on the DCN
    route's grid."""
    from devis_torch.ops.ms_deform_attn import temporal_frame_table
    if case.startswith("K5"):
        rule = ("all",) if case == "K5 all" else ("window", (-2, -1, 1, 2))
        T = 3 if case == "K5 all" else 5
        shapes, value, loc, att, grad = _bwd_inputs(dev, torch.bfloat16, "random", 16, T, rule)
        got = _repeat_equal(lambda: K.launch_temporal_bwd(value, shapes, loc, att, grad, rule,
                                                          sort=sort))
        frames = torch.cat([torch.arange(T)[:, None],
                            torch.as_tensor(temporal_frame_table(rule, T), dtype=torch.long)], 1)
    else:
        refs = "random" if case == "K7 random" else "grid"
        shapes, value, loc, att, grad = _bwd_inputs(dev, torch.bfloat16, refs, 16)
        got = _repeat_equal(lambda: K.launch_rows_bwd(value, shapes, loc, att, grad, sort=sort))
        frames = None
    for g, m in zip(got, _mirror(value, shapes, loc, att, grad, frames)):
        assert torch.equal(g.cpu(), m)


def test_bwd_ops_launch_and_raise(dev):
    """The ops launch the kernels on CUDA tensors (no plain call), return the
    value gradient in the value's dtype; inconsistent shapes raise."""
    shapes, value, loc, att, grad = _bwd_inputs(dev, torch.bfloat16, "grid", 16)
    before = (K.msda_rows_bwd.launches, K.msda_rows_bwd.plain_calls)
    got = K.msda_rows_bwd(value, shapes, loc, att, grad)
    assert (K.msda_rows_bwd.launches, K.msda_rows_bwd.plain_calls) == (before[0] + 1, before[1])
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    with pytest.raises(ValueError, match="inconsistent"):
        K.msda_rows_bwd(value, shapes, loc, att, grad[:, 1:].contiguous())


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
@pytest.mark.parametrize("M,D,P,Q,case", [
    (2, 16, 2, 150, "random"), (8, 32, 4, 37, "random"), (1, 5, 3, 9, "random"),
    (8, 32, 4, 301, "random"), (8, 32, 4, 301, "lines"), (8, 32, 4, 45, "unaligned"),
    (3, 8, 16, 7, "random")])
def test_proj_kernel(dev, dtype, M, D, P, Q, case):
    """K8 against its plain version: the image model's heads (M 8, D 32,
    P 4) at a Q no block size divides, the scalar path (D 5; a value off
    16 bytes), 48 taps a head (two runs of 32), taps exactly on x = -1 and
    y = -1 and off the map."""
    a = _proj_single(dev, Q=Q, M=M, D=D, P=P, dtype=dtype)
    if case == "lines":
        ref, off = a[1], a[2].float().reshape(2, Q, M, L, P, 2)
        ref[:, 0::3] = 0.0                      # pixel -0.5: offset -0.5 puts a tap on -1
        off[:, 0::3] = -0.5
        off[:, 1::3] = 40.0                     # off the map
        a = (a[0], ref, off.reshape(2, Q, -1).to(dtype), a[3])
    value = _off_16_bytes(a[0]) if case == "unaligned" else a[0]
    before = K.msda_proj.launches
    got = K.msda_proj(value, SHAPES, *a[1:])
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


COCO_SHAPES = ((104, 168), (52, 84), (26, 42), (13, 21))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,G,D,Q,B,shapes,P", [
    (2, 1, 32, 9, 2, SHAPES, 2), (1, 3, 5, 33, 2, SHAPES, 2), (2, 2, 72, 20, 2, SHAPES, 2),
    (1, 2, 10, 25, 2, SHAPES, 2), (8, 1, 32, 300, 2, COCO_SHAPES, 4)])
def test_taps_bwd_kernel(dev, dtype, M, G, D, Q, B, shapes, P):
    """K9 at grouped heads and ragged widths (D 5 and 10: one-channel
    chunks in f32 and bf16), and at the image train step's decoder shape
    (B 2, Q 300, M 8, D 32, the COCO pyramid); bf16 against the plain version
    on the upcast inputs. Some indices lie outside their level. Five
    launches give the same bits, the CPU mirror's."""
    g = torch.Generator(device=dev).manual_seed(6)
    value = torch.randn(B, sum(h * w for h, w in shapes), M, D, generator=g,
                        device=dev).to(dtype)
    loc = torch.rand(B, Q, M * G, len(shapes), P, 2, generator=g, device=dev) * 1.4 - 0.2
    att = torch.rand(B, Q, M * G, len(shapes), P, generator=g, device=dev)
    grad = torch.randn(B, Q, M * G * D, generator=g, device=dev).to(dtype)
    idx, wt = K.taps(shapes, loc, att)
    idx[:, :, ::3, :, 0] = -1
    idx[:, :, 1::3, :, 1] = 10 ** 6
    got_v, got_w = _repeat_equal(lambda: K.msda_taps_bwd(value, shapes, idx, wt, grad))
    want_v, want_w = K.msda_taps_bwd_plain(value.float(), shapes, idx, wt, grad.float())
    assert got_v.dtype == dtype and got_w.dtype == torch.float32
    _close(got_v, want_v, dtype)
    _close(got_w, want_w, torch.float32)
    assert (got_w[:, :, ::3, :, 0] == 0).all() and (got_w[:, :, 1::3, :, 1] == 0).all()
    mirror = K.msda_taps_bwd_mirror(value.cpu(), shapes, idx.cpu(), wt.cpu(), grad.cpu())
    assert torch.equal(got_v.cpu(), mirror[0]) and torch.equal(got_w.cpu(), mirror[1])


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


# ---------------------------------------------------------------------------
# K12a-K12c, the probes (measurement kernels, no model path)
# ---------------------------------------------------------------------------

def _band(dev, C=20, Wp=40, N=300, ncand=4, seed=0):
    from devis_torch.ops import probes
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(C, N + ncand * Wp, generator=g, device=dev)
    # every tap in the band: both bilinear corners at offsets -lo .. ncand-1-lo
    lo = (ncand - 1) // 2
    dy = torch.rand(N, generator=g, device=dev) * (ncand - 1.01) - lo
    dx = torch.rand(N, generator=g, device=dev) * (ncand - 1.01) - lo
    return probes, u, dy, dx


@pytest.mark.parametrize("ncand", [2, 4, 5])
@pytest.mark.parametrize("layout", ["aligned", "ragged", "shifted"])
def test_tent_band_and_corner_gather_kernels(dev, ncand, layout):
    """f32: multiply-adds fused or not, 1e-5 of max|plain|; a ragged channel
    tile (C 20) and n tile (N 300); K12a against K12b in the band. K12a's
    staging: 16-byte copies with each band row at one offset into its
    float4 ("aligned": Wp 40), 4-byte copies (rows of N + ncand Wp not a
    multiple of 4: N 301), 16-byte copies with the rows at every offset
    ("shifted": Wp 43)."""
    Wp = 43 if layout == "shifted" else 40
    N = {"aligned": 300, "ragged": 301, "shifted": 300 + (-(300 + ncand * Wp)) % 4}[layout]
    assert ((N + ncand * Wp) % 4 == 0) == (layout != "ragged")
    probes, u, dy, dx = _band(dev, Wp=Wp, N=N, ncand=ncand)
    args = (u, dy, dx, ncand, Wp, 3)
    tent = probes.tent_band(*args)
    gather = probes.corner_gather(*args)
    for got, want in ((tent, probes.tent_band_plain(*args)),
                      (gather, probes.corner_gather_plain(*args)), (tent, gather)):
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("n_dots,K,N,grid", [(4, 128, 128, 7), (3, 256, 256, 5),
                                             (2, 512, 256, 3), (1, 32, 64, 1),
                                             (5, 128, 192, 2), (1, 3072, 256, 3)])
def test_mma_probe_kernel(dev, n_dots, K, N, grid):
    """bf16 on seeded operands, shared-memory resident (K <= 256 at N 256) and
    streamed (K 512, 3072); every block stores the same tile: 2e-2 of
    max|plain|. At 1-5 dots a dropped or extra product is a 20-100 % error."""
    from devis_torch.ops import probes
    g = torch.Generator(device=dev).manual_seed(K + N)
    v = torch.randn(K, probes.D, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(K, N, generator=g, device=dev).to(torch.bfloat16)
    got = probes.mma_probe(v, w, n_dots, grid)
    torch.cuda.synchronize()
    want = probes.mma_probe_plain(v, w, n_dots)
    assert got.shape == (probes.D, N) and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("ncand", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("spread", [5.0, 40.0])
def test_corner_gather_kernel_outside_the_band(dev, ncand, spread):
    """K12b on taps that leave the band (offsets up to ±5: corners read
    from u past the staged rows) and past the array (±40: the clamp), ragged
    C (40: past a channel tile) and N (301: a partial last row), Wp not a
    multiple of the strip, 20 reps (past the rep table's 16): f32, 1e-5 of
    max|plain|."""
    from devis_torch.ops import probes
    g = torch.Generator(device=dev).manual_seed(ncand)
    C, Wp, N = 40, 43, 301
    u = torch.rand(C, N + ncand * Wp, generator=g, device=dev)
    dy = (torch.rand(N, generator=g, device=dev) * 2 - 1) * spread
    dx = (torch.rand(N, generator=g, device=dev) * 2 - 1) * spread
    args = (u, dy, dx, ncand, Wp, 20)
    got = probes.corner_gather(*args)
    torch.cuda.synchronize()
    want = probes.corner_gather_plain(*args)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


MMA_CASES = [(4, 128, 128, 7), (3, 256, 256, 5), (2, 512, 256, 3), (1, 32, 64, 1),
             (5, 128, 192, 2), (1, 3072, 256, 3), (3, 512, 256, 8)]


def _mma(dev, K, N):
    from devis_torch.ops import probes
    g = torch.Generator(device=dev).manual_seed(K + N)
    v = torch.randn(K, probes.D, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(K, N, generator=g, device=dev).to(torch.bfloat16)
    return probes, v, w


@pytest.mark.parametrize("n_dots,K,N,grid", MMA_CASES)
def test_mma_probe_sync_kernel(dev, n_dots, K, N, grid):
    """K12c's mma.sync form at `test_mma_probe_kernel`'s cases and an odd
    n_dots at a streamed K: bf16, 2e-2 of max|plain|, its own launch count."""
    probes, v, w = _mma(dev, K, N)
    before = (probes.mma_probe_sync.launches, probes.mma_probe.launches)
    got = probes.mma_probe_sync(v, w, n_dots, grid)
    torch.cuda.synchronize()
    assert (probes.mma_probe_sync.launches, probes.mma_probe.launches) == \
        (before[0] + 1, before[1])
    want = probes.mma_probe_plain(v, w, n_dots)
    assert got.shape == (probes.D, N) and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("n_dots,K,N,grid,cluster", [
    (3, 512, 256, 8, 1), (3, 512, 256, 8, 2), (3, 512, 256, 8, 4), (1, 3072, 256, 4, 4),
    (5, 1024, 128, 6, 2), (2, 80, 128, 3, 1), (3, 48, 64, 2, 1), (1, 16, 256, 1, 1)])
def test_mma_probe_kernel_clusters_and_ragged_tiles(dev, n_dots, K, N, grid, cluster):
    """K12c's wgmma form on streamed K tiles shared by clusters of 1, 2 and
    4 blocks (TMA multicast) with an odd n_dots (the zero tile), and on K
    below a tile (16, 48) or past the last whole one (80: rows past K read as
    zero): bf16, 2e-2 of max|plain|."""
    probes, v, w = _mma(dev, K, N)
    got = probes.mma_probe(v, w, n_dots, grid, cluster=cluster)
    torch.cuda.synchronize()
    want = probes.mma_probe_plain(v, w, n_dots)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()


def test_mma_probe_rejects_a_cluster_that_does_not_divide_the_grid(dev):
    probes, v, w = _mma(dev, 512, 256)
    with pytest.raises(ValueError, match="cluster"):
        probes.mma_probe(v, w, 2, 6, cluster=4)
