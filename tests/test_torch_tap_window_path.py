"""K1 on K2's windows, on the CPU: the windowed plain version (per-level
staging capacities, corners outside the staged rows read in place) against
the plain K1 and the JAX package's `ms_deform_attn_temporal_proj` (Pallas in
interpret mode); `window_plan` against the shared memory of an H100 SM; the
wrappers' counts; the kernel lab's plain modes. f32 throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_temporal_proj
from devis_torch.models.attention import (sampling_offsets_bias_init,
                                          temporal_sampling_offsets_bias_init)
from devis_torch.models.transformer import encoder_reference_points
from devis_torch.ops import ms_deform_attn_cuda as K
from devis_torch.ops.msda_lab import MODES, lab_temporal_proj
from devis_torch.ops.ms_deform_attn import rule_window, temporal_frame_table

from .test_torch_msda import _jax_proj_args
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
RULES = [("all",), ("window", (-1, 1))]
CLIP_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))
Q_BLOCK = 16                      # a few raster lines of level 0 a block
FITTED = tuple(h * w for h, w in SHAPES)   # every window fits its level
OVERFLOW = (16, 8, 4)             # a line or less a level: most windows overflow


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _raster_inputs(rng, rule, shapes=SHAPES, T=3, M=2, D=16, P=2, noise=1.0, n_queries=None):
    """Encoder inputs with raster-ordered pixel-centre references (the first
    `n_queries` pixels of the level stack are the queries, all of them by
    default) and the reference init's offsets (head direction times point
    index + 1, in pixels) plus N(0, noise) pixels."""
    Ln = len(shapes)
    S_ = sum(h * w for h, w in shapes)
    Q = n_queries or S_
    W = rule_window(rule, T)
    ref = encoder_reference_points(shapes, torch.ones(1, Ln, 2))[:, :Q]
    c_bias = sampling_offsets_bias_init(M, Ln, P)
    t_bias = temporal_sampling_offsets_bias_init(M, Ln, W, P)
    return dict(
        value=rng.rand(T, S_, M, D).astype(np.float32),
        ref=np.repeat(ref.numpy(), T, 0),
        c_off=(c_bias + rng.randn(T, Q, c_bias.size) * noise).astype(np.float32),
        t_off=(t_bias + rng.randn(T, Q, t_bias.size) * noise).astype(np.float32),
        c_logit=rng.randn(T, Q, M * Ln * P).astype(np.float32),
        t_logit=rng.randn(T, Q, M * W * Ln * P).astype(np.float32))


def _args(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return (t["value"], SHAPES, t["ref"], t["c_off"], t["t_off"], t["c_logit"],
            t["t_logit"])


def _poison_outside_windows(value, windows, rule, q_block=Q_BLOCK):
    """NaN on every value row (frame, pixel, head) that no window of any
    block reads; returns the poisoned copy and the poisoned share."""
    T, _, M, _ = value.shape
    W = rule_window(rule, T)
    frames = np.concatenate([np.arange(T)[:, None],
                             temporal_frame_table(rule, T).reshape(T, W)], 1)
    starts = np.cumsum([0] + [h * w for h, w in SHAPES])
    read = np.zeros(value.shape[:3], bool)
    win = windows.numpy()
    for t in range(T):
        for m in range(M):
            for b in range(win.shape[2]):
                for s in range((1 + W) * L):
                    first, last = win[t, m, b, s]
                    if last >= 0:
                        lo = starts[s % L]
                        read[frames[t, s // L], lo + first:lo + last + 1, m] = True
    out = value.clone()
    out[torch.from_numpy(~read)] = float("nan")
    return out, float((~read).mean())


_JAX = {}


def _jax_reference(a, rule):
    """The JAX op on the same inputs (Pallas interpret mode), once a rule."""
    key = rule[0]
    if key not in _JAX:
        Q = a["ref"].shape[1]
        q_pad = -(-Q // 128) * 128
        _JAX[key] = np.asarray(ms_deform_attn_temporal_proj(
            jnp.asarray(a["value"]), SHAPES, *_jax_proj_args(a, q_pad), Q, rule, q_tile=128))
    return _JAX[key]


@pytest.mark.parametrize("plan", ["fitted", "overflow"])
@pytest.mark.parametrize("rule", RULES)
def test_windowed_plain_matches_plain_and_jax(rule, plan):
    """The first 48 raster queries (three lines of level 0) in q-blocks of
    16 on K2's windows, staged in full (every window fits; the value outside
    every window, 0.44 of it, is NaN) or cut to a line a level (most
    windows overflow and their other corners are read in place): the result
    is the plain K1's and the JAX op's."""
    a = _raster_inputs(np.random.RandomState(3), rule, n_queries=48)
    value, *rest = _args(a)
    windows = K.msda_tap_window_plain(SHAPES, rest[1], rest[2], rest[3], 2, q_block=Q_BLOCK)
    want = K.msda_temporal_proj_plain(value, *rest, rule)
    caps = FITTED if plan == "fitted" else OVERFLOW
    if plan == "fitted":
        value, poisoned = _poison_outside_windows(value, windows, rule)
        assert poisoned > 0.25
    got, reads = K.msda_temporal_proj_windowed_plain(value, *rest, rule, windows, caps,
                                                     q_block=Q_BLOCK)
    assert torch.isfinite(got).all()
    # f32; the two sum the corners in another order
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _jax_reference(a, rule), rtol=1e-5, atol=1e-5)
    assert reads[0] == 0                       # a window never misses a tap
    n = windows[..., 1] - windows[..., 0] + 1
    over = (n > torch.tensor(caps).repeat(1 + rule_window(rule, 3))).float().mean()
    if plan == "fitted":
        assert reads[1] == 0 and over == 0
    else:
        assert reads[1] > 0 and over > 0.5


def test_windowed_plain_at_the_clip_pyramid():
    """The clip's pyramid (T = 2, one head of 8 channels) at K1's q-block and
    `window_plan` in bf16: raster references and the init's offsets. A
    level-0 query block's windows fit; every read outside the staged rows is
    in a window that overflows; the result is the plain K1's."""
    rng = np.random.RandomState(4)
    a = _raster_inputs(rng, ("all",), CLIP_SHAPES, T=2, M=1, D=8, P=4)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = (t["value"], CLIP_SHAPES, t["ref"], t["c_off"], t["t_off"], t["c_logit"],
            t["t_logit"], ("all",))
    plan = K.window_plan(CLIP_SHAPES, torch.bfloat16)
    windows = K.msda_tap_window_plain(CLIP_SHAPES, t["ref"], t["c_off"], t["t_off"], 1)
    got, reads = K.msda_temporal_proj_windowed_plain(*args, windows, plan)
    np.testing.assert_allclose(got.numpy(), K.msda_temporal_proj_plain(*args).numpy(),
                               rtol=1e-5, atol=1e-5)
    n = (windows[..., 1] - windows[..., 0] + 1).numpy()
    level0_blocks = 48 * 80 // K.Q_BLOCK
    assert (n[:, :, :level0_blocks] <= np.tile(plan, 2)).all()
    assert reads[0] == 0 and reads[1] > 0


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_plan_fits_shared_memory(dtype, blocks_per_sm):
    """Every plan fits 227 KB a block and `blocks_per_sm` blocks an SM, at
    any temporal window, and one more raster line a level would not."""
    for shapes in (CLIP_SHAPES, SHAPES):
        Ln = len(shapes)
        plan = K.window_plan(shapes, dtype, blocks_per_sm=blocks_per_sm)
        budget = min(K.SMEM_PER_BLOCK, K.SMEM_PER_SM // blocks_per_sm - K.SMEM_RESERVED)
        assert len(plan) == Ln
        for W in (0, 1, 5, 16):
            assert K.k1_smem_bytes(plan, Ln, W, dtype, 32, 4) <= budget <= 232448
        lines = [c // w for c, (_, w) in zip(plan, shapes)]
        assert all(c % w == 0 for c, (_, w) in zip(plan, shapes))
        k = max(lines)
        if k < max(h for h, _ in shapes):
            wider = tuple(min(h, k + 1) * w for h, w in shapes)
            assert K.k1_smem_bytes(wider, Ln, 1, dtype, 32, 4) > budget
    # more blocks an SM, fewer rows a block
    assert K.window_plan(CLIP_SHAPES, dtype, blocks_per_sm=blocks_per_sm + 1)[0] <= \
        K.window_plan(CLIP_SHAPES, dtype, blocks_per_sm=blocks_per_sm)[0]


def test_window_plan_raises_without_room_and_buffers_alternate():
    with pytest.raises(ValueError, match="no shared memory"):
        K.window_plan(CLIP_SHAPES, torch.float32, n_points=64, blocks_per_sm=4)
    # stage s = j * L + l loads into buffer s % 2: with L even a buffer holds
    # the even (odd) levels, with L odd both hold every level
    assert K.stage_buffer_rows((100, 50, 20, 10), 4, 5) == (100, 50)
    assert K.stage_buffer_rows((100, 50, 20), 3, 1) == (100, 100)
    assert K.stage_buffer_rows((100, 50, 20), 3, 0) == (100, 50)


def test_wrappers_on_the_cpu_count_plain_calls_only():
    """On CPU tensors K1 runs its plain version and launches nothing: no K1
    and no K2."""
    a = _raster_inputs(np.random.RandomState(5), ("all",))
    args = _args(a)
    ops = (K.msda_temporal_proj, K.msda_tap_window)
    before = [(fn.plain_calls, fn.launches) for fn in ops]
    out = K.msda_temporal_proj(*args, ("all",))
    assert torch.equal(out, K.msda_temporal_proj_plain(*args, ("all",)))
    assert [(fn.plain_calls, fn.launches) for fn in ops] == \
        [(before[0][0] + 1, before[0][1]), before[1]]


def test_lab_modes_on_the_cpu():
    """`full`, `nostage` and `count` give K1's result through the windowed
    plain version (count with its counters, nostage reading every corner in
    place); the other modes have no plain version and raise."""
    a = _raster_inputs(np.random.RandomState(6), ("all",))
    value, *rest = _args(a)
    windows = K.msda_tap_window_plain(SHAPES, rest[1], rest[2], rest[3], 2)
    want = K.msda_temporal_proj_plain(value, *rest, ("all",))
    plan = K.window_plan(SHAPES, torch.float32)
    before = (lab_temporal_proj.plain_calls, lab_temporal_proj.launches)
    outs = {}
    for mode in ("full", "nostage", "count"):
        outs[mode] = lab_temporal_proj(value, *rest, ("all",), windows, plan, mode)
        np.testing.assert_allclose(outs[mode][0].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert outs["full"][1] is None and outs["count"][1].tolist() == [0, 0]
    assert torch.equal(outs["full"][0], outs["nostage"][0])
    assert (lab_temporal_proj.plain_calls, lab_temporal_proj.launches) == \
        (before[0] + 3, before[1])
    for mode in set(MODES) - {"full", "nostage", "count"}:
        with pytest.raises(ValueError, match="only on a CUDA device"):
            lab_temporal_proj(value, *rest, ("all",), windows, plan, mode)
    with pytest.raises(ValueError, match="not one of"):
        lab_temporal_proj(value, *rest, ("all",), windows, plan, "batched")
