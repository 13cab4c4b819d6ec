"""K9's launch plan and index arithmetic on the CPU (`taps_plan`,
`taps_lanes`, `msda_taps_bwd_mirror` in `devis_torch/ops/ms_deform_attn_cuda.py`).

The kernel (`csrc/ms_deform_attn_taps.cu`) runs only on the card; these tests
hold the CPU mirror of its lane groups and chunks to the plain version,
`msda_taps_bwd_plain`, which `tests/test_torch_coco_ops.py` holds against the
JAX package's `_bwd_kernel` (Pallas interpret mode). The kernel itself is
held to the plain version on the card (`tests/test_torch_kernels_cuda.py`)."""
import collections

import numpy as np
import pytest
import torch

from devis_torch.ops import ms_deform_attn_cuda as K

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
COCO_SHAPES = ((104, 168), (52, 84), (26, 42), (13, 21))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [1, 5, 8, 32, 72])
@pytest.mark.parametrize("aligned", [True, False])
def test_taps_plan_takes_every_channel_of_every_entry_once(D, dtype, aligned):
    """Every (entry, channel) pair of a warp is loaded by exactly one lane
    of exactly one group, and added onto grad_value by exactly one lane of
    that group (the flush's split), at L 3 x 4P 8 entries (a partial run of
    32) and at the image decoder's 64; each entry stays within one group."""
    plan = K.taps_plan(D, DTYPES[dtype], aligned)
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.lanes * plan.per * plan.cw >= D and plan.per in (1, 2, 4)
    for n in (24, 64):
        owner = {}
        for flush in (False, True):
            taken = collections.Counter()
            for e, grp, sub, chans in K.taps_lanes(plan, n, D, flush):
                assert sub < plan.lanes and grp < 32 // plan.lanes
                assert owner.setdefault(e, grp) == grp
                taken.update((e, c) for c in chans)
            assert set(taken) == {(e, c) for e in range(n) for c in range(D)}
            assert set(taken.values()) == {1}


def test_taps_plan_at_the_paths_shape_and_its_limit():
    """D 32: 4 lanes an entry in bf16 and 8 in f32 with 16-byte chunks, 32
    one-channel lanes unaligned; more chunks than 4 a lane in a warp is
    refused."""
    assert K.taps_plan(32, torch.bfloat16, True) == K.TapsPlan(True, 8, 4, 4, 1)
    assert K.taps_plan(32, torch.float32, True) == K.TapsPlan(True, 4, 8, 8, 1)
    assert K.taps_plan(32, torch.bfloat16, False) == K.TapsPlan(False, 1, 32, 32, 1)
    assert K.taps_plan(72, torch.float32, False).per == 4
    # the flush's pieces: one red of a group covers 64 contiguous bytes of
    # f32 in bf16 (lanes 0-3 at channels 0-15, then 16-31), 128 in f32
    for dtype, span in ((torch.bfloat16, 16), (torch.float32, 32)):
        plan = K.taps_plan(32, dtype, True)
        pieces = [(sub, chans) for e, _, sub, chans in K.taps_lanes(plan, 1, 32, True)]
        for k in range(32 // span):
            first = [chans[0] for sub, chans in pieces[k::32 // span]]
            assert first == list(range(k * span, (k + 1) * span, span // plan.lanes))
    with pytest.raises(ValueError, match="more than a warp"):
        K.taps_plan(129, torch.float32, False)


def _inputs(seed, B, Q, M, G, D, P, shapes, dtype):
    rs = np.random.RandomState(seed)
    L = len(shapes)
    S_ = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rs.randn(B, S_, M, D).astype(np.float32)).to(dtype)
    loc = torch.from_numpy((rs.rand(B, Q, M * G, L, P, 2) * 1.4 - 0.2).astype(np.float32))
    att = torch.from_numpy(rs.rand(B, Q, M * G, L, P).astype(np.float32))
    grad = torch.from_numpy(rs.randn(B, Q, M * G * D).astype(np.float32)).to(dtype)
    idx, wt = K.taps(shapes, loc, att)
    return value, idx, wt, grad


def _close(got, want, rel):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.double().abs().max().item(), err


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [1, 5, 8, 32, 72])
@pytest.mark.parametrize("G", [1, 2, 3])
def test_mirror_equals_the_plain_version(D, dtype, G):
    """The mirror of K9's lane groups and chunks (the plan of the dtype,
    16-byte aligned) equals `msda_taps_bwd_plain` on the same inputs in f32
    to 1e-6 of max|plain| (f32 sums in another order), with indices below,
    inside and past their levels and some weights 0."""
    value, idx, wt, grad = _inputs(D * 10 + G, 2, 7, 2, G, D, 2, SHAPES, DTYPES[dtype])
    idx[:, :, ::3, :, 0] = -1
    idx[:, :, 1::3, :, 1] = 10 ** 6
    wt[:, :, 2::3, :, 2] = 0.0
    plan = K.taps_plan(D, DTYPES[dtype], True)
    got = K.msda_taps_bwd_mirror(value.float(), SHAPES, idx, wt, grad.float(), plan)
    want = K.msda_taps_bwd_plain(value.float(), SHAPES, idx, wt, grad.float())
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, 1e-6)
    assert (got[1][:, :, ::3, :, 0] == 0).all() and (got[1][:, :, 1::3, :, 1] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mirror_at_the_image_decoders_shape(dtype):
    """The image train step's decoder layers: B 2, Q 300, M 8, D 32 on the
    COCO pyramid (L 4, 64 entries a (b, m, q)), bf16 and f32 plans; 1e-6 of
    max|plain| as above."""
    value, idx, wt, grad = _inputs(11, 2, 300, 8, 1, 32, 4, COCO_SHAPES, DTYPES[dtype])
    plan = K.taps_plan(32, DTYPES[dtype], True)
    got = K.msda_taps_bwd_mirror(value.float(), COCO_SHAPES, idx, wt, grad.float(), plan)
    want = K.msda_taps_bwd_plain(value.float(), COCO_SHAPES, idx, wt, grad.float())
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
