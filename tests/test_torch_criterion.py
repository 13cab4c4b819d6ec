"""The port's training-time pieces around the model against the JAX package
on the CPU, f32, on the same numpy inputs: bilinear resize, box ops, the
linear sum assignment, the clip matcher and every loss of the clip
criterion."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from devis_tpu.models import criterion as jcrit
from devis_tpu.models import matcher as jmatch
from devis_tpu.ops.hungarian import lsa as jax_lsa
from devis_tpu.ops.interpolate import resize_bilinear as jax_resize_bilinear
from devis_tpu.util import box_ops as jbox
from devis_torch.models import criterion as tcrit
from devis_torch.models import matcher as tmatch
from devis_torch.ops.hungarian import lsa, lsa_numpy
from devis_torch.ops.interpolate import resize_bilinear_hw
from devis_torch.util import box_ops as tbox

T, NQ, K, N = 3, 6, 5, 4          # frames, trajectories, classes, target slots
MCFG = dict(cost_class=2.0, cost_bbox=5.0, cost_giou=2.0, focal_alpha=0.25,
            use_l1_distance_sum=False)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _t(tree):
    return _map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _j(tree):
    return _map(jnp.asarray, tree)


@pytest.mark.parametrize("size", [(14, 18), (5, 4), (28, 11), (7, 9)])
def test_resize_bilinear_matches_jax_and_torch(rng, size):
    x = rng.randn(2, 3, 7, 9).astype(np.float32)
    got = resize_bilinear_hw(torch.from_numpy(x), size)
    want = jax_resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), size)
    # the same f32 interpolation matrices on both sides; product order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)
    ref = F.interpolate(torch.from_numpy(x), size=size, mode="bilinear",
                        align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def _boxes(rng, *shape):
    cxcy = rng.rand(*shape, 2) * 0.6 + 0.2
    wh = rng.rand(*shape, 2) * 0.3 + 0.05
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


def test_box_ops_match_jax(rng):
    a, b = _boxes(rng, T, NQ, 1), _boxes(rng, T, 1, N)
    xa, xb = tbox.box_cxcywh_to_xyxy(_t(a)), tbox.box_cxcywh_to_xyxy(_t(b))
    ja, jb = jbox.box_cxcywh_to_xyxy(_j(a)), jbox.box_cxcywh_to_xyxy(_j(b))
    np.testing.assert_allclose(xa.numpy(), np.asarray(ja), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tbox.box_xyxy_to_cxcywh(xa).numpy(), a, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbox.multi_giou(xa, xb).numpy(),
                               np.asarray(jbox.multi_giou(ja, jb)), rtol=0, atol=1e-6)
    same = tbox.box_cxcywh_to_xyxy(_t(_boxes(rng, T, NQ, 1)))
    np.testing.assert_allclose(
        tbox.multi_giou(xa, same).numpy(),
        np.asarray(jbox.elementwise_generalized_box_iou(ja, _j(same.numpy()))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,m", [(1, 1), (3, 10), (10, 10), (7, 30)])
def test_lsa_total_cost_matches_scipy_and_jax(rng, n, m):
    """Equal total cost; where assignments tie the solvers may choose
    differently."""
    from scipy.optimize import linear_sum_assignment
    for _ in range(5):
        cost = rng.randn(n, m).astype(np.float32)
        got = lsa_numpy(cost)
        assert got.shape == (n,) and len(set(got.tolist())) == n
        rows, cols = linear_sum_assignment(cost)
        total = cost[np.arange(n), got].astype(np.float64).sum()
        assert abs(total - cost[rows, cols].astype(np.float64).sum()) < 1e-5
        jcols = np.asarray(jax_lsa(jnp.asarray(cost)))
        assert abs(total - cost[np.arange(n), jcols].astype(np.float64).sum()) < 1e-5
    assert lsa(torch.from_numpy(cost)).dtype == torch.int64
    with pytest.raises(ValueError, match="n_rows <= n_cols"):
        lsa_numpy(np.zeros((3, 2)))


def test_run_lsa_neutralises_nan_and_invalid_columns(rng):
    cost = rng.randn(NQ, N).astype(np.float32)
    cost[2, 1] = np.nan
    cost[0, 0] = np.inf
    valid = np.array([True, True, False, True])
    got = tmatch.run_lsa(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    want = np.asarray(jmatch.run_lsa(jnp.asarray(cost)[None], jnp.asarray(valid)[None])[0])
    assert len(set(got.tolist())) == N
    # the valid columns' assignment is unique here (continuous random costs)
    np.testing.assert_array_equal(got[valid], want[valid])


def _clip_case(rng, with_masks=True, n_live=3):
    out = {"pred_logits": rng.randn(1, T * NQ, K).astype(np.float32),
           "pred_boxes": _boxes(rng, 1, T * NQ)}
    targets = {"labels": rng.randint(0, K, size=(N,)).astype(np.int32),
               "boxes": _boxes(rng, N, T),
               "valid": np.ones((N, T), bool), "exists": np.arange(N) < n_live}
    targets["valid"][0, 1] = False          # one instance hidden in one frame
    if with_masks:
        out["pred_masks"] = rng.randn(N, T, 6, 8).astype(np.float32)
        targets["masks"] = (rng.rand(N, T, 12, 16) > 0.6).astype(np.float32)
    return out, targets


@pytest.mark.parametrize("l1_sum", [False, True])
def test_clip_matcher_matches_jax(rng, l1_sum):
    out, tg = _clip_case(rng, with_masks=False)
    cfg = dict(MCFG, use_l1_distance_sum=l1_sum)
    live = tg["valid"] & tg["exists"][:, None]
    got = tmatch.hungarian_match_clip(_t(out["pred_logits"]), _t(out["pred_boxes"]),
                                      _t(tg["labels"]), _t(tg["boxes"]), _t(live), T, **cfg)
    want = jmatch.hungarian_match_clip(_j(out["pred_logits"]), _j(out["pred_boxes"]),
                                       _j(tg["labels"]), _j(tg["boxes"]), _j(live), T, **cfg)
    exists = tg["exists"]
    np.testing.assert_array_equal(got.numpy()[exists], np.asarray(want)[exists])
    assert len(set(got.tolist())) == N


@pytest.mark.parametrize("n_live", [3, 0])
def test_clip_criterion_losses_match_jax(rng, n_live):
    """Every loss of the criterion over the final level and two auxiliary
    levels (one with masks); with no instance at all every loss stays
    finite."""
    out, tg = _clip_case(rng, n_live=n_live)
    aux0, _ = _clip_case(rng, with_masks=False)
    aux1, _ = _clip_case(rng)
    out["aux_outputs"] = [aux0, {k: aux1[k] for k in ("pred_logits", "pred_boxes",
                                                      "pred_masks")}]
    # the model's training branch matches a level before it computes its
    # masks: fix those levels' indices as it does
    for level in (out, out["aux_outputs"][1]):
        level["indices"] = rng.permutation(NQ)[:N].astype(np.int64)
    want = jcrit.clip_criterion(_j(out), _j(tg), K, T, MCFG, 0.25, mask_on=True)
    got = tcrit.clip_criterion(_t(out), _t(tg), T, MCFG, 0.25, mask_on=True)
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(float(got[k])), k
        # f32 reductions in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_num_boxes_is_the_mean_over_clips():
    counts = [torch.tensor(6), torch.tensor(0), torch.tensor(3)]
    assert float(tcrit.reduce_num_boxes(counts)) == 3.0
    assert float(tcrit.reduce_num_boxes([torch.tensor(0)])) == 1.0


def test_weight_dict_matches_jax():
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_torch.config import get_cfg_defaults
    for weighting in (False, True):
        dicts = []
        for make in (jax_cfg, get_cfg_defaults):
            cfg = make()
            cfg.MODEL.MASK_ON = True
            cfg.MODEL.LOSS.AUX_LOSS_WEIGHTING = weighting
            dicts.append((jcrit if make is jax_cfg else tcrit).build_weight_dict(cfg))
        assert dicts[0] == dicts[1]
    losses = {"loss_ce": torch.tensor(2.0), "loss_mask_2": torch.tensor(3.0),
              "class_error": torch.tensor(50.0)}
    assert float(tcrit.weighted_total(losses, dicts[1])) == pytest.approx(
        2.0 * dicts[1]["loss_ce"] + 3.0 * dicts[1]["loss_mask_2"])
