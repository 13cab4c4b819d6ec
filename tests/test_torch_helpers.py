"""The public helpers the port's copies of otherwise ported files lacked,
against the JAX package's on the same seeded inputs: `util/box_ops.py`
(pairwise and elementwise IoU and GIoU to 1e-6, the boxes around masks and
non-maximum suppression exactly), `evaluation/rle.py` `compute_iou_matrix`
(exactly) and `tracking/inference_matcher.py` `build_inference_matcher`
(every cost and flag, from the repo's config files)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.evaluation import rle
from devis_torch.util import box_ops
from devis_tpu.evaluation import rle as rle_jax
from devis_tpu.util import box_ops as box_jax

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6           # f32 on both sides, the same operations


def _boxes(rs, n, degenerate=False):
    xy = rs.rand(n, 2).astype(np.float32) * 50
    wh = rs.rand(n, 2).astype(np.float32) * 30
    if degenerate:
        wh[::3] = 0.0                              # empty boxes: union clipped
    return np.concatenate([xy, xy + wh], -1)


@pytest.mark.parametrize("seed,degenerate", [(0, False), (1, True), (2, False)])
def test_box_iou_and_generalized_box_iou_equal_the_jax_ones(seed, degenerate):
    rs = np.random.RandomState(seed)
    a, b = _boxes(rs, 7, degenerate), _boxes(rs, 5, degenerate)
    iou, union = box_ops.box_iou(torch.from_numpy(a), torch.from_numpy(b))
    iou_j, union_j = box_jax.box_iou(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(union.numpy(), np.asarray(union_j), rtol=TOL, atol=TOL)
    giou = box_ops.generalized_box_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(giou.numpy(), np.asarray(box_jax.generalized_box_iou(
        jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=TOL)
    assert iou.shape == giou.shape == (7, 5)


@pytest.mark.parametrize("shape", [(6,), (3, 4), (2, 2, 5)])
def test_elementwise_generalized_box_iou_equals_the_jax_one(shape):
    rs = np.random.RandomState(len(shape))
    n = int(np.prod(shape))
    a, b = (_boxes(rs, n).reshape(*shape, 4) for _ in range(2))
    got = box_ops.elementwise_generalized_box_iou(torch.from_numpy(a), torch.from_numpy(b))
    want = box_jax.elementwise_generalized_box_iou(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.float32])
def test_masks_to_boxes_equals_the_jax_one(dtype):
    """Seeded blobs, a mask of one pixel at the far corner and an empty
    mask (a zero box)."""
    rs = np.random.RandomState(5)
    masks = np.zeros((4, 20, 30), dtype)
    masks[0, 3:9, 4:17] = 1
    masks[1] = rs.rand(20, 30) > 0.9
    masks[2, 19, 29] = 1
    got = box_ops.masks_to_boxes(torch.from_numpy(masks))
    want = np.asarray(box_jax.masks_to_boxes(jnp.asarray(masks)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert (want[3] == 0).all() and list(want[2]) == [29, 19, 30, 20]


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_nms_equals_the_jax_one(threshold):
    """Clusters of overlapping boxes with distinct scores, and a tie."""
    rs = np.random.RandomState(int(threshold * 10))
    centres = rs.rand(4, 2) * 100
    boxes = np.concatenate([np.concatenate([c + rs.randn(5, 2) * 3, c + 20 + rs.randn(5, 2) * 3],
                                           -1) for c in centres]).astype(np.float32)
    scores = rs.rand(20).astype(np.float32)
    scores[3] = scores[7]
    got = box_ops.nms(torch.from_numpy(boxes), torch.from_numpy(scores), threshold)
    want = np.asarray(box_jax.nms(jnp.asarray(boxes), jnp.asarray(scores), threshold))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert 0 < got.sum() < 20


@pytest.mark.parametrize("n1,n2", [(3, 4), (1, 1), (0, 2)])
def test_compute_iou_matrix_equals_the_jax_one(n1, n2):
    rs = np.random.RandomState(n1 * 10 + n2)
    m1 = [rle.encode(rs.rand(24, 32) > 0.6) for _ in range(n1)]
    m2 = [rle.encode(rs.rand(24, 32) > 0.4) for _ in range(n2)]
    got = rle.compute_iou_matrix(m1, m2)
    want = rle_jax.compute_iou_matrix(m1, m2)
    assert got.shape == (n1, n2) and np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("config", ["devis/YT-19/devis_R_50_YT-19.yaml",
                                    "devis/devis_R_50_visualization_YT-21.yaml",
                                    "devis/OVIS/devis_R_50_OVIS.yaml"])
def test_build_inference_matcher_equals_the_jax_one(config):
    from devis_torch.config import get_cfg_defaults
    from devis_torch.tracking.inference_matcher import build_inference_matcher
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.tracking.inference_matcher import \
        build_inference_matcher as jax_build_inference_matcher
    path = os.path.join(ROOT, "configs", config)
    cfg, jcfg = get_cfg_defaults(), jax_cfg()
    cfg.merge_from_file(path)
    jcfg.merge_from_file(path)
    cfg.TEST.CLIP_TRACKING.CENTER_COST = jcfg.TEST.CLIP_TRACKING.CENTER_COST = 0.5
    got, want = build_inference_matcher(cfg), jax_build_inference_matcher(jcfg)
    assert vars(got) == vars(want) and got.overlap_w == 6 - cfg.TEST.CLIP_TRACKING.STRIDE
