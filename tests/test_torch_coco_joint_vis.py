"""COCO joint training (`DATASETS.DEVIS.COCO_JOINT_TRAINING`) in the port
against the JAX package, on the CPU:

- the five OpenCV functions of `devis_torch.datasets.warp` against cv2 (the
  OpenCV these tests run with): `get_perspective_transform` and
  `get_rotation_matrix_2d` to 1e-12; `warp_perspective_nearest` on uint8
  masks equal; `warp_perspective_linear` on f32 images of 0..255 within
  1e-2 grey levels (equal to the bit where the width is a multiple of 16;
  OpenCV's scalar tail columns round differently elsewhere) and `filter2d`
  with the 9 x 9 and 11 x 11 motion-blur kernels within 1e-4 grey levels
  (OpenCV filters kernels of 50 taps or more through a DFT);
- `CocoJointVIS` at the same seed gives the JAX dataset's clips: labels,
  masks, valid and exists equal, boxes to 1e-5 and images to 1e-4 (after
  normalisation; the warp's last bits);
- `build_vis` with the flag gives a concatenation of the JAX lengths, its
  joint part with the YT-19 or YT-21 category map.
"""
import random

import cv2
import numpy as np
import pytest

from devis_torch.datasets import warp

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(48, 64), (120, 200), (33, 47), (64, 48), (37, 130)]


def _warp_case(seed, h, w):
    r = random.Random(seed)
    m = 0.08
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + np.float32([[r.uniform(-m, m) * w, r.uniform(-m, m) * h] for _ in range(4)])
    ang = r.uniform(-20, 20)
    shift = (r.uniform(-0.1, 0.1) * w, r.uniform(-0.1, 0.1) * h)
    return src, dst, ang, shift


@pytest.mark.parametrize("seed,hw", list(enumerate(SIZES)))
def test_warp_functions_match_cv2(seed, hw):
    h, w = hw
    src, dst, ang, shift = _warp_case(seed, h, w)
    persp = warp.get_perspective_transform(src, dst)
    np.testing.assert_allclose(persp, cv2.getPerspectiveTransform(src, dst), rtol=0,
                               atol=1e-12)
    aff = warp.get_rotation_matrix_2d((w / 2, h / 2), ang, 1.0)
    np.testing.assert_allclose(aff, cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0),
                               rtol=0, atol=1e-12)
    aff[0, 2] += shift[0]
    aff[1, 2] += shift[1]
    mat = np.vstack([aff, [0, 0, 1]]).astype(np.float32) @ persp
    rs = np.random.RandomState(seed)
    img = cv2.GaussianBlur((rs.rand(h, w, 3) * 255).astype(np.float32), (5, 5), 0)
    got = warp.warp_perspective_linear(img, mat, (w, h))
    want = cv2.warpPerspective(img, mat, (w, h), flags=cv2.INTER_LINEAR)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-2
    if w % 16 == 0:
        assert np.array_equal(got, want)
    assert (want == 0).any()                                  # the border is reached
    mask = (rs.rand(h, w) > 0.5).astype(np.uint8)
    assert np.array_equal(warp.warp_perspective_nearest(mask, mat, (w, h)),
                          cv2.warpPerspective(mask, mat, (w, h), flags=cv2.INTER_NEAREST))
    for k in (9, 11):
        kernel = np.zeros((k, k), np.float32)
        c = (k - 1) / 2
        a = np.deg2rad(rs.uniform(0, 180))
        for i in np.linspace(-c, c, k):
            kernel[int(round(c + i * np.sin(a))), int(round(c + i * np.cos(a)))] = 1
        kernel /= kernel.sum()
        got = warp.filter2d(img, kernel)
        assert got.dtype == np.float32
        assert np.abs(got - cv2.filter2D(img, -1, kernel)).max() <= 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from devis_torch.util.fixtures import write_coco_tree, write_vis_tree
    root = str(tmp_path_factory.mktemp("joint"))
    write_vis_tree(root, seed=1, n_train=2, n_val=1, n_frames=4, size=(40, 64))
    write_vis_tree(root, seed=2, n_train=1, n_val=1, n_frames=4, size=(40, 64),
                   version="2021")
    return write_coco_tree(root, seed=4, n_train=5, n_val=1, sizes=((48, 64), (64, 48)))


def test_clips_match_jax(tree, monkeypatch):
    from devis_torch.datasets import coco_joint_vis as cj
    from devis_torch.datasets.coco_joint_vis import COCO_TO_YT19_CATEGORY_MAP, CocoJointVIS
    from devis_tpu.datasets.coco_joint_vis import CocoJointVIS as JaxJoint
    blurred = []
    monkeypatch.setattr(cj, "filter2d", lambda img, k: blurred.append(k.shape)
                        or warp.filter2d(img, k))
    kw = dict(num_frames=4, category_map=COCO_TO_YT19_CATEGORY_MAP, seed=3,
              scale_factor=0.25)
    args = (f"{tree}/COCO/train2017", f"{tree}/COCO/annotations/instances_train2017.json")
    ds, jds = CocoJointVIS(*args, **kw), JaxJoint(*args, **kw)
    assert ds.ids == jds.ids and len(ds) > 1
    for rounds in range(2):                        # the generators run on across epochs
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert got.keys() == want.keys()
            for k in ("labels", "masks", "valid", "exists"):
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-5)
            assert got["images"].shape == want["images"].shape
            np.testing.assert_allclose(got["images"], want["images"], rtol=0, atol=1e-4)
            assert got["video_id"] == want["video_id"] == -1
        assert ds.rng.getstate() == jds.rng.getstate()
        assert ds.transform.rng.getstate() == jds.transform.rng.getstate()
    assert blurred                                 # the motion blur was drawn


@pytest.mark.parametrize("split", ["yt_vis_train_19", "yt_vis_train_21"])
def test_build_vis_with_the_flag_matches_jax(tree, split):
    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets import build_dataset
    from devis_torch.datasets.coco_joint_vis import (COCO_TO_YT19_CATEGORY_MAP,
                                                     COCO_TO_YT21_CATEGORY_MAP)
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.datasets import build_dataset as jax_build

    def cfg_of(get):
        cfg = get()
        cfg.DATASETS.TYPE = "vis"
        cfg.DATASETS.DATA_PATH = tree
        cfg.DATASETS.TRAIN_DATASET = split
        cfg.DATASETS.DEVIS.COCO_JOINT_TRAINING = True
        cfg.MODEL.DEVIS.NUM_FRAMES = 3
        cfg.INPUT.SCALE_FACTOR_TRAIN = 0.25
        return cfg
    ds, n = build_dataset("TRAIN", cfg_of(get_cfg_defaults))
    jds, jn = jax_build("TRAIN", cfg_of(jax_cfg))
    assert n == jn
    assert [len(d) for d in ds.datasets] == [len(d) for d in jds.datasets] and len(ds) == len(jds)
    joint = ds.datasets[1]
    assert joint.category_map is (COCO_TO_YT19_CATEGORY_MAP if "19" in split
                                  else COCO_TO_YT21_CATEGORY_MAP)
    got, want = ds[len(ds) - 1], jds[len(jds) - 1]
    assert np.array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["images"], want["images"], rtol=0, atol=1e-4)
