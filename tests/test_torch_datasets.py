"""The port's data pipeline against the JAX package's, sample by sample, on
seeded fixture trees written to disk (`devis_torch.util.fixtures`: a COCO
json with polygon, RLE (string and list counts) and crowd annotations and an
image without objects; a YouTube-VIS json with RLE segmentations and null
frames), the same seed on both sides:

- the train transforms (`ClipTransform`, `random_erasing_sample`,
  `photometric_distort`) on the same inputs;
- `CocoDetection` (train and val), `VISTrainDataset`,
  `VISValDataset.load_clip` and the synthetic datasets;
- `collate_images`, `collate_clip` and two epochs of `TrainLoader`.

Tolerances: images within 1e-4 of 255 grey levels (the port's bilinear
resize of 3-channel float images may differ from OpenCV's in the last bit,
and its HSV hue by a few ulp); masks, labels, validity and frame indices
equal; boxes to 1e-6. `load_clip`'s uint8 frames are equal where no resize
is needed and within one grey level where the fixed-point bilinear resize
runs (its documented difference, `datasets/transforms.py`).
"""
import random

import numpy as np
import pytest

from devis_torch.datasets import TrainLoader, collate_clip, collate_images, make_buckets
from devis_torch.datasets import coco as tcoco
from devis_torch.datasets import synthetic as tsyn
from devis_torch.datasets import transforms as ttr
from devis_torch.datasets import vis as tvis
from devis_torch.util.fixtures import write_coco_tree, write_vis_tree
from devis_tpu.datasets import TrainLoader as JTrainLoader
from devis_tpu.datasets import collate_clip as jcollate_clip
from devis_tpu.datasets import collate_images as jcollate_images
from devis_tpu.datasets import coco as jcoco
from devis_tpu.datasets import synthetic as jsyn
from devis_tpu.datasets import transforms as jtr
from devis_tpu.datasets import vis as jvis

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

IMG_ATOL = 1e-4 * 255                     # grey levels
NORM_ATOL = IMG_ATOL / 255 / 0.224        # after /255 and the ImageNet std
SEED = 5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_coco_tree(root, seed=1, n_train=5, n_val=3, sizes=((60, 80), (80, 60)))
    write_vis_tree(root, seed=2, n_train=2, n_val=2, n_frames=7, size=(48, 64))
    return root


def _assert_sample(got, want, image_key, atol):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, v in want.items():
        g = got[k]
        if k == image_key:
            assert g.shape == v.shape and g.dtype == v.dtype
            np.testing.assert_allclose(g, v, rtol=0, atol=atol, err_msg=k)
        elif k == "boxes":
            np.testing.assert_allclose(g, v, rtol=0, atol=1e-6, err_msg=k)
        elif isinstance(v, np.ndarray):
            assert g.dtype == v.dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            assert g == v, k


def _frames(seed, n=2, h=50, w=70):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        masks = np.zeros((3, h, w), np.uint8)
        masks[0, 5:30, 10:40] = 1
        masks[1, 30:48, 50:69] = 1
        masks[2, 0:3, 0:2] = 1
        out.append({"image": rs.uniform(0, 255, (h, w, 3)).astype(np.float32),
                    "boxes": np.asarray([[10, 5, 40, 30], [50, 30, 69, 48], [0, 0, 2, 3]],
                                        np.float32),
                    "masks": masks, "valid": np.ones(3, bool)})
    return out


@pytest.mark.parametrize("bbx_from_mask", [True, False])
def test_clip_transform_draws_as_the_jax_package(bbx_from_mask):
    kw = dict(scales=[40, 56, 64], max_size=100, scales_before_crop=[60, 70],
              crop_size=(30, 50), create_bbx_from_mask=bbx_from_mask)
    port = ttr.ClipTransform(rng=random.Random(SEED), **kw)
    ref = jtr.ClipTransform(seed=SEED, **kw)
    for trial in range(12):
        got, want = port(_frames(trial)), ref(_frames(trial))
        for g, w in zip(got, want):
            _assert_sample(g, w, "image", NORM_ATOL)


def test_photometric_distort_and_random_erasing_as_the_jax_package():
    rs = np.random.RandomState(0)
    for trial in range(20):
        img = rs.uniform(0, 255, (23, 31, 3)).astype(np.float32)
        kw = dict(brightness_delta=32.0) if trial % 2 else {}
        np.testing.assert_allclose(ttr.photometric_distort(img, random.Random(trial), **kw),
                                   jtr.photometric_distort(img, random.Random(trial), **kw),
                                   rtol=0, atol=IMG_ATOL)
        sample = _frames(trial, n=1)[0]
        got = ttr.random_erasing_sample(sample, random.Random(trial))
        want = jtr.random_erasing_sample(sample, random.Random(trial))
        _assert_sample(got, want, "image", 0)


def _coco_pair(tree, train):
    root = f"{tree}/COCO"
    split = "train" if train else "val"
    args = (f"{root}/{split}2017", f"{root}/annotations/instances_{split}2017.json", train)
    kw = dict(scales=[48, 64, 72], max_size=120, min_size_test=64, max_size_test=100)
    port = tcoco.CocoDetection(*args, rng=random.Random(SEED) if train else None, **kw)
    ref = jcoco.CocoDetection(*args, seed=SEED, **kw)
    return port, ref


@pytest.mark.parametrize("train", [True, False])
def test_coco_detection_gives_the_jax_packages_samples(tree, train):
    port, ref = _coco_pair(tree, train)
    assert port.ids == ref.ids and len(port) == len(ref) > 0
    for rep in range(2 if train else 1):            # a second pass draws new augmentations
        for i in range(len(ref)):
            _assert_sample(port[i], ref[i], "image", NORM_ATOL)
    if not train:
        assert [port.eval_hw(i) for i in range(len(port))] == \
            [ref.eval_hw(i) for i in range(len(ref))]


def test_coco_raw_samples_cover_every_annotation_form(tree):
    port, ref = _coco_pair(tree, True)
    forms = set()
    for anns in port.anns_by_img.values():
        for a in anns:
            seg = a["segmentation"]
            forms.add("crowd" if a["iscrowd"] else "polygon" if isinstance(seg, list)
                      else "rle-list" if isinstance(seg["counts"], list) else "rle-string")
    assert forms == {"crowd", "polygon", "rle-list", "rle-string"}
    assert len(port.coco["images"]) == len(port.ids) + 1      # the image without objects
    for i in range(len(ref)):
        _assert_sample(port.get_sample(i), ref.get_sample(i), "image", 0)


def test_vis_train_dataset_gives_the_jax_packages_samples(tree):
    root = f"{tree}/Youtube_VIS-2019/train"
    args = (f"{root}/train.json", f"{root}/JPEGImages", 3)
    port = tvis.VISTrainDataset(*args, rng=random.Random(SEED), scale_factor=0.2)
    ref = jvis.VISTrainDataset(*args, seed=SEED, scale_factor=0.2)
    assert port.samples == ref.samples
    assert any(a["segmentations"][0] is None for a in port.db["annotations"])
    for i in range(len(ref)):
        assert port.frame_indices(*port.samples[i]) == ref.frame_indices(*ref.samples[i])
        _assert_sample(port[i], ref[i], "images", NORM_ATOL)
    short = tvis.VISTrainDataset(*args[:2], 9, rng=random.Random(0), sample_each_frame=True)
    jshort = jvis.VISTrainDataset(*args[:2], 9, seed=0, sample_each_frame=True)
    for s in range(len(short)):
        assert short.frame_indices(*short.samples[s]) == jshort.frame_indices(*jshort.samples[s])


@pytest.mark.parametrize("min_size,max_size,atol", [(48, 64, 0), (36, 60, 1)])
def test_vis_val_load_clip_is_the_jax_packages(tree, min_size, max_size, atol):
    root = f"{tree}/Youtube_VIS-2019/valid"
    args = (f"{root}/valid.json", f"{root}/JPEGImages", 4, 2, min_size, max_size)
    port, ref = tvis.VISValDataset(*args), jvis.VISValDataset(*args)
    assert len(port) == len(ref) and port.get_total_num_frames() == ref.get_total_num_frames()
    for pv, rv in zip(port.videos, ref.videos):
        assert pv.video_clips == rv.video_clips and pv.last_real_idx == rv.last_real_idx
        assert pv.video_name == rv.video_name
        for c in range(len(rv)):
            got, want = pv.load_clip(c), rv.load_clip(c)
            assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
            assert np.abs(got.astype(int) - want).max() <= atol
        np.testing.assert_array_equal(pv.read_frame(3), rv.read_frame(3))


def test_synthetic_datasets_are_the_jax_packages():
    for port, ref in ((tsyn.SyntheticVISDataset(num_frames=4, n_videos=2),
                       jsyn.SyntheticVISDataset(num_frames=4, n_videos=2)),
                      (tsyn.SyntheticCocoDataset(n_images=3), jsyn.SyntheticCocoDataset(n_images=3))):
        assert len(port) == len(ref)
        for i in (0, len(ref) - 1):
            key = "images" if "images" in ref[i] else "image"
            _assert_sample(port[i], ref[i], key, 0)
    assert tsyn.SyntheticCocoDataset(n_images=3).gt_dict() == \
        jsyn.SyntheticCocoDataset(n_images=3).gt_dict()
    pv = tsyn.SyntheticVISValDataset(num_frames=4, stride=2, n_videos=1)
    jv = jsyn.SyntheticVISValDataset(num_frames=4, stride=2, n_videos=1)
    for t in (0, 5):                       # read_frame takes a frame index, as in JAX
        np.testing.assert_array_equal(pv[0].read_frame(t), jv[0].read_frame(t))
    np.testing.assert_array_equal(pv[0].load_clip(1), jv[0].load_clip(1))


def _assert_batch(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_batch(got[k], v)
        elif k == "images":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=NORM_ATOL)
        elif k == "boxes":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6)
        else:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_collate_is_the_jax_packages():
    sample = tsyn.SyntheticCocoDataset(n_images=2, size=(50, 70))
    samples = [sample[0], sample[1]]
    samples[1] = dict(samples[1], labels=samples[1]["labels"][:0], boxes=samples[1]["boxes"][:0],
                      masks=samples[1]["masks"][:0], valid=samples[1]["valid"][:0])
    for n in (2, 5):
        _assert_batch(collate_images(samples, (64, 128), n), jcollate_images(samples, (64, 128), n))
    clip = tsyn.SyntheticVISDataset(num_frames=3, n_videos=1, size=(45, 61))[0]
    for n in (2, 4):
        _assert_batch(collate_clip(clip, (64, 64), n), jcollate_clip(clip, (64, 64), n))


@pytest.mark.parametrize("vis", [False, True])
def test_two_epochs_of_train_loader_give_the_jax_packages_batches(tree, vis):
    if vis:
        root = f"{tree}/Youtube_VIS-2019/train"
        args = (f"{root}/train.json", f"{root}/JPEGImages", 3)
        port = tvis.VISTrainDataset(*args, rng=random.Random(SEED), scale_factor=0.2)
        ref = jvis.VISTrainDataset(*args, seed=SEED, scale_factor=0.2)
        batch = 2
    else:
        port, ref = _coco_pair(tree, True)
        batch = 2
    buckets = make_buckets([64, 96], 128)
    pl = TrainLoader(port, batch, vis=vis, buckets=buckets, max_instances=4, seed=SEED)
    jl = JTrainLoader(ref, batch, vis=vis, buckets=buckets, max_instances=4, seed=SEED)
    assert len(pl) == len(jl) > 0
    for epoch in (0, 1):
        pl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl)
        for g, w in zip(got, want):
            _assert_batch(g, w)


def test_train_loader_raises_a_workers_error_and_stops_early():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return tsyn.SyntheticCocoDataset(n_images=1, size=(20, 30))[0]
    loader = TrainLoader(Broken(), 1, vis=False, buckets=[(64, 64)], shuffle=False)
    with pytest.raises(KeyError, match="sample 2"):
        list(loader)
    it = iter(TrainLoader(tsyn.SyntheticCocoDataset(n_images=4, size=(20, 30)), 1, vis=False,
                          buckets=[(64, 64)], prefetch=1))
    next(it)
    it.close()                                  # joins the worker
