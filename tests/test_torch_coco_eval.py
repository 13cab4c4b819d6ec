"""The port's COCO evaluation (`devis_torch.evaluation.coco_eval`,
`inference.merge_rank_predictions`, `evaluate_coco`'s default evaluator and
`log_losses`) against the JAX package's:

- both evaluators on the same seeded GT and detections (bbox and segm, crowd
  GT, objects in every area range, images with more than 100 detections so
  that every max-det differs): every one of the 12 stats to 1e-12;
- `box_iou_xywh`, `_evaluate_img` and `_accumulate` on the same inputs:
  equal to 1e-12; `merge_rank_predictions` equal;
- the tiny image model (`from_jax_params` weights, 1 + 1 layers, f32):
  `evaluate_coco` with its default evaluator gives the stats that the JAX
  `CocoEvaluator` gives on the same predictions (1e-12), and
  `log_losses=True` gives the JAX `evaluate_coco(log_losses=True)`'s
  averaged losses to 1e-3 of max(1, |loss|).
"""
import numpy as np
import pytest

from devis_torch.evaluation import coco_eval as tce
from devis_torch.evaluation import rle
from devis_torch.inference import merge_rank_predictions
from devis_tpu.evaluation import coco_eval as jce
from devis_tpu.inference import merge_rank_predictions as jmerge

TOL = 1e-12


def _box_mask(h, w, box):
    m = np.zeros((h, w), bool)
    x, y, bw, bh = [int(round(v)) for v in box]
    m[y:y + bh, x:x + bw] = True
    return m


def synthetic_gt_and_detections(seed=0, n_images=4, cats=(1, 2, 3), h=240, w=320):
    rs = np.random.RandomState(seed)
    images, anns, preds = [], [], []
    for i in range(n_images):
        images.append({"id": i, "height": h, "width": w})
        for k in range(6):
            side = [8, 24, 60, 140][k % 4]                       # small, medium, large
            bw, bh = side + rs.randint(0, 10), side + rs.randint(0, 10)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            box = [float(x), float(y), float(bw), float(bh)]
            m = _box_mask(h, w, box)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": int(cats[k % 3]),
                         "bbox": box, "area": float(m.sum()), "iscrowd": int(k == 5),
                         "segmentation": rle.encode(m)})
            for j in range(3):                                   # jittered detections
                jit = rs.uniform(-0.3, 0.3, 4) * [bw, bh, bw, bh]
                db = [max(0.0, box[0] + jit[0]), max(0.0, box[1] + jit[1]),
                      max(1.0, bw + jit[2]), max(1.0, bh + jit[3])]
                preds.append({"image_id": i, "category_id": int(cats[(k + (j == 2)) % 3]),
                              "score": float(rs.rand()), "bbox": db,
                              "segmentation": rle.encode(_box_mask(h, w, db))})
        n_fp = 120 if i == 0 else 5                               # past every max-det
        for _ in range(n_fp):
            db = [float(rs.randint(0, w - 20)), float(rs.randint(0, h - 20)), 12.0, 9.0]
            preds.append({"image_id": i, "category_id": int(cats[rs.randint(3)]),
                          "score": float(rs.rand() * 0.5), "bbox": db,
                          "segmentation": rle.encode(_box_mask(h, w, db))})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": f"c{c}"} for c in cats]}
    return gt, preds


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_evaluate_coco_stats_equal_the_jax_evaluators(iou_type):
    gt, preds = synthetic_gt_and_detections()
    got = tce.evaluate_coco(gt, preds, iou_type)
    _close(got, jce.evaluate_coco(gt, preds, iou_type))
    assert got["AP"] > 0 and got["APs"] != got["APl"] and got["AR@1"] != got["AR@100"]


def test_coco_evaluator_equals_the_jax_one():
    gt, preds = synthetic_gt_and_detections(seed=1)
    results = {}
    for p in preds:
        r = results.setdefault(p["image_id"], {"scores": [], "labels": [], "boxes": [],
                                               "masks": []})
        x, y, w, h = p["bbox"]
        r["scores"].append(p["score"])
        r["labels"].append(p["category_id"])
        r["boxes"].append([x, y, x + w, y + h])
        r["masks"].append(rle.decode(p["segmentation"]).astype(bool))
    port, ref = tce.CocoEvaluator(gt, ("bbox", "segm")), jce.CocoEvaluator(gt, ("bbox", "segm"))
    for image_id, r in results.items():
        port.update({image_id: dict(r)})
        ref.update({image_id: dict(r)})
    got, want = port.summarize(), ref.summarize()
    assert set(got) == {"bbox", "segm"}
    for t in got:
        _close(got[t], want[t])


def test_matching_pieces_equal_the_jax_ones():
    rs = np.random.RandomState(2)
    dt, gt = rs.uniform(0, 50, (7, 4)), rs.uniform(0, 50, (5, 4))
    crowd = [0, 1, 0, 0, 1]
    np.testing.assert_allclose(tce.box_iou_xywh(dt, gt, crowd), jce.box_iou_xywh(dt, gt, crowd),
                               rtol=0, atol=TOL)
    g, p = synthetic_gt_and_detections(seed=3, n_images=1)
    gts = [a for a in g["annotations"] if a["category_id"] == 1]
    dts = [d for d in p if d["category_id"] == 1]
    for rng_ in tce.AREA_RANGES.values():
        for iou_type in ("bbox", "segm"):
            a = tce._evaluate_img([dict(x) for x in gts], dts, rng_, 100, iou_type)
            b = jce._evaluate_img([dict(x) for x in gts], dts, rng_, 100, iou_type)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)
            for md in tce.MAX_DETS:
                pa, ra = tce._accumulate([a, None], md)
                pb, rb = jce._accumulate([b, None], md)
                if pb is None:
                    assert pa is None
                else:
                    np.testing.assert_allclose(pa, pb, rtol=0, atol=TOL)
                    np.testing.assert_allclose(ra, rb, rtol=0, atol=TOL)


def test_polygon_gt_is_rasterized_for_segm():
    """The port fills polygon GT by the dataset's rule (the JAX evaluator
    takes RLE GT only): a polygon GT and its RLE give the same stats."""
    gt, preds = synthetic_gt_and_detections(seed=4, n_images=2)
    poly = {**gt, "annotations": []}
    for a in gt["annotations"]:
        x, y, w, h = a["bbox"]
        poly["annotations"].append(dict(a, segmentation=[[x, y, x + w - 1, y, x + w - 1,
                                                          y + h - 1, x, y + h - 1]]))
    _close(tce.evaluate_coco(poly, preds, "segm"), tce.evaluate_coco(gt, preds, "segm"))


def test_merge_rank_predictions_equals_the_jax_one():
    ranks = [[{"image_id": 0, "score": 0.5}, {"image_id": 2, "score": 0.1}],
             [{"image_id": 1, "score": 0.3}, {"image_id": 2, "score": 0.9},
              {"image_id": 0, "score": 0.7}],
             [{"image_id": 3, "score": 0.2}, {"image_id": 1, "score": 0.4}]]
    got = merge_rank_predictions(ranks)
    assert got == jmerge(ranks)
    assert sorted(p["image_id"] for p in got) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# The tiny image model
# ---------------------------------------------------------------------------

def _cfg_fn(get_cfg_defaults, mask_on=True):
    """The COCO slice's tiny image model at 1 + 1 layers."""
    from .test_torch_coco_slice import _cfg
    cfg = _cfg(get_cfg_defaults, mask_on)
    cfg.defrost()
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 1
    cfg.MODEL.LOSS.MASK_AUX_LOSS = []
    cfg.TEST.EVAL_BATCH_SIZE = 1
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def pair():
    from .test_torch_coco_modules import make_pair
    return make_pair(_cfg_fn, True, seed=7)


class _Tee:
    """The port's default evaluator plus a copy of every image's result."""

    def __init__(self, gt):
        self.inner = tce.CocoEvaluator(gt, ("bbox", "segm"))
        self.results = {}

    def update(self, res):
        self.results.update(res)
        self.inner.update(res)

    def summarize(self):
        return self.inner.summarize()


def test_evaluate_coco_default_evaluator_gives_the_jax_evaluators_stats(pair):
    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets.synthetic import SyntheticCocoDataset
    from devis_torch.inference import evaluate_coco
    _, _, tmodel = pair
    cfg = _cfg_fn(get_cfg_defaults)
    ds = SyntheticCocoDataset(train=False, n_images=3, size=(56, 80))
    summary = evaluate_coco(tmodel, ds, cfg, device="cpu", verbose=False)
    tee = _Tee(ds.gt_dict())
    assert evaluate_coco(tmodel, ds, cfg, tee, device="cpu", verbose=False) == summary
    ref = jce.CocoEvaluator(ds.gt_dict(), ("bbox", "segm"))
    for image_id, r in tee.results.items():
        ref.update({image_id: r})
    want = ref.summarize()
    assert set(summary) == {"bbox", "segm"}
    for t in want:
        _close(summary[t], want[t])


def test_log_losses_match_the_jax_package(pair):
    import jax
    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets.synthetic import SyntheticCocoDataset
    from devis_torch.inference import evaluate_coco
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.datasets.synthetic import SyntheticCocoDataset as JSynth
    from devis_tpu.inference import evaluate_coco as jevaluate
    jmodel, variables, tmodel = pair
    got = evaluate_coco(tmodel, SyntheticCocoDataset(train=False, n_images=2, size=(56, 80)),
                        _cfg_fn(get_cfg_defaults), device="cpu", verbose=False,
                        log_losses=True)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jevaluate(jmodel, variables, JSynth(train=False, n_images=2, size=(56, 80)),
                         _cfg_fn(jax_cfg), verbose=False, log_losses=True)
    assert set(got["losses"]) == set(want["losses"]) and "loss_mask" in got["losses"]
    for k, v in want["losses"].items():
        assert abs(got["losses"][k] - v) <= 1e-3 * max(1.0, abs(v)), (k, got["losses"][k], v)
