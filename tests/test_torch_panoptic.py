"""The port's COCO panoptic path against the JAX package's, on the CPU:

- `pq_compute_single` and `PanopticEvaluator` on seeded segment maps with
  crowd segments, void pixels, things and stuff: per-category stats and the
  summary to 1e-12;
- `CocoPanoptic` on the fixture tree (`write_coco_panoptic_tree`: JPEG
  images, RGB segment PNGs): every sample array and GT map equal to the JAX
  dataset's, bit for bit (the JAX package reads both with cv2);
- `paint_panoptic` given a top-k equals the JAX `evaluate_panoptic` loop
  given the same top-k (the JAX forward stubbed to return it): segment maps
  and segments equal;
- `evaluate_panoptic` end to end on the tiny f32 image model
  (`from_jax_params` weights, 1 + 1 layers) against the JAX function at
  score threshold 0 (every top-k mask goes to the paint step): the painted
  category maps agree on at least 99 % of the pixels of every image (a mask
  logit within rounding of 0 may flip a pixel) and PQ, SQ, RQ, PQ_th, PQ_st
  to 1e-6 of 100;
- a panoptic training batch made by the port's `TrainLoader` equals the JAX
  `TrainLoader`'s batch (same seed, buckets and slots), and one port train
  step on it is finite and moves the parameters (the image step itself is
  held to JAX in `test_torch_coco_slice.py`).
"""
import numpy as np
import pytest

from devis_torch.evaluation import panoptic_eval as tpe
from devis_tpu.evaluation import panoptic_eval as jpe

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = ((48, 64), (64, 48))
MIN_TEST, MAX_TEST = 64, 96


def _segment_maps(seed, h=40, w=56):
    rs = np.random.RandomState(seed)
    cats = [{"id": 1, "isthing": 1}, {"id": 2, "isthing": 1},
            {"id": 7, "isthing": 0}, {"id": 9, "isthing": 0}]
    gt = np.zeros((h, w), np.int32)
    gt_segs = []
    sid = 1
    gt[: h // 2] = 500
    gt_segs.append({"id": 500, "category_id": 7})
    gt[h // 2:] = 600
    gt_segs.append({"id": 600, "category_id": 9})
    for k in range(4):
        y0, x0 = rs.randint(0, h - 10), rs.randint(0, w - 12)
        sid = 1000 + k
        gt[y0:y0 + rs.randint(6, 10), x0:x0 + rs.randint(6, 12)] = sid
        gt_segs.append({"id": sid, "category_id": int(rs.randint(1, 3)),
                        "iscrowd": int(k == 3)})
    gt[:, :3] = 0                                         # void
    gt_segs = [s for s in gt_segs if (gt == s["id"]).any()]
    pred = gt.copy()
    pred[rs.rand(h, w) < 0.15] = 0
    shift = rs.randint(-3, 4, 2)
    pred = np.roll(pred, tuple(shift), (0, 1))
    pred[rs.randint(0, h - 5):, rs.randint(0, w - 5):] = 77     # an unmatched segment
    remap = {0: 0}
    pred_segs = []
    for i, v in enumerate(np.unique(pred)):
        if v == 0:
            continue
        remap[v] = 10 + i
        cat = next((s["category_id"] for s in gt_segs if s["id"] == v), int(rs.randint(1, 3)))
        if rs.rand() < 0.2:
            cat = 9 if cat != 9 else 7
        pred_segs.append({"id": 10 + i, "category_id": cat})
    pred = np.vectorize(remap.get)(pred).astype(np.int32)
    return cats, gt, gt_segs, pred, pred_segs


def test_pq_matches_jax():
    tev = tpe.PanopticEvaluator(_segment_maps(0)[0])
    jev = jpe.PanopticEvaluator(_segment_maps(0)[0])
    for seed in range(6):
        cats, gt, gt_segs, pred, pred_segs = _segment_maps(seed)
        got = tpe.pq_compute_single(gt, gt_segs, pred, pred_segs)
        want = jpe.pq_compute_single(gt, gt_segs, pred, pred_segs)
        assert got.keys() == want.keys()
        for c in want:
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=1e-12)
        tev.update(gt, gt_segs, pred, pred_segs)
        jev.update(gt, gt_segs, pred, pred_segs)
    got, want = tev.summarize(), jev.summarize()
    assert got.keys() == want.keys() == {"PQ", "SQ", "RQ", "PQ_th", "PQ_st"}
    assert want["PQ"] > 0 and want["PQ_st"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from devis_torch.util.fixtures import write_coco_panoptic_tree
    root = str(tmp_path_factory.mktemp("panoptic"))
    return write_coco_panoptic_tree(root, seed=3, n_train=4, n_val=3, sizes=SIZES)


def _cfg(get_cfg_defaults, root, **extra):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "coco_panoptic"
    cfg.DATASETS.DATA_PATH = root
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = MIN_TEST, MAX_TEST
    for k, v in extra.items():
        node = cfg
        *path, last = k.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, last, v)
    return cfg


def test_dataset_matches_jax(tree):
    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets import build_dataset
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.datasets import build_dataset as jax_build
    for split in ("TRAIN", "VAL"):
        ds, n = build_dataset(split, _cfg(get_cfg_defaults, tree))
        jds, jn = jax_build(split, _cfg(jax_cfg, tree))
        assert n == jn == 250 and len(ds) == len(jds) > 0
        assert ds.gt_dict() == jds.gt_dict()
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert got.keys() == want.keys()
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (i, k)
                else:
                    assert got[k] == v, (i, k)
            ids, segs = ds.gt_segmentation(i)
            jids, jsegs = jds.gt_segmentation(i)
            assert np.array_equal(ids, jids) and segs == jsegs
            assert (ids == 0).any() and any(s["iscrowd"] for s in segs)


def _jax_paint(monkeypatch, tree, top_ks, canvas_cfg, score_threshold):
    """The JAX `evaluate_panoptic` with its forward stubbed to give each
    image's `top_ks` entry: its painted maps and segments, image by image."""
    import jax.numpy as jnp
    from devis_tpu import inference as ji
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.datasets import build_dataset as jax_build
    jds, _ = jax_build("VAL", _cfg(jax_cfg, tree))
    calls = iter(top_ks)

    class Stub:
        def apply(self, v, i, m, train=False):
            return {"top_k": {k: jnp.asarray(a[None]) for k, a in next(calls).items()}}

    painted = []
    real = jpe.PanopticEvaluator.update

    def update(self, gt_ids, gt_segments, pred_ids, pred_segments):
        painted.append((pred_ids.copy(), list(pred_segments)))
        return real(self, gt_ids, gt_segments, pred_ids, pred_segments)

    monkeypatch.setattr(jpe.PanopticEvaluator, "update", update)
    monkeypatch.setattr(ji.jax, "jit", lambda f: f)
    summary = ji.evaluate_panoptic(Stub(), None, jds, canvas_cfg, score_threshold,
                                   verbose=False)
    return jds, painted, summary


def test_paint_step_equals_the_jax_loop(monkeypatch, tree):
    from devis_torch.inference import make_eval_buckets, paint_panoptic, pick_canvas
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    rs = np.random.RandomState(0)
    cfg = _cfg(jax_cfg, tree)
    K = 9
    top_ks = []
    for i in range(3):
        # /4 mask logits of the canvas, some masks overlapping, one tiny, one
        # score below the threshold
        logits = rs.randn(K, 24, 32).astype(np.float32) * 2 - 0.5
        logits[3] = -5
        logits[3, 2, 2] = 5
        top_ks.append({"scores": np.sort(rs.rand(K).astype(np.float32))[::-1] * 0.9 + 0.05,
                       "labels": rs.randint(0, 6, K).astype(np.int32), "masks": logits})
    jds, painted, _ = _jax_paint(monkeypatch, tree, top_ks, cfg, 0.3)
    buckets = make_eval_buckets(MIN_TEST, MAX_TEST)
    n_painted = 0
    for i, (tk, (want_ids, want_segs)) in enumerate(zip(top_ks, painted)):
        h, w = jds[i]["image"].shape[:2]
        gt_ids, _ = jds.gt_segmentation(i)
        ids, segs = paint_panoptic(tk, pick_canvas(h, w, buckets), (h, w), gt_ids.shape, 0.3)
        assert np.array_equal(ids, want_ids) and segs == want_segs, i
        n_painted += len(segs)
    assert n_painted > 3


@pytest.fixture(scope="module")
def pair():
    from .test_torch_coco_eval import _cfg_fn
    from .test_torch_coco_modules import make_pair
    return make_pair(_cfg_fn, True, seed=7)


def test_evaluate_panoptic_matches_jax(monkeypatch, tree, pair):
    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets import build_dataset
    from devis_torch.evaluation import panoptic_eval as tpe_mod
    from devis_torch.inference import evaluate_panoptic
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.datasets import build_dataset as jax_build
    from devis_tpu.inference import evaluate_panoptic as jax_eval

    from .test_torch_coco_eval import _cfg_fn
    jmodel, variables, tmodel = pair

    def cfg_of(get):
        cfg = _cfg_fn(get)
        cfg.defrost()
        cfg.DATASETS.TYPE = "coco_panoptic"
        cfg.DATASETS.DATA_PATH = tree
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = MIN_TEST, MAX_TEST
        cfg.freeze()
        return cfg

    maps = {"port": [], "jax": []}

    def tap(mod, key):
        real = mod.PanopticEvaluator.update

        def update(self, gt_ids, gt_segments, pred_ids, pred_segments):
            cats = {s["id"]: s["category_id"] for s in pred_segments}
            maps[key].append(np.vectorize(lambda v: cats.get(v, 0))(pred_ids))
            return real(self, gt_ids, gt_segments, pred_ids, pred_segments)
        monkeypatch.setattr(mod.PanopticEvaluator, "update", update)

    tap(tpe_mod, "port")
    tap(jpe, "jax")
    ds, _ = build_dataset("VAL", cfg_of(get_cfg_defaults))
    got = evaluate_panoptic(tmodel, ds, cfg_of(get_cfg_defaults), score_threshold=0.0,
                            device="cpu", verbose=False)
    jds, _ = jax_build("VAL", cfg_of(jax_cfg))
    want = jax_eval(jmodel, variables, jds, cfg_of(jax_cfg), score_threshold=0.0,
                    verbose=False)
    assert got["segments"] > 0
    assert len(maps["port"]) == len(maps["jax"]) == len(ds)
    for g, w in zip(maps["port"], maps["jax"]):
        assert g.shape == w.shape and (g == w).mean() >= 0.99
    for k in ("PQ", "SQ", "RQ", "PQ_th", "PQ_st"):
        assert abs(got[k] - want[k]) <= 1e-6 * 100, k


def test_train_batch_equals_jax_and_one_step_moves_the_model(tree):
    import torch

    from devis_torch.config import get_cfg_defaults
    from devis_torch.datasets import build_dataset
    from devis_torch.engine import create_train_state, make_train_step
    from devis_torch.main import build_train_loader
    from devis_torch.models import build_model
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.datasets import TrainLoader as JaxLoader
    from devis_tpu.datasets import build_dataset as jax_build
    from devis_tpu.datasets import make_buckets

    extra = {"SOLVER.BATCH_SIZE": 2, "INPUT.SCALE_FACTOR_TRAIN": 0.125,
             "MODEL.HIDDEN_DIM": 64, "MODEL.DIM_FEEDFORWARD": 64, "MODEL.NUM_QUERIES": 10,
             "MODEL.TRANSFORMER.ENCODER_LAYERS": 1, "MODEL.TRANSFORMER.DECODER_LAYERS": 2,
             "MODEL.LOSS.MASK_AUX_LOSS": [0], "MODEL.MASK_ON": True, "MODEL.DROPOUT": 0.0}
    cfg = _cfg(get_cfg_defaults, tree, **extra)
    cfg.freeze()
    ds, n_classes = build_dataset("TRAIN", cfg)
    loader = build_train_loader(cfg, ds, max_batches=1)
    batch = next(iter(loader))
    jcfg = _cfg(jax_cfg, tree, **extra)
    jds, _ = jax_build("TRAIN", jcfg)
    sf = jcfg.INPUT.SCALE_FACTOR_TRAIN
    jloader = JaxLoader(jds, 2, vis=False,
                        buckets=make_buckets([int(sf * s) for s in (480, 512, 544, 576, 608,
                                                                    640)], int(sf * 1333)),
                        max_instances=min(jcfg.TPU.MAX_INSTANCES, jcfg.MODEL.NUM_QUERIES),
                        seed=jcfg.SEED)
    want = next(iter(jloader))

    def flat(tree_, pre=""):
        for k, v in tree_.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v
    got_flat, want_flat = dict(flat(batch)), dict(flat(want))
    assert got_flat.keys() == want_flat.keys()
    for k, v in want_flat.items():
        assert np.array_equal(got_flat[k], v), k
    assert batch["targets"]["valid"].any()

    model = build_model(n_classes, cfg, device="cpu", seed=1)
    state = create_train_state(cfg, model, 1)
    before = {k: v.clone() for k, v in model.named_parameters()}
    state, metrics = make_train_step(model, cfg)(state, batch)
    assert float(metrics["finite"]) == 1.0 and np.isfinite(float(metrics["loss"]))
    moved = [k for k, v in model.named_parameters() if not torch.equal(v, before[k])]
    assert len(moved) > len(before) // 2
