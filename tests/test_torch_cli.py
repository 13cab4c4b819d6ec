"""The port's command line (`devis_torch.main.main`) on the CPU, end to end
from files: `configs/synthetic_smoke.yaml` (the synthetic YouTube-VIS
splits), the COCO mask-head config over a seeded COCO tree on disk
(`devis_torch.util.fixtures`), the same config as COCO panoptic and the
YT-19 config with COCO joint training, all at narrow widths:

- train one epoch, capped to a few steps: finite losses, `config.yaml`,
  `checkpoint/` with `meta.json`, `checkpoint_epoch_{e}/`, and
  `checkpoint_best_*` where the periodic evaluation ran (COCO);
- `--resume` starts at the epoch after `meta.json`'s, from the saved
  weights, AdamW state and step;
- `--eval-only` of a checkpoint, and over `TEST.INPUT_FOLDER`, prints finite
  stats.
"""
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from devis_torch.main import build_train_loader, main, parse_args, setup_cfg
from devis_torch.util import checkpoint as ckpt
from devis_torch.util.fixtures import write_coco_tree, write_vis_tree

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["MODEL.HIDDEN_DIM", "64", "MODEL.DIM_FEEDFORWARD", "128"]


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    return math.isfinite(tree) if isinstance(tree, float) else True


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_synthetic_smoke_trains_checkpoints_resumes_and_evaluates(tmp_path):
    out = str(tmp_path / "out")
    cfg_file = os.path.join(ROOT, "configs", "synthetic_smoke.yaml")
    common = ["--config-file", cfg_file]
    opts = NARROW + ["OUTPUT_DIR", out, "INPUT.SCALE_FACTOR_TRAIN", "0.25",
                     "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
                     "TEST.START_EVAL_EPOCH", "2"]
    run = main(common + opts, device="cpu", max_steps=1)
    epoch = run["epochs"][0]
    assert run["start_epoch"] == 0 and len(run["epochs"]) == 1 and "eval" not in epoch
    assert epoch["step"] == 1 and math.isfinite(epoch["train"]["loss"])
    assert sorted(os.listdir(out)) == ["checkpoint", "checkpoint_epoch_0", "config.yaml",
                                       "metrics.jsonl"]
    with open(os.path.join(out, "checkpoint", "meta.json")) as f:
        assert json.load(f) == {"epoch": 0, "best_stats": {}}
    saved = setup_cfg(parse_args(["--config-file", os.path.join(out, "config.yaml")]))
    assert saved == setup_cfg(parse_args(common + opts))

    # the resumed run starts at epoch 1 from the saved state: 1 + 1 steps
    before = ckpt.load_checkpoint(os.path.join(out, "checkpoint"))
    run = main(common + ["--resume", os.path.join(out, "checkpoint")] + opts
               + ["SOLVER.EPOCHS", "2", "TEST.START_EVAL_EPOCH", "3"], device="cpu",
               max_steps=1)
    assert run["start_epoch"] == 1 and [e["epoch"] for e in run["epochs"]] == [1]
    assert run["epochs"][0]["step"] == 2 and "eval" not in run["epochs"][0]
    after = ckpt.load_checkpoint(os.path.join(out, "checkpoint"))
    assert after["step"] == 2 and before["step"] == 1
    moved = [k for k, v in before["model"].items() if v.is_floating_point()
             and not torch.equal(v, after["model"][k])]
    assert moved

    res = main(common + ["--eval-only"] + opts + ["MODEL.WEIGHTS", os.path.join(out, "checkpoint"),
                                                  "TEST.VIZ.VIDEO_NAMES", "'2'"], device="cpu")
    ev = res["eval"]["eval"]
    assert {"AP", "AP50", "AP75", "AR"} <= set(ev) and _finite(ev)
    with open(os.path.join(out, "eval_results", "results.json")) as f:
        tracks = json.load(f)
    assert tracks and {t["video_id"] for t in tracks} == {2}     # the selected video


def test_coco_from_files_trains_evaluates_and_resumes(tmp_path):
    data = write_coco_tree(str(tmp_path / "data"), seed=3, n_train=4, n_val=2,
                           sizes=((60, 80), (80, 60)))
    out = str(tmp_path / "out")
    cfg_file = os.path.join(ROOT, "configs", "deformable_mask_head",
                            "deformable_mask_head_R_50.yaml")
    opts = NARROW + ["MODEL.WEIGHTS", "", "DATASETS.DATA_PATH", data, "OUTPUT_DIR", out,
                     "MODEL.NUM_QUERIES", "12", "MODEL.TRANSFORMER.ENCODER_LAYERS", "1",
                     "MODEL.TRANSFORMER.DECODER_LAYERS", "2", "MODEL.LOSS.MASK_AUX_LOSS", "[0]",
                     "TEST.NUM_OUT", "5", "INPUT.SCALE_FACTOR_TRAIN", "0.125",
                     "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
                     "SOLVER.EPOCHS", "1", "SOLVER.BATCH_SIZE", "2"]
    run = main(["--config-file", cfg_file] + opts, device="cpu")
    epoch = run["epochs"][0]
    assert epoch["step"] == 1                     # 3 images with objects, batches of 2
    assert _finite(epoch["train"]) and set(epoch["eval"]) == {"bbox", "segm"}
    assert _finite(epoch["eval"])
    assert run["best_stats"] == {"coco_ap": epoch["eval"]["bbox"]["AP"]}
    for d in ("checkpoint", "checkpoint_epoch_0", "checkpoint_best_coco_ap"):
        assert os.path.exists(os.path.join(out, d, ckpt.STATE_FILE)), d
    with open(os.path.join(out, "checkpoint", "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"epoch": 0, "best_stats": run["best_stats"]}
    lines = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["kind"] for r in lines] == ["train_epoch", "eval"]

    run = main(["--config-file", cfg_file, "--resume", os.path.join(out, "checkpoint")] + opts
               + ["SOLVER.EPOCHS", "2", "TEST.EVAL_PERIOD", "5"], device="cpu")
    assert run["start_epoch"] == 1 and run["epochs"][0]["step"] == 2
    assert run["best_stats"] == meta["best_stats"]

    res = main(["--config-file", cfg_file, "--eval-only"] + opts
               + ["TEST.INPUT_FOLDER", out, "TEST.EPOCHS_TO_EVAL", "[0, 1, 7]"], device="cpu")
    assert sorted(res["eval"]) == [0, 1] and res["best_epoch"] in (0, 1)
    for stats in res["eval"].values():
        assert set(stats) == {"bbox", "segm"} and _finite(stats)
        assert all(np.isfinite(v) for v in stats["bbox"].values())


def test_unported_types_name_their_roadmap_items(tmp_path):
    """The two dataset types that once raised train and evaluate through the
    CLI: COCO panoptic (one epoch of 2 steps on the panoptic fixture tree,
    the periodic PQ evaluation, then `--eval-only` of the checkpoint) and
    COCO joint training (a YT-19 tree and a COCO tree under one root, one
    step; the joint set's clips follow the videos' in the loader's order)."""
    from devis_torch.util.fixtures import write_coco_panoptic_tree
    data = write_coco_panoptic_tree(str(tmp_path / "pan"), seed=1, n_train=4, n_val=2,
                                    sizes=((48, 64), (64, 48)))
    out = str(tmp_path / "out")
    cfg_file = os.path.join(ROOT, "configs", "deformable_mask_head",
                            "deformable_mask_head_R_50.yaml")
    opts = NARROW + ["DATASETS.TYPE", "coco_panoptic", "MODEL.WEIGHTS", "",
                     "DATASETS.DATA_PATH", data, "OUTPUT_DIR", out, "MODEL.NUM_QUERIES", "12",
                     "MODEL.TRANSFORMER.ENCODER_LAYERS", "1",
                     "MODEL.TRANSFORMER.DECODER_LAYERS", "2", "MODEL.LOSS.MASK_AUX_LOSS", "[0]",
                     "TEST.NUM_OUT", "5", "INPUT.SCALE_FACTOR_TRAIN", "0.125",
                     "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
                     "SOLVER.EPOCHS", "1", "SOLVER.BATCH_SIZE", "2"]
    run = main(["--config-file", cfg_file] + opts, device="cpu")
    epoch = run["epochs"][0]
    assert epoch["step"] == 2 and _finite(epoch["train"])
    keys = {"PQ", "SQ", "RQ", "PQ_th", "PQ_st", "segments"}
    assert set(epoch["eval"]) == keys and _finite(epoch["eval"])
    assert run["best_stats"] == {"pq": epoch["eval"]["PQ"]}
    assert os.path.exists(os.path.join(out, "checkpoint_best_pq", ckpt.STATE_FILE))
    res = main(["--config-file", cfg_file, "--eval-only"] + opts
               + ["MODEL.WEIGHTS", os.path.join(out, "checkpoint")], device="cpu")
    assert set(res["eval"]) == keys and _finite(res["eval"])
    assert res["eval"] == epoch["eval"]

    data = write_vis_tree(str(tmp_path / "data"), n_train=1, n_val=1, n_frames=3, size=(32, 48))
    write_coco_tree(data, seed=2, n_train=3, n_val=1, sizes=((40, 56),))
    run = main(["--config-file", os.path.join(ROOT, "configs", "devis", "YT-19",
                                              "devis_R_50_YT-19.yaml"),
                "DATASETS.DEVIS.COCO_JOINT_TRAINING", "True", "MODEL.WEIGHTS", "",
                "DATASETS.DATA_PATH", data, "OUTPUT_DIR", str(tmp_path / "o"),
                "MODEL.NUM_QUERIES", "6", "MODEL.DEVIS.NUM_FRAMES", "3",
                "INPUT.SCALE_FACTOR_TRAIN", "0.125", "SOLVER.EPOCHS", "1",
                "TEST.START_EVAL_EPOCH", "2", "MODEL.LOSS.MASK_AUX_LOSS", "[]",
                "MODEL.TRANSFORMER.ENCODER_LAYERS", "1", "MODEL.TRANSFORMER.DECODER_LAYERS", "1"]
               + NARROW, device="cpu", max_steps=1)
    assert run["epochs"][0]["step"] == 1 and _finite(run["epochs"][0]["train"])


def test_logging_and_metric_helpers(tmp_path, monkeypatch):
    """The CLI's metrics stream, the visdom sink without its client, the
    memory stats off the card, the spans' Chrome trace, and the metric
    logger's `max` / `value` and one-process synchronisation."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.util import trace
    from devis_torch.util.logging_utils import (VisdomSink, build_metrics, build_visdom,
                                                device_memory_stats)
    from devis_torch.util.misc import MetricLogger
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(tmp_path)
    with build_metrics(cfg) as m:
        m.write(3, {"loss": np.float32(1.5)}, kind="train_epoch")
    rec = json.loads(open(tmp_path / "metrics.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["kind"] == "train_epoch"
    assert build_visdom(cfg) is None
    monkeypatch.setitem(sys.modules, "visdom", None)      # no client, whatever is installed
    VisdomSink("http://localhost", 1).plot("train", 0, {"loss": 1.0})   # a no-op
    assert device_memory_stats("cpu") == {}
    trace.reset()
    trace.enable()
    try:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
    finally:
        trace.disable()
    trace.export_chrome(str(tmp_path / "trace" / "spans.json"))
    events = json.load(open(tmp_path / "trace" / "spans.json"))["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(spans) == {"outer", "inner"} and spans["inner"]["args"]["parent"] == "outer"
    assert spans["outer"]["ts"] <= spans["inner"]["ts"] and spans["inner"]["dur"] > 0
    log = MetricLogger()
    for v in (2.0, 5.0, 3.0):
        log.update(loss=v)
    assert log.loss.max == 5.0 and log.loss.value == 3.0 and log.loss.global_avg == 10 / 3
    log.synchronize_between_processes()
    assert log.loss.count == 3


def test_capped_epoch_draws_the_augmentation_for_its_batches_only(tmp_path):
    """`main(max_steps=n)` cuts the loader, not the loop: after the epoch the
    augmentation's random.Random stands where n batches leave it, however
    far the prefetch thread could have run ahead, so the data RNG state a
    checkpoint saves is reproducible."""
    from devis_torch.datasets import build_dataset
    data = write_vis_tree(str(tmp_path / "data"), seed=1, n_train=2, n_val=1, n_frames=8,
                          size=(48, 64))
    cfg = setup_cfg(parse_args([
        "--config-file", os.path.join(ROOT, "configs", "devis", "YT-19", "devis_R_50_YT-19.yaml"),
        "DATASETS.DATA_PATH", data, "INPUT.SCALE_FACTOR_TRAIN", "0.125"]))
    ds, _ = build_dataset("TRAIN", cfg)
    loader = build_train_loader(cfg, ds, max_batches=2)
    assert len(ds) == 6 and len(loader) == 2
    got = list(loader)                      # the whole (cut) epoch, prefetched
    ref, _ = build_dataset("TRAIN", cfg)
    ref_loader = build_train_loader(cfg, ref)
    want = [ref_loader.make_batch(b) for b in ref_loader.batch_indices()[:2]]
    assert ds.transform.rng.getstate() == ref.transform.rng.getstate()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["targets"]["masks"], w["targets"]["masks"])


NARROW_SWIN = "swin_t_narrow_p4w7"


def test_swin_with_recomputation_resumes_to_the_bit(tmp_path, monkeypatch):
    """A Swin backbone with both recomputation flags and the dropout and
    drop path on, from the YT-19 Swin-L config file: one step, a save, and
    `--resume` for a second end where two steps in one run without the
    flags end (model, AdamW, step, dropout generator and data RNG, to the
    bit): the recompute draws the forward's masks and leaves the saved
    generator where the forward left it. The Swin-L config files resolve
    through the port's YAML reader. The backbone is `swin_t_p4w7`'s layout
    (depths 2, 2, 6, 2, window 7, drop path 0.2) at a quarter of its width,
    registered for this test: recomputation and the resume do not depend on
    the width, and full-width Swin-L is held on the card."""
    from devis_torch.models.backbones import swin as P
    from devis_torch.models.backbones.swin import SWIN_CONFIGS
    t = SWIN_CONFIGS["swin_t_p4w7"]
    monkeypatch.setitem(SWIN_CONFIGS, NARROW_SWIN, P._cfg(
        t["embed_dim"] // 4, t["depths"], tuple(max(1, h // 4) for h in t["num_heads"]),
        t["window"], t["drop_path_rate"]))
    swin_l = [os.path.join(ROOT, "configs", *p) for p in (
        ("devis", "YT-19", "devis_Swin_L_YT-19.yaml"), ("devis", "YT-21", "devis_Swin_L_YT-21.yaml"),
        ("devis", "OVIS", "devis_Swin_L_OVIS.yaml"),
        ("deformable_mask_head", "deformable_mask_head_SwinL.yaml"))]
    for path in swin_l:
        cfg = setup_cfg(parse_args(["--config-file", path]))
        assert cfg.MODEL.BACKBONE == "swin_l_p4w12" and cfg.MODEL.BACKBONE in SWIN_CONFIGS

    data = write_vis_tree(str(tmp_path / "data"), seed=2, n_train=1, n_val=1, n_frames=6,
                          size=(48, 64))
    common = ["--config-file", swin_l[0]]
    remat = ["TPU.SWIN_GRADIENT_CHECKPOINT", "True", "TPU.TRANSFORMER_GRADIENT_CHECKPOINT", "True"]
    opts = NARROW + ["MODEL.BACKBONE", NARROW_SWIN, "MODEL.WEIGHTS", "",
                     "DATASETS.DATA_PATH", data, "MODEL.TRANSFORMER.ENCODER_LAYERS", "1",
                     "MODEL.TRANSFORMER.DECODER_LAYERS", "2", "MODEL.LOSS.MASK_AUX_LOSS", "[0]",
                     "INPUT.SCALE_FACTOR_TRAIN", "0.125", "TEST.START_EVAL_EPOCH", "9"]
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    run = main(common + opts + ["OUTPUT_DIR", straight, "SOLVER.EPOCHS", "2"], device="cpu",
               max_steps=1)
    assert [e["step"] for e in run["epochs"]] == [1, 2]
    assert all(math.isfinite(e["train"]["loss"]) for e in run["epochs"])
    main(common + opts + remat + ["OUTPUT_DIR", split, "SOLVER.EPOCHS", "1"], device="cpu",
         max_steps=1)
    run = main(common + ["--resume", os.path.join(split, "checkpoint")] + opts + remat
               + ["OUTPUT_DIR", split, "SOLVER.EPOCHS", "2"], device="cpu", max_steps=1)
    assert run["start_epoch"] == 1 and run["epochs"][0]["step"] == 2
    a = ckpt.load_checkpoint(os.path.join(straight, "checkpoint"))
    b = ckpt.load_checkpoint(os.path.join(split, "checkpoint"))
    assert a["step"] == b["step"] == 2
    assert any(k.startswith("def_detr.backbone.0.body.layers.") for k in a["model"])
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0, msg=k)
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(b["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    assert torch.equal(a["rng"]["dropout"], b["rng"]["dropout"])
    assert a["rng"]["data"] == b["rng"]["data"]


def test_accuracy_gate_smoke_exits_zero(capsys):
    """`python -m devis_torch.accuracy_gate --smoke` on the CPU: a synthetic
    reference-format image checkpoint through the loading chain into the
    DeVIS model (strictly), TrackMAP on the synthetic VIS set, exit code 0;
    without a benchmark the gate prints its usage and exits 2."""
    from devis_torch import accuracy_gate
    assert accuracy_gate.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "initialized from scratch" in out and accuracy_gate.BAND_NOTE in out
    assert "== accuracy gate ==" in out and "smoke: PASS" in out
    assert accuracy_gate.main([]) == 2
    assert set(accuracy_gate.BENCHMARKS) == {"coco_r50", "coco_r101", "coco_swinl", "yt19_r50",
                                             "yt19_swinl", "yt21_r50", "yt21_swinl",
                                             "ovis_r50", "ovis_swinl"}
