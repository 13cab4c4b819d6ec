"""The port's command line (`devis_torch.main.main`) on the CPU, end to end
from files: `configs/synthetic_smoke.yaml` (the synthetic YouTube-VIS
splits) and the COCO mask-head config over a seeded COCO tree on disk
(`devis_torch.util.fixtures`), both at narrow widths:

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
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        main(["DATASETS.TYPE", "coco_panoptic", "OUTPUT_DIR", str(tmp_path)], device="cpu")
    data = write_vis_tree(str(tmp_path / "data"), n_train=1, n_val=1, n_frames=3, size=(32, 48))
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        main(["--config-file", os.path.join(ROOT, "configs", "devis", "YT-19",
                                            "devis_R_50_YT-19.yaml"),
              "DATASETS.DEVIS.COCO_JOINT_TRAINING", "True", "MODEL.WEIGHTS", "",
              "DATASETS.DATA_PATH", data, "OUTPUT_DIR", str(tmp_path / "o"),
              "MODEL.TRANSFORMER.ENCODER_LAYERS", "1", "MODEL.TRANSFORMER.DECODER_LAYERS", "1"]
             + NARROW, device="cpu")


def test_logging_and_metric_helpers(tmp_path, monkeypatch):
    """The CLI's metrics stream, the visdom sink without its client, the
    memory stats off the card, a profiler trace, and the metric logger's
    `max` / `value` and one-process synchronisation."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.util.logging_utils import (ProfilerSession, VisdomSink, build_metrics,
                                                build_visdom, device_memory_stats)
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
    with ProfilerSession(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
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
