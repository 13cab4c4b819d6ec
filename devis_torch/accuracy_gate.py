"""Accuracy gate of the port (port of the JAX package's `accuracy_gate.py`):
one command that reproduces a row of the reference's eval table.

Given a checkpoint and a data path it runs the port's whole evaluation: the
reference checkpoint through the weight surgery (`shift_class_neurons` ->
`prefix_def_detr` -> `adapt_weights_devis`) into the model, then the COCO
evaluation or video in, tracks out with TrackMAP, and compares each metric
with the reference's published number (BASELINE.md). Exit code 0 iff every
metric lies within `--tolerance` (default 0.3 AP).

    python -m devis_torch.accuracy_gate yt21_r50 --weights devis_yt21_r50.pth \\
        --data-path /data/ytvis21
    python -m devis_torch.accuracy_gate --smoke [--device cpu]

The smoke path needs no download: it builds a tiny model, synthesizes a
torch-format image-model checkpoint (the format the reference releases),
pushes it through the loading chain above and `load_state_dict(strict=True)`
(the tensors the reference starts from scratch keep their seeded values),
and evaluates on the synthetic VIS set. The JAX gate's band-coverage audit has
no counterpart: the port's mask head runs exact DCNv2 (K4), so no band
truncates taps. Runs on the GPU unless `--device` names another.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (config, dataset override, expected metrics from BASELINE.md)
BENCHMARKS = {
    "coco_r50": ("configs/deformable_mask_head/deformable_mask_head_R_50.yaml",
                 None, {"box_AP": 46.3, "mask_AP": 38.0}),
    "coco_r101": ("configs/deformable_mask_head/deformable_mask_head_R_101.yaml",
                  None, {"box_AP": 47.9, "mask_AP": 39.9}),
    "coco_swinl": ("configs/deformable_mask_head/deformable_mask_head_SwinL.yaml",
                   None, {"box_AP": 54.6, "mask_AP": 45.2}),
    "yt19_r50": ("configs/devis/YT-19/devis_R_50_YT-19.yaml", None,
                 {"AP": 44.4, "AP50": 67.9, "AP75": 48.6}),
    "yt19_swinl": ("configs/devis/YT-19/devis_Swin_L_YT-19.yaml", None,
                   {"AP": 57.1, "AP50": 80.8, "AP75": 66.3}),
    "yt21_r50": ("configs/devis/YT-21/devis_R_50_YT-21.yaml", None,
                 {"AP": 43.1, "AP50": 66.8, "AP75": 46.6}),
    "yt21_swinl": ("configs/devis/YT-21/devis_Swin_L_YT-21.yaml", None,
                   {"AP": 54.4, "AP50": 77.7, "AP75": 59.8}),
    "ovis_r50": ("configs/devis/OVIS/devis_R_50_OVIS.yaml", None,
                 {"AP": 23.7, "AP50": 47.6, "AP75": 20.8}),
    "ovis_swinl": ("configs/devis/OVIS/devis_Swin_L_OVIS.yaml", None,
                   {"AP": 35.5, "AP50": 59.3, "AP75": 38.3}),
}

BAND_NOTE = ("band-coverage audit: none needed (the mask head's DCNv2 is exact, K4: "
             "no band truncates taps)")


def parse_args(argv=None):
    p = argparse.ArgumentParser("devis_torch accuracy gate")
    p.add_argument("benchmark", nargs="?", choices=sorted(BENCHMARKS),
                   help="reference eval-table row to reproduce")
    p.add_argument("--weights", default="", help="reference .pth or checkpoint directory")
    p.add_argument("--data-path", default="", help="DATASETS.DATA_PATH root")
    p.add_argument("--tolerance", type=float, default=0.3,
                   help="max |ours - reference| per metric (AP points)")
    p.add_argument("--smoke", action="store_true",
                   help="synthetic executability proof (no weights or data)")
    p.add_argument("--device", default=None, help="torch device (the GPU by default)")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="extra KEY VALUE config overrides")
    return p.parse_args(argv)


def load_weights_strict(cfg, model) -> None:
    """MODEL.WEIGHTS into `model` as `main.load_initial_weights` reads it,
    the reference `.pth` then loaded with `load_state_dict(strict=True)`:
    every key of the adapted checkpoint must name a tensor of the model, of
    its shape; the tensors the reference also starts from scratch (a new
    head's class logits, the temporal embedding, ...) keep their seeded
    values."""
    from .main import load_initial_weights, reference_state
    if os.path.isdir(cfg.MODEL.WEIGHTS):
        load_initial_weights(cfg, model)
        return
    own = model.state_dict()
    merged = {k: torch.as_tensor(np.asarray(v)) for k, v in reference_state(cfg, model).items()}
    fresh = [k for k in own if k not in merged]
    merged.update({k: own[k] for k in fresh})
    model.load_state_dict(merged, strict=True)
    print(f"{len(own) - len(fresh)} tensors loaded, {len(fresh)} initialized from scratch")


def run_gate(cfg, expected, tolerance: float, dataset_val=None, device=None) -> int:
    """Builds the model, loads the weights, evaluates and compares. Returns
    a process exit code."""
    from .datasets import build_dataset
    from .inference import build_tracker, evaluate_coco, inference_vis
    from .models import build_model
    from .util.misc import resolve_device
    device = resolve_device(device)
    if dataset_val is None:
        dataset_val, num_classes = build_dataset("VAL", cfg)
    else:
        dataset_val, num_classes = dataset_val
    model = build_model(num_classes, cfg, device=device, seed=cfg.SEED)
    load_weights_strict(cfg, model)
    print(BAND_NOTE)
    got = {}
    if cfg.DATASETS.TYPE == "vis":
        out = inference_vis(build_tracker(cfg, model, device=device), dataset_val)
        if "eval" not in out:
            print("dataset has no GT: the gate needs a GT-bearing val split")
            return 2
        got = {k: float(v) for k, v in out["eval"].items() if isinstance(v, (int, float))}
    else:
        stats = evaluate_coco(model, dataset_val, cfg, device=device)
        got["box_AP"] = float(stats["bbox"]["AP"])
        if "segm" in stats:
            got["mask_AP"] = float(stats["segm"]["AP"])

    print("\n== accuracy gate ==")
    if expected is None:
        print(json.dumps(got))
        print("(smoke mode: no reference numbers to compare; gate path executed end-to-end)")
        return 0 if all(np.isfinite(v) for v in got.values()) else 1
    rc = 0
    for k, ref in expected.items():
        ours = got.get(k)
        if ours is None:
            print(f"  {k:8s} reference {ref:5.1f}  ours MISSING        FAIL")
            rc = 1
            continue
        ok = abs(ours - ref) <= tolerance
        print(f"  {k:8s} reference {ref:5.1f}  ours {ours:5.1f}  "
              f"delta {ours - ref:+.2f}  {'PASS' if ok else 'FAIL'}")
        rc = rc if ok else 1
    print("gate:", "PASS" if rc == 0 else "FAIL")
    return rc


def _fake_state(keys, seed: int = 0):
    """Seeded values for a {key: shape} map: N(0, 0.02), norm scales near 1,
    positive variances."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, shape in keys.items():
        v = (rng.randn(*shape) * 0.02).astype(np.float32)
        if "running_var" in k:
            v = np.abs(v) + 0.5
        if k.endswith(".weight") and len(shape) == 1:
            v += 1.0
        state[k] = torch.from_numpy(v)
    return state


def run_smoke(device=None) -> int:
    """Executability proof: a synthetic reference-format checkpoint and the
    synthetic VIS set through the gate's path."""
    from .config import get_cfg_defaults
    from .datasets.synthetic import SyntheticVISValDataset
    from .models import build_model
    from .util import checkpoint as ckpt_lib

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic_smoke.yaml"))
    cfg.MODEL.MASK_HEAD.USE_MDC = True
    # the reference releases image-model checkpoints (the COCO mask-head
    # model): their names come from an image-mode twin of the config, so
    # `adapt_weights_devis` does the real temporal surgery on load
    img_cfg = cfg.clone()
    img_cfg.DATASETS.TYPE = "coco"
    img_cfg.MODEL.NUM_QUERIES = 60              # / 12 trajectories: subsampled
    keys = ckpt_lib.model_keys(build_model(91, img_cfg, device="cpu"))
    state = _fake_state(keys)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "smoke_image_model.pth")
        torch.save({"model": state}, path)
        cfg.MODEL.WEIGHTS = path
        cfg.freeze()
        dataset = SyntheticVISValDataset(
            num_frames=cfg.MODEL.DEVIS.NUM_FRAMES, stride=cfg.TEST.CLIP_TRACKING.STRIDE,
            n_videos=2, video_len=8, size=(96, 128), min_size=cfg.INPUT.MIN_SIZE_TEST,
            max_size=cfg.INPUT.MAX_SIZE_TEST)
        rc = run_gate(cfg, expected=None, tolerance=0.3, dataset_val=(dataset, 41),
                      device=device)
    print("smoke:", "PASS" if rc == 0 else "FAIL")
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.smoke:
        return run_smoke(args.device)
    if not args.benchmark:
        print("usage: python -m devis_torch.accuracy_gate BENCHMARK --weights W "
              "--data-path D | --smoke")
        return 2
    from .config import get_cfg_defaults, sanity_check
    config_file, _, expected = BENCHMARKS[args.benchmark]
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, config_file))
    if args.weights:
        cfg.MODEL.WEIGHTS = args.weights
    if args.data_path:
        cfg.DATASETS.DATA_PATH = args.data_path
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    sanity_check(cfg)
    return run_gate(cfg, expected, args.tolerance, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
