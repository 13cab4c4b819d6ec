"""End-to-end learning check: overfit DeVIS on synthetic clips, then track
the same videos and score them (port of `benchmarks/overfit_synthetic.py`).

    python -m devis_torch.overfit_synthetic [steps=1000] [--no-mdc]

Trains a small DeVIS (T = 4 at 128x192, 2 + 2 layers, 24 queries, f32,
LR 4e-4) on the clips of 2 deterministic synthetic videos of 8 frames, one
clip a step, with the loss printed every 10 steps; asserts that the loss
halves; then runs `build_tracker` + `inference_vis` over the same videos for
TrackMAP, and prints the JAX script's diagnostics: predicted and
ground-truth track counts, each predicted track's best ground-truth IoU, the
IoU between predicted tracks of one video (the collapse check: at r4 of the
JAX package every track had collapsed into one blob, IoU 0.999, while the
loss fell from 19.9 to 2.4), and the mask IoU of the training forward on a
train clip. It is the one check that runs the training path for many steps
and then scores what was learned; the parity tests hold one step each.

The settings are the JAX script's (`SETTINGS`, `overfit_cfg`, the seeds).
Where the port differs from it:

  * No band-coverage audit and no `--exact-eval`: the port's DCNv2 kernel is
    exact in training and in evaluation (ROADMAP.md C, chosen differences),
    so every run matches the JAX trendline's "exact XLA eval twin" row.
  * AP is reported against the trendline (34.6 with the MDC head, 41.0 with
    the plain conv, docs/PERFORMANCE.md:391-392), not gated at 50: the JAX
    script's `assert ap > 50` fails on the JAX package's own state. `main`
    returns a dict of the losses, the TrackMAP summary and the diagnostics,
    and raises (the command exits non-zero) when the loss does not halve or
    when the tracks collapse (every pred-vs-pred IoU at least 0.99).
  * The weights are the port's seeded initialisation (seed 0) and the
    dropout masks come from a generator seeded 7, where the JAX script
    draws from PRNGKey(0) and PRNGKey(7).

Runs on the GPU unless `main` is given another device.
"""
from __future__ import annotations

import itertools
import sys
import time
from typing import Dict, List, Optional

import torch

NUM_CLASSES = 41
COLLAPSE_IOU = 0.99
SETTINGS = {
    "num_frames": 4, "size": (128, 192),
    "encoder_layers": 2, "decoder_layers": 2, "num_queries": 24, "mask_aux_loss": [0],
    "num_out": 6, "stride": 2, "min_size_test": 128, "max_size_test": 192,
    "base_lr": 4e-4, "compute_dtype": "float32",
    "n_videos": 2, "video_len": 8, "max_instances": 4,
    "model_seed": 0, "dropout_seed": 7,
}


def overfit_cfg(mdc: bool = True, overrides=()):
    """The JAX script's configuration (`benchmarks/overfit_synthetic.py:37-52`);
    `overrides` are KEY VALUE pairs merged last (the tests narrow it)."""
    from .config import get_cfg_defaults
    s = SETTINGS
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = s["encoder_layers"]
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = s["decoder_layers"]
    cfg.MODEL.DEVIS.NUM_FRAMES = s["num_frames"]
    cfg.MODEL.NUM_QUERIES = s["num_queries"]
    cfg.MODEL.LOSS.MASK_AUX_LOSS = list(s["mask_aux_loss"])
    cfg.TEST.NUM_OUT = s["num_out"]
    cfg.TEST.CLIP_TRACKING.STRIDE = s["stride"]
    cfg.INPUT.MIN_SIZE_TEST = s["min_size_test"]
    cfg.INPUT.MAX_SIZE_TEST = s["max_size_test"]
    cfg.SOLVER.BASE_LR = s["base_lr"]
    cfg.TPU.COMPUTE_DTYPE = s["compute_dtype"]
    cfg.MODEL.MASK_HEAD.USE_MDC = bool(mdc)
    if overrides:
        cfg.merge_from_list(list(overrides))
    cfg.freeze()
    return cfg


def train_clips(cfg) -> List[Dict]:
    """Every clip of the synthetic train videos through `collate_clip`."""
    from .datasets import collate_clip
    from .datasets.synthetic import SyntheticVISDataset
    s = SETTINGS
    T, (H, W) = cfg.MODEL.DEVIS.NUM_FRAMES, s["size"]
    ds = SyntheticVISDataset(num_frames=T, n_videos=s["n_videos"],
                             video_len=s["video_len"], size=(H, W))
    return [collate_clip(ds[i], (H, W), max_instances=s["max_instances"])
            for i in range(len(ds))]


def val_dataset(cfg):
    from .datasets.synthetic import SyntheticVISValDataset
    s = SETTINGS
    return SyntheticVISValDataset(num_frames=cfg.MODEL.DEVIS.NUM_FRAMES, stride=s["stride"],
                                  n_videos=s["n_videos"], video_len=s["video_len"],
                                  size=s["size"], min_size=s["min_size_test"],
                                  max_size=s["max_size_test"])


def track_diagnostics(results: List[Dict], gt: Dict) -> Dict:
    """Track counts, each predicted track's best ground-truth IoU, and the
    IoU of every pair of predicted tracks of one video."""
    from .evaluation.track_map import _track_from_segmentations, mask_track_iou
    tracks = [_track_from_segmentations(r["segmentations"]) for r in results]
    gt_tracks = [(a["video_id"], _track_from_segmentations(a["segmentations"]))
                 for a in gt["annotations"]]
    best_gt = [max((mask_track_iou(t, g) for vid, g in gt_tracks if vid == r["video_id"]),
                   default=0.0) for r, t in zip(results, tracks)]
    pred_pred = [mask_track_iou(tracks[i], tracks[j])
                 for i, j in itertools.combinations(range(len(results)), 2)
                 if results[i]["video_id"] == results[j]["video_id"]]
    return {"pred_tracks": len(results), "gt_tracks": len(gt["annotations"]),
            "best_gt_iou": best_gt, "pred_pred_iou": pred_pred,
            "collapsed": bool(pred_pred) and min(pred_pred) >= COLLAPSE_IOU}


@torch.no_grad()
def train_path_mask_iou(model, clip: Dict, device, n: int = 3) -> List[float]:
    """The training forward (matched trajectories, dropout off) on a train
    clip: each of the first `n` instances' frame-0 mask against its target,
    nearest-resized to the prediction's grid."""
    from .datasets.transforms import resize_nearest_numpy
    was_training = model.training
    model.eval()
    try:
        targets = {k: torch.as_tensor(v).to(device) for k, v in clip["targets"].items()}
        out = model(torch.as_tensor(clip["images"]).to(device),
                    torch.as_tensor(clip["pad_mask"]).to(device), targets=targets, train=True)
    finally:
        model.train(was_training)
    pm = out["pred_masks"].float().cpu().numpy()                # (N, T, h, w) logits
    tm = clip["targets"]["masks"]                               # (N, T, hm, wm)
    ious = []
    for i in range(min(n, pm.shape[0])):
        pred = pm[i, 0] > 0.0
        gtm = resize_nearest_numpy(tm[i, 0], pm.shape[2:4]) > 0.5
        ious.append(float((pred & gtm).sum() / max((pred | gtm).sum(), 1)))
    return ious


def build(mdc: bool = True, device=None, overrides=()):
    """(cfg, the model from its seed on `device`, the train clips)."""
    from .models import build_model
    from .util.misc import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = overfit_cfg(mdc, overrides)
    model = build_model(NUM_CLASSES, cfg, device=device, seed=SETTINGS["model_seed"])
    return cfg, model, train_clips(cfg)


def clip_batch(clip: Dict) -> Dict:
    """One collated clip as a train batch of one clip."""
    return {k: ({kk: vv[None] for kk, vv in v.items()} if isinstance(v, dict) else v[None])
            for k, v in clip.items() if k != "sizes"}


def train(cfg, model, clips: List[Dict], steps: int, log=print):
    """`steps` steps of `make_train_step`, clip i % len(clips) at step i.
    Returns ([(step, loss)] every 10 steps and at the last, seconds a step,
    the last step's metrics: every loss of the criterion)."""
    from .engine import create_train_state, make_train_step
    device = next(model.parameters()).device
    state = create_train_state(cfg, model, steps_per_epoch=len(clips))
    step_fn = make_train_step(model, cfg)
    generator = torch.Generator(device=device).manual_seed(SETTINGS["dropout_seed"])
    batches = [clip_batch(clip) for clip in clips]
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step_fn(state, batches[i % len(batches)], generator)
        if i % 10 == 0 or i == steps - 1:
            losses.append((i, float(m["loss"])))
            log(f"step {i}: loss {losses[-1][1]:.4f} "
                f"({(time.perf_counter() - t0) / (i + 1):.3f} s/step)", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (losses, (time.perf_counter() - t0) / max(steps, 1),
            {k: float(v) for k, v in m.items()} if steps else {})


def evaluate(cfg, model, verbose: bool = True) -> Dict:
    """`build_tracker` + `inference_vis` over the synthetic videos: the
    TrackMAP summary and the run's results."""
    from .inference import build_tracker, inference_vis
    device = next(model.parameters()).device
    return inference_vis(build_tracker(cfg, model, device=device), val_dataset(cfg),
                         verbose=verbose)


def report(cfg, model, clips, losses, sec_per_step, out, log=print,
           final: Optional[Dict] = None) -> Dict:
    """The diagnostics and the result dict of `main`."""
    diag = track_diagnostics(out["results"], val_dataset(cfg).gt_dict())
    diag["train_mask_iou"] = train_path_mask_iou(model, clips[0],
                                                 next(model.parameters()).device)
    e = out["eval"]
    mdc = bool(cfg.MODEL.MASK_HEAD.USE_MDC)
    log(f"DIAG: {diag['pred_tracks']} predicted tracks, {diag['gt_tracks']} gt tracks")
    log("  best gt IoU per predicted track: "
        + " ".join(f"{v:.3f}" for v in diag["best_gt_iou"]))
    log("  pred-vs-pred track IoU: " + " ".join(f"{v:.3f}" for v in diag["pred_pred_iou"])
        + (" COLLAPSED" if diag["collapsed"] else ""))
    log("  TRAIN-path mask IoU: " + " ".join(f"{v:.3f}" for v in diag["train_mask_iou"]))
    log(f"RESULT loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}, TrackMAP AP {e['AP']:.1f} "
        f"AP50 {e['AP50']:.1f} AP75 {e['AP75']:.1f} ({'MDC' if mdc else 'plain conv'} head, "
        f"{sec_per_step:.4f} s/step)")
    if final:
        log("  last step's losses: " + " ".join(
            f"{k} {v:.4f}" for k, v in final.items() if k.startswith("loss") and
            not k[-1].isdigit()))
    return {"losses": losses, "halved": losses[-1][1] < 0.5 * losses[0][1],
            "final": final or {}, "sec_per_step": sec_per_step, "mdc": mdc,
            "eval": {k: v for k, v in e.items() if isinstance(v, float)},
            "diagnostics": diag}


def check(result: Dict) -> None:
    """The JAX script's assertion that the loss halves, and the collapse
    check."""
    losses = result["losses"]
    if not result["halved"]:
        raise AssertionError(f"loss did not halve: {losses[0][1]:.3f} -> {losses[-1][1]:.3f}")
    if result["diagnostics"]["collapsed"]:
        raise AssertionError(f"tracks collapsed: every pred-vs-pred IoU >= {COLLAPSE_IOU}")


def main(steps: int = 1000, mdc: bool = True, device=None, overrides=(),
         verbose: bool = True, checked: bool = True) -> Dict:
    """Trains `steps` steps, tracks and scores; returns {"losses": [(step,
    loss)], "halved", "sec_per_step", "mdc", "eval": TrackMAP summary,
    "diagnostics"}. With `checked`, raises AssertionError (after the
    diagnostics) when the loss did not halve or the tracks collapsed."""
    log = print if verbose else (lambda *a, **k: None)
    cfg, model, clips = build(mdc, device, overrides)
    losses, sec_per_step, final = train(cfg, model, clips, steps, log)
    result = report(cfg, model, clips, losses, sec_per_step,
                    evaluate(cfg, model, verbose), log, final)
    if checked:
        check(result)
    return result


def cli(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(next((a for a in argv if not a.startswith("-")), 1000))
    try:
        main(steps, mdc="--no-mdc" not in argv)
    except AssertionError as e:
        print(f"OVERFIT FAILED: {e}", file=sys.stderr)
        return 1
    print("OVERFIT OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
