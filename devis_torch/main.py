"""The port's command line (port of `devis_tpu/main.py`; reference
`main.py:97-407`): train and evaluate from files on disk.

    python -m devis_torch.main --config-file configs/devis/YT-19/devis_R_50_YT-19.yaml \
        [--eval-only] [--resume OUTPUT_DIR/checkpoint] [KEY VALUE ...]

The flow: the config file and the overrides (read by the port's own YAML
reader), seeding, the datasets of `DATASETS.TYPE` (`coco` or `vis`), the
model with its initial weights (`MODEL.WEIGHTS`: a reference `.pth`, with the
weight surgery, or a checkpoint directory), then either

  * `--eval-only`: the COCO evaluation (`evaluate_coco`) or video in, tracks
    out with TrackMAP (`build_tracker` + `inference_vis`), of the loaded
    weights or, with `TEST.INPUT_FOLDER`, of each
    `checkpoint_epoch_{e}` there for e in `TEST.EPOCHS_TO_EVAL`; or
  * training: epochs of `train_one_epoch` over `TrainLoader` (the JAX CLI's
    buckets and instance slots), the evaluation from `TEST.START_EVAL_EPOCH`
    every `TEST.EVAL_PERIOD` epochs with the best checkpoint kept
    (`checkpoint_best_{key}/`), `checkpoint/` with its `meta.json` after
    every epoch and `checkpoint_epoch_{e}/` every `SOLVER.CHECKPOINT_INTERVAL`
    epochs. `--resume DIR` restores the model, AdamW, the step and the RNG
    states and starts at `meta.json`'s epoch + 1 with its `best_stats`.

One process on one card, which the entry point uses unless the caller of
`main` names another device. `coco_panoptic`, Swin and more than one rank
raise, naming their ROADMAP.md items.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

TRAIN_SCALES = (480, 512, 544, 576, 608, 640)


def parse_args(argv=None):
    p = argparse.ArgumentParser("devis_torch")
    p.add_argument("--config-file", default="", help="YAML config")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", default="", help="checkpoint directory to resume from")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    return p.parse_args(argv)


def setup_cfg(args):
    from .config import get_cfg_defaults, sanity_check
    cfg = get_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    sanity_check(cfg)
    return cfg


def seed_everything(seed: int) -> None:
    """Seeds Python's, numpy's and torch's global generators (reference
    main.py:104-118). The port's own randomness comes from generators made
    from the seed and passed explicitly."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def load_initial_weights(cfg, model) -> None:
    """MODEL.WEIGHTS into `model`: a checkpoint directory of the port, or a
    reference `.pth` through the weight surgery (reference main.py:269-328
    and weights_loading_utils.py). Parameters the file lacks keep their
    seeded values."""
    from .util import checkpoint as ckpt_lib

    path = cfg.MODEL.WEIGHTS
    if not path:
        return
    if os.path.isdir(path):
        model.load_state_dict(ckpt_lib.load_checkpoint(path)["model"], strict=True)
        return
    state = ckpt_lib.load_torch_checkpoint(path)
    if cfg.MODEL.SHIFT_CLASS_NEURON:
        state = ckpt_lib.shift_class_neurons(state)
    if cfg.MODEL.MASK_ON and not any(k.startswith("def_detr") for k in state):
        state = ckpt_lib.prefix_def_detr(state)
    if cfg.DATASETS.TYPE == "vis":
        da = cfg.MODEL.DEVIS.DEFORMABLE_ATTENTION
        state = ckpt_lib.adapt_weights_devis(
            state, ckpt_lib.model_keys(model), lvl_res=cfg.MODEL.NUM_FEATURE_LEVELS,
            focal_loss=cfg.MODEL.LOSS.FOCAL_LOSS,
            finetune_class_logits=cfg.SOLVER.DEVIS.FINETUNE_CLASS_LOGITS,
            num_frames=cfg.MODEL.DEVIS.NUM_FRAMES,
            finetune_query_embds=cfg.SOLVER.DEVIS.FINETUNE_QUERY_EMBEDDINGS,
            finetune_temporal_modules=cfg.SOLVER.DEVIS.FINETUNE_TEMPORAL_MODULES,
            enc_connect_all_frames=da.ENC_CONNECT_ALL_FRAMES,
            enc_temporal_window=da.ENC_TEMPORAL_WINDOW,
            enc_n_temporal_points=da.ENC_N_POINTS_TEMPORAL_FRAME,
            dec_n_temporal_points=da.DEC_N_POINTS_TEMPORAL_FRAME)
    missing, _ = ckpt_lib.load_state_into(model, state, verbose=True)
    if missing:
        print(f"{len(missing)} tensors initialized from scratch")


def _evaluate(cfg, model, dataset, device, output_dir: Optional[str] = None,
              selected_videos: Optional[List[str]] = None):
    """(key, the stat the best checkpoint is kept by, the full result)."""
    from .inference import build_tracker, evaluate_coco, inference_vis
    if cfg.DATASETS.TYPE == "vis":
        out = inference_vis(build_tracker(cfg, model, device=device), dataset,
                            output_dir=output_dir, selected_videos=selected_videos)
        ev = {k: v for k, v in out.get("eval", {}).items() if isinstance(v, float)}
        return "vis_ap", ev.get("AP", 0.0), {"eval": ev, "fps": out["fps"]}
    stats = evaluate_coco(model, dataset, cfg, device=device)
    return "coco_ap", stats["bbox"]["AP"], stats


def _data_rng(dataset) -> Optional[random.Random]:
    """The random.Random a training dataset's augmentation draws from."""
    return getattr(getattr(dataset, "transform", None), "rng", None)


def build_train_loader(cfg, dataset, max_batches: Optional[int] = None):
    """The training loader of `main`: the JAX CLI's buckets (TRAIN_SCALES
    and 1333, times INPUT.SCALE_FACTOR_TRAIN), as many instance slots as a
    frame has queries at most, the shuffle of `cfg.SEED`; `max_batches`
    cuts each epoch (`TrainLoader`)."""
    from .datasets import TrainLoader, make_buckets
    sf = cfg.INPUT.SCALE_FACTOR_TRAIN
    is_vis = cfg.DATASETS.TYPE == "vis"
    # instance slots cannot outnumber the queries a frame can be matched to
    T = cfg.MODEL.DEVIS.NUM_FRAMES if is_vis else 1
    return TrainLoader(dataset, cfg.SOLVER.BATCH_SIZE, vis=is_vis,
                       buckets=make_buckets([int(sf * s) for s in TRAIN_SCALES], int(sf * 1333)),
                       max_instances=min(cfg.TPU.MAX_INSTANCES, cfg.MODEL.NUM_QUERIES // T),
                       seed=cfg.SEED, max_batches=max_batches)


def main(argv=None, device=None, max_steps: Optional[int] = None) -> Dict:
    """Runs the CLI with `argv` (sys.argv[1:] when None) on `device` (the
    GPU unless named). `max_steps` cuts each epoch to its first batches
    (smoke runs; the loader builds no batch past them, so the saved data
    RNG state is that of the steps taken). Returns what it printed: the evaluations of `--eval-only`, or
    each epoch's train averages and evaluation and the best stats."""
    args = parse_args(argv)
    cfg = setup_cfg(args)
    seed_everything(cfg.SEED)

    from .datasets import build_dataset
    from .engine import create_train_state, make_train_step, train_one_epoch
    from .models import build_model
    from .util import checkpoint as ckpt_lib
    from .util.logging_utils import build_metrics, build_visdom, device_memory_stats
    from .util.misc import resolve_device

    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError("the port's CLI runs in one process; DDP is ROADMAP.md "
                                  "queue A item 3")
    if cfg.DATASETS.TYPE not in ("coco", "vis"):
        raise NotImplementedError(f"DATASETS.TYPE {cfg.DATASETS.TYPE!r}: panoptic "
                                  "segmentation is ROADMAP.md queue A item 5 of the port")
    device = resolve_device(device)
    output_dir = cfg.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        f.write(cfg.dump())

    dataset_val, num_classes = build_dataset("VAL", cfg)
    model = build_model(num_classes, cfg, device=device, seed=cfg.SEED)
    load_initial_weights(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.MODEL.BACKBONE} | params {n_params / 1e6:.1f}M | device {device}")

    if args.eval_only:
        selected = cfg.TEST.VIZ.VIDEO_NAMES.split(",") if cfg.TEST.VIZ.VIDEO_NAMES else None

        def run_eval(tag: str = ""):
            _, stat, result = _evaluate(cfg, model, dataset_val, device,
                                        os.path.join(output_dir, cfg.TEST.SAVE_PATH + tag),
                                        selected)
            print(tag, json.dumps(result.get("eval", result)))
            return stat, result

        if not cfg.TEST.INPUT_FOLDER:
            return {"eval": run_eval()[1]}
        results, best, best_ep = {}, -1.0, None       # reference main.py:163-193
        for ep in cfg.TEST.EPOCHS_TO_EVAL:
            path = os.path.join(cfg.TEST.INPUT_FOLDER, f"checkpoint_epoch_{ep}")
            if not os.path.exists(path):
                print(f"skip missing {path}")
                continue
            model.load_state_dict(ckpt_lib.load_checkpoint(path)["model"], strict=True)
            stat, results[ep] = run_eval(f"_epoch{ep}")
            if stat > best:
                best, best_ep = stat, ep
        print(f"best epoch {best_ep}: AP {best:.2f}")
        return {"eval": results, "best_epoch": best_ep}

    dataset_train, _ = build_dataset("TRAIN", cfg)
    loader = build_train_loader(cfg, dataset_train, max_steps)
    state = create_train_state(cfg, model, max(len(loader), 1),
                               restore_from=args.resume or None)
    generator = torch.Generator(device=device).manual_seed(cfg.SEED)    # dropout
    data_rng = _data_rng(dataset_train)
    start_epoch, best_stats = 0, {}
    if args.resume:
        if "dropout" in state.rng_states:
            generator.set_state(state.rng_states["dropout"])
        if data_rng is not None and "data" in state.rng_states:
            data_rng.setstate(state.rng_states["data"])
        meta_path = os.path.join(args.resume, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            start_epoch = meta.get("epoch", -1) + 1
            best_stats = meta.get("best_stats", {})

    def rng_states():
        out = {"dropout": generator.get_state()}
        if data_rng is not None:
            out["data"] = data_rng.getstate()
        return out

    step_fn = make_train_step(model, cfg)
    visdom = build_visdom(cfg)
    history = []
    with build_metrics(cfg) as metrics:
        for epoch in range(start_epoch, cfg.SOLVER.EPOCHS):
            loader.set_epoch(epoch)
            t0 = time.time()
            state, train_stats = train_one_epoch(step_fn, state, loader, generator, epoch)
            print(f"epoch {epoch}: {time.time() - t0:.1f}s "
                  f"loss {train_stats.get('loss', float('nan')):.4f}")
            metrics.write(epoch, {**train_stats, **device_memory_stats(device)},
                          kind="train_epoch")
            if visdom:
                visdom.plot("train", epoch, {k: v for k, v in train_stats.items() if k in (
                    "loss", "loss_ce", "loss_bbox", "loss_giou", "loss_mask", "loss_dice",
                    "class_error")})
            record = {"epoch": epoch, "train": train_stats, "step": state.step}
            # periodic evaluation (reference main.py:349-361)
            if (epoch + 1) >= cfg.TEST.START_EVAL_EPOCH \
                    and (epoch + 1) % cfg.TEST.EVAL_PERIOD == 0:
                key, stat, record["eval"] = _evaluate(cfg, model, dataset_val, device)
                if stat > best_stats.get(key, -1):
                    best_stats[key] = stat
                    ckpt_lib.save_checkpoint(os.path.join(output_dir, f"checkpoint_best_{key}"),
                                             state, rng_states())
                print(f"eval epoch {epoch}: {key}={stat:.2f} (best {best_stats[key]:.2f})")
                metrics.write(epoch, {key: stat}, kind="eval")
            # checkpoints (reference main.py:332-385)
            ckpt_dir = os.path.join(output_dir, "checkpoint")
            ckpt_lib.save_checkpoint(ckpt_dir, state, rng_states())
            with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
                json.dump({"epoch": epoch, "best_stats": best_stats}, f)
            if (epoch + 1) % cfg.SOLVER.CHECKPOINT_INTERVAL == 0:
                ckpt_lib.save_checkpoint(os.path.join(output_dir, f"checkpoint_epoch_{epoch}"),
                                         state, rng_states())
            history.append(record)
    return {"epochs": history, "best_stats": best_stats, "start_epoch": start_epoch}


if __name__ == "__main__":
    main()
