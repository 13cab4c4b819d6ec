"""Training engine (port of `devis_tpu/engine.py`): parameter groups,
optimizer, the train step for clips and for images, and the host epoch loop.

  * AdamW with the reference's five learning-rate groups and a MultiStepLR
    schedule per group, evaluated at the global step.
  * The gradient is clipped by its global norm BEFORE the groups are told
    apart, so the norm includes the gradients of the `frozen` group
    (`backbone.conv1`, `backbone.layer1`, `SOLVER.FROZEN_PARAMS`), which are
    differentiated like the rest and never updated, as in the JAX package.
    `grad_norm` in the metrics is that norm.
  * A non-finite loss skips the update and reports ``finite = 0``;
    `train_one_epoch` raises on it.
  * A clip batch is B clips on one device: the step loops over them, shares
    one `num_boxes` normaliser (their mean target count) and averages their
    losses, as the JAX package's vmap over its clip axis does. An image batch
    is B images in one batched forward and one criterion. Several devices
    (DDP) come later.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from .models import matcher_cfg_from
from .models.criterion import (build_weight_dict, clip_criterion,
                               image_criterion, reduce_num_boxes,
                               weighted_total)
from .models.layers import set_dropout_generator
from .util.misc import MetricLogger

PARAM_GROUPS = ("base", "backbone", "linear_proj", "mask_head",
                "temporal_linear_proj", "frozen")

# The stem and the first stage of the ResNet never train.
_ALWAYS_FROZEN = ("backbone.0.body.conv1", "backbone.0.body.bn1",
                  "backbone.0.body.layer1")


def match_name_keywords(name: str, keywords) -> bool:
    """Substring keyword match on a dotted parameter name."""
    return any(k in name for k in keywords)


def _param_group(name: str, cfg) -> str:
    if match_name_keywords(name, tuple(cfg.SOLVER.FROZEN_PARAMS) + _ALWAYS_FROZEN):
        return "frozen"
    if match_name_keywords(name, cfg.SOLVER.DEVIS.LR_TEMPORAL_LINEAR_PROJ_NAMES):
        return "temporal_linear_proj"
    if match_name_keywords(name, cfg.SOLVER.LR_LINEAR_PROJ_NAMES):
        return "linear_proj"
    if match_name_keywords(name, cfg.SOLVER.LR_MASK_HEAD_NAMES):
        return "mask_head"
    if match_name_keywords(name, cfg.SOLVER.BACKBONE_NAMES):
        return "backbone"
    return "base"


def param_labels(model: nn.Module, cfg) -> Dict[str, str]:
    """Parameter name → its learning-rate group."""
    return {name: _param_group(name, cfg) for name, _ in model.named_parameters()}


def group_base_lrs(cfg) -> Dict[str, float]:
    s = cfg.SOLVER
    return {
        "base": s.BASE_LR,
        "backbone": s.LR_BACKBONE,
        "linear_proj": s.BASE_LR * s.LR_LINEAR_PROJ_MULT,
        "mask_head": s.BASE_LR * s.LR_MASK_HEAD_MULT,
        "temporal_linear_proj": s.BASE_LR * s.DEVIS.LR_TEMPORAL_LINEAR_PROJ_MULT,
    }


def multistep_schedule(base_lr: float, milestones, gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """torch MultiStepLR on epoch granularity, as a function of the global
    step: the rate is multiplied by `gamma` from step m * steps_per_epoch on,
    for every milestone m."""
    bounds = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in bounds)
    return schedule


def build_optimizer(cfg, model: nn.Module, steps_per_epoch: int):
    """AdamW over the five trained groups, one torch parameter group each,
    named by ``group["name"]``. Returns (optimizer, schedules by group,
    labels by parameter name). Frozen parameters are not handed to it."""
    labels = param_labels(model, cfg)
    lrs = group_base_lrs(cfg)
    by_group: Dict[str, List[nn.Parameter]] = {g: [] for g in lrs}
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            by_group[labels[name]].append(p)
    schedules = {g: multistep_schedule(lr, cfg.SOLVER.STEPS, cfg.SOLVER.GAMMA,
                                       steps_per_epoch) for g, lr in lrs.items()}
    optimizer = torch.optim.AdamW(
        [{"params": ps, "lr": lrs[g], "name": g} for g, ps in by_group.items() if ps],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.SOLVER.WEIGHT_DECAY)
    return optimizer, schedules, labels


@dataclass
class TrainState:
    """What a train step reads and updates in place."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: Dict[str, Callable[[int], float]]
    max_norm: float
    step: int = 0
    rng_states: Dict = field(default_factory=dict)   # as restored from a checkpoint

    def apply_gradients(self) -> torch.Tensor:
        """Clip the gradients held by the model's parameters by their global
        norm, set each group's rate for this step, and update. Returns the
        norm before clipping."""
        norm = clip_by_global_norm(self.model.parameters(), self.max_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedules[group["name"]](self.step)
        self.optimizer.step()
        self.step += 1
        return norm


def _grads(params: Iterable[nn.Parameter]) -> List[torch.Tensor]:
    return [p.grad for p in params if p.grad is not None]


def global_norm(params: Iterable[nn.Parameter]) -> torch.Tensor:
    """L2 norm over every gradient (the parameters, and so their gradients,
    are f32)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(_grads(params))))


def clip_by_global_norm(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / norm where norm >= max_norm (the
    rule of `optax.clip_by_global_norm`). Returns the norm before clipping."""
    params = list(params)
    norm = global_norm(params)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(_grads(params), scale)
    return norm


def create_train_state(cfg, model: nn.Module, steps_per_epoch: int,
                       restore_from: Optional[str] = None) -> TrainState:
    """The optimizer and schedule over `model`; with `restore_from` (a
    directory `util.checkpoint.save_checkpoint` wrote), the model, the AdamW
    state and the step as saved there, and the saved RNG states in
    `rng_states` for the caller to set."""
    optimizer, schedules, _ = build_optimizer(cfg, model, steps_per_epoch)
    state = TrainState(model, optimizer, schedules, cfg.SOLVER.GRAD_CLIP_MAX_NORM)
    if restore_from:
        from .util.checkpoint import restore_checkpoint
        state.rng_states = restore_checkpoint(restore_from, state)
    return state


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def make_train_step(model: nn.Module, cfg) -> Callable:
    """Returns `step(state, batch, generator=None) -> (state, metrics)`.

    batch (clips): images (B, T, H, W, 3), pad_mask (B, T, H, W), targets
    {labels (B, N), boxes (B, N, T, 4), valid (B, N, T), exists (B, N), masks
    (B, N, T, h, w)}; batch (images): images (B, H, W, 3), pad_mask
    (B, H, W), targets {labels (B, N), boxes (B, N, 4), valid (B, N), masks
    (B, N, h, w)}; numpy arrays or tensors, moved to the model's device.
    `generator` (on that device) feeds the dropout masks. The model is left
    in training mode. metrics: 0-d tensors `loss`, `grad_norm`, `finite` and
    every loss of the criterion."""
    is_vis = cfg.DATASETS.TYPE == "vis"
    if not is_vis and cfg.DATASETS.TYPE != "coco":
        raise NotImplementedError(f"no train step for {cfg.DATASETS.TYPE!r}: "
                                  "panoptic training is a ROADMAP item")
    mask_on = bool(cfg.MODEL.MASK_ON)
    weight_dict = build_weight_dict(cfg)
    T = cfg.MODEL.DEVIS.NUM_FRAMES
    focal_alpha = cfg.MODEL.LOSS.FOCAL_ALPHA
    mcfg = matcher_cfg_from(cfg, clip=is_vis)

    def finish(state, total, losses):
        ok = torch.isfinite(total)
        if bool(ok):                      # waits for the device
            grad_norm = state.apply_gradients()
        else:
            grad_norm = global_norm(model.parameters())
        return state, {"loss": total, "grad_norm": grad_norm,
                       "finite": ok.float(), **losses}

    def prepare(batch, generator):
        batch = _to_device(batch, next(model.parameters()).device)
        model.train()
        set_dropout_generator(model, generator)
        model.zero_grad(set_to_none=True)
        return batch

    def image_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        batch = prepare(batch, generator)
        targets = batch["targets"]
        if mask_on:
            out = model(batch["images"], batch["pad_mask"], targets=targets,
                        train=True)
        else:                             # the detector alone is matched by the criterion
            out, _ = model(batch["images"], batch["pad_mask"])
        losses = image_criterion(out, targets, mcfg, focal_alpha, mask_on=mask_on)
        total = weighted_total(losses, weight_dict)
        total.backward()
        return finish(state, total.detach(),
                      {k: v.detach() for k, v in losses.items()})

    def clip_step(state: TrainState, batch,
                  generator: Optional[torch.Generator] = None):
        batch = prepare(batch, generator)
        targets = batch["targets"]
        B = batch["images"].shape[0]
        num_boxes = reduce_num_boxes([targets["exists"][b].sum() * T for b in range(B)])
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        for b in range(B):                # one clip's graph at a time
            tb = {k: v[b] for k, v in targets.items()}
            out = model(batch["images"][b], batch["pad_mask"][b], targets=tb,
                        train=True)
            clip = clip_criterion(out, tb, T, mcfg, focal_alpha, num_boxes,
                                  mask_on=mask_on)
            clip_total = weighted_total(clip, weight_dict) / B
            clip_total.backward()
            total = total + clip_total.detach()
            for k, v in clip.items():
                losses[k] = losses.get(k, 0.0) + v.detach() / B
        return finish(state, total, losses)

    return clip_step if is_vis else image_step


def train_one_epoch(step_fn, state: TrainState, data_loader, generator=None,
                    epoch: int = 0, print_freq: int = 10,
                    debug: bool = False) -> Tuple[TrainState, Dict[str, float]]:
    """Host epoch loop: one step per batch, metrics logged; raises
    FloatingPointError on a non-finite loss (the step has skipped its
    update). Batches are `datasets.TrainLoader`'s, numpy, as they come.
    Returns the state and each metric's average over the epoch."""
    logger = MetricLogger(print_freq=print_freq, debug=debug)
    batches = logger.log_every(data_loader, header=f"Epoch: [{epoch}]")
    try:
        for batch in batches:
            state, metrics = step_fn(state, batch, generator)
            host = {k: float(v) for k, v in metrics.items()}
            if host["finite"] < 1.0 or not math.isfinite(host["loss"]):
                raise FloatingPointError(f"Loss is not finite at epoch {epoch}: {host}")
            logger.update(**host)
    finally:
        batches.close()                   # stops the loader's thread
    logger.synchronize_between_processes()
    return state, {k: m.global_avg for k, m in logger.meters.items()}
