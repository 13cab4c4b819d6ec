"""Plain reference of the training steps the benchmark times.

From the raw samples the harness made (content-sized images, instance masks,
boxes, labels) it works out again what the program derives: the batch order
of an epoch, the padded canvas, the instance slots and the /4 target masks;
then the matching (scipy's assignment), the set-prediction losses, the
gradient clip by global norm and AdamW with the configuration's learning-rate
groups. Float32 with TF32 off; `quantizer` gives the control's narrower
operands. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from . import model as M

BIG = 1e5


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def epoch_order(n: int, batch: int, seed: int, epoch: int = 0) -> List[np.ndarray]:
    """The dataset indices of each full batch of an epoch: numpy's
    RandomState(seed + epoch) shuffle, the last partial batch dropped."""
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return [order[i:i + batch] for i in range(0, n - batch + 1, batch)]


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def canvas(h: int, w: int, scales: Sequence[int], max_size: int) -> Tuple[int, int]:
    """The smallest of the two orientation buckets (the largest training
    scale by `max_size`, each rounded up to 64) that holds (h, w)."""
    s, m = round_up(max(scales), 64), round_up(max_size, 64)
    for bh, bw in ((s, m), (m, s)):
        if h <= bh and w <= bw:
            return bh, bw
    return round_up(h, 64), round_up(w, 64)


def small_masks(masks: np.ndarray, stride: int = 4) -> np.ndarray:
    """(..., h, w) masks at (round(h / stride), round(w / stride)) by
    OpenCV's nearest rule, float32."""
    h, w = masks.shape[-2:]
    oh, ow = max(round(h / stride), 1), max(round(w / stride), 1)
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return np.asarray(masks, np.float32)[..., ys, :][..., xs]


def collate(samples: List[Dict], slots: int, scales, max_size: int) -> Dict:
    """Clips to the padded batch: images (B, T, H, W, 3), pad (True on
    padding), targets padded to `slots`, masks on the canvas's /4 grid."""
    H, W = canvas(max(s["images"].shape[-3] for s in samples),
                  max(s["images"].shape[-2] for s in samples), scales, max_size)
    out = []
    for s in samples:
        img = s["images"]
        lead = img.shape[:-3]
        h, w = img.shape[-3:-1]
        images = np.zeros(lead + (H, W, 3), np.float32)
        pad = np.ones(lead + (H, W), bool)
        images[..., :h, :w, :] = img
        pad[..., :h, :w] = False
        n = min(len(s["labels"]), slots)
        tail = s["boxes"].shape[1:-1]                       # (T,)
        labels = np.zeros((slots,), np.int64)
        boxes = np.full((slots,) + tail + (4,), 0.5, np.float32)
        valid = np.zeros((slots,) + tail, bool)
        masks = np.zeros((slots,) + tail + (H // 4, W // 4), np.float32)
        labels[:n] = s["labels"][:n]
        boxes[:n] = s["boxes"][:n]
        valid[:n] = s["valid"][:n]
        if n:
            sm = small_masks(s["masks"][:n])
            masks[:n, ..., :sm.shape[-2], :sm.shape[-1]] = sm
        exists = np.zeros((slots,), bool)
        exists[:n] = s["exists"][:n]
        t = {"labels": labels, "boxes": boxes, "valid": valid, "masks": masks, "exists": exists}
        out.append({"images": images, "pad": pad, "targets": t})
    return out


# ---------------------------------------------------------------------------
# matching and losses
# ---------------------------------------------------------------------------

def box_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(a, b):
    """Generalized IoU of broadcastable xyxy boxes."""
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a) + area(b) - inter
    hull = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    hull_area = hull[..., 0] * hull[..., 1]
    return inter / union.clamp(min=1e-9) - (hull_area - union) / hull_area.clamp(min=1e-9)


def focal_costs(prob, alpha: float):
    neg = (1 - alpha) * prob ** 2 * -torch.log(1 - prob + 1e-8)
    pos = alpha * (1 - prob) ** 2 * -torch.log(prob + 1e-8)
    return pos - neg


def assign(cost: torch.Tensor, live: torch.Tensor, assign_fn) -> torch.Tensor:
    """cost (Q, N), live (N,) → the query of each target slot (N,)."""
    cost = torch.nan_to_num(cost.float(), nan=BIG, posinf=BIG, neginf=-BIG)
    cost = torch.where(live[None, :], cost, cost.new_tensor(BIG))
    return assign_fn(cost.t())


def scipy_assign(cost_t: torch.Tensor) -> torch.Tensor:
    """(N, Q) costs → the column of each row, by scipy's exact solver."""
    rows, cols = linear_sum_assignment(cost_t.detach().double().cpu().numpy())
    out = np.zeros(cost_t.shape[0], np.int64)
    out[rows] = cols
    return torch.from_numpy(out).to(cost_t.device)


@torch.no_grad()
def match_clip(lv, t, T: int, a: Dict, assign_fn):
    K = lv["pred_logits"].shape[-1]
    logits = lv["pred_logits"][0].float().reshape(T, -1, K)
    boxes = lv["pred_boxes"][0].float().reshape(T, -1, 4)
    live = t["valid"] & t["exists"][:, None]
    cls = focal_costs(torch.sigmoid(logits), a["focal_alpha"])[:, :, t["labels"]].mean(0)
    tgt = t["boxes"].float().transpose(0, 1)                 # (T, N, 4)
    diff = (boxes[:, :, None] - tgt[:, None]).abs()
    l1 = diff.sum(-1).mean(0) if a["use_sum_l1"] else diff.mean((0, -1))
    g = -giou(box_xyxy(boxes)[:, :, None], box_xyxy(tgt)[:, None]).mean(0)
    cost = a["cost_class"] * cls + a["cost_bbox"] * l1 + a["cost_giou"] * g
    return assign(cost, live.any(1), assign_fn)


def focal_loss(x, y, num, alpha: float = 0.25, valid=None):
    p = torch.sigmoid(x)
    ce = F.binary_cross_entropy_with_logits(x, y, reduction="none")
    p_t = p * y + (1 - p) * (1 - y)
    loss = ce * (1 - p_t) ** 2
    loss = (alpha * y + (1 - alpha) * (1 - y)) * loss
    loss = loss.mean(1).reshape(loss.shape[0], -1).sum(1)
    if valid is not None:
        loss = loss * valid
    return loss.sum() / num


def dice_loss(x, y, num, valid):
    x = torch.sigmoid(x).reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    loss = 1 - (2 * (x * y).sum(1) + 1) / (x.sum(1) + y.sum(1) + 1)
    return (loss * valid).sum() / num


def mask_losses(pred, tgt, num, weight):
    up = pred
    if pred.shape[-2:] != tgt.shape[-2:]:
        up = F.interpolate(pred, size=tgt.shape[-2:], mode="bilinear", align_corners=False)
    up = up.reshape(-1, up.shape[-2] * up.shape[-1])
    tm = tgt.reshape(up.shape[0], -1)
    vm = weight.reshape(-1)
    return focal_loss(up, tm, num, valid=vm), dice_loss(up, tm, num, vm)


def clip_level_losses(lv, t, idx, num, T: int, a: Dict, masks=None):
    logits = lv["pred_logits"].float()
    TQ, K = logits.shape[1:]
    Nq = TQ // T
    N = t["labels"].shape[0]
    live = t["valid"] & t["exists"][:, None]
    pos = torch.arange(T, device=logits.device)[None, :] * Nq + idx[:, None]
    onehot = logits.new_zeros((TQ, K))
    onehot[pos[live], t["labels"][:, None].expand(N, T)[live]] = 1.0
    out = {"loss_ce": focal_loss(logits, onehot[None], num, a["focal_alpha"]) * TQ}
    src = lv["pred_boxes"][0].float().reshape(T, Nq, 4)[:, idx].transpose(0, 1)
    bm = t["exists"][:, None].float().expand(N, T)
    out["loss_bbox"] = ((src - t["boxes"]).abs().sum(-1) * bm).sum() / num
    out["loss_giou"] = ((1 - giou(box_xyxy(src), box_xyxy(t["boxes"]))) * bm).sum() / num
    if masks is not None:
        out["loss_mask"], out["loss_dice"] = mask_losses(masks.float(), t["masks"], num, bm)
    return out


def weight_dict(a: Dict) -> Dict[str, float]:
    base = {"loss_ce": a["class_coef"], "loss_bbox": a["bbx_l1_coef"],
            "loss_giou": a["bbx_giou_coef"]}
    n = a["dec_layers"]
    ladder = {5: 1 / 2, 4: 5 / 30, 3: 4 / 30, 2: 3 / 30, 1: 2 / 30, 0: 1 / 30}
    out = {}
    for i in range(n - 1):
        f = ladder[i] if a["aux_loss_weighting"] else 1.0
        out.update({f"{k}_{i}": v * f for k, v in base.items()})
    top = ladder[n - 1] if a["aux_loss_weighting"] else 1.0
    out.update({k: v * top for k, v in base.items()})
    out["loss_mask"], out["loss_dice"] = a["segm_mask_coef"], a["segm_dice_coef"]
    for i in a["mask_aux_loss"]:
        out[f"loss_mask_{i}"], out[f"loss_dice_{i}"] = a["segm_mask_coef"], a["segm_dice_coef"]
    return out


def to_device(batch: Dict, device) -> Dict:
    t = {k: torch.as_tensor(v, device=device) for k, v in batch["targets"].items()}
    t["labels"] = t["labels"].long()
    return {"images": torch.as_tensor(batch["images"], device=device),
            "pad": torch.as_tensor(batch["pad"], device=device), "targets": t}


def clip_loss(model: M.SegmModel, b: Dict, a: Dict, assign_fn=scipy_assign):
    """The weighted loss of one clip: matched on the final level and on the
    mask-loss levels first (those get masks of their matched
    trajectories), then on the other levels."""
    T = a["num_frames"]
    t = b["targets"]
    levels, head = model(b["images"], b["pad"])
    num = (t["exists"].sum().float() * T).clamp(min=1.0)
    hs = head["hs"]
    Nq = hs.shape[2] // T
    n_lv = len(levels)
    mask_lv = [n_lv - 1] + list(a["mask_aux_loss"])
    idx = {}
    for lv in mask_lv:
        idx[lv] = match_clip(levels[lv], t, T, a, assign_fn)
    masks = {lv: model.masks(hs[lv][0].reshape(T, Nq, -1)[:, idx[lv]], head)
             for lv in mask_lv}
    losses = {}
    for lv in range(n_lv):
        if lv not in idx:
            idx[lv] = match_clip(levels[lv], t, T, a, assign_fn)
        l = clip_level_losses(levels[lv], t, idx[lv], num, T, a, masks.get(lv))
        sfx = "" if lv == n_lv - 1 else f"_{lv}"
        losses.update({k + sfx: v for k, v in l.items()})
    wd = weight_dict(a)
    return sum(losses[k] * w for k, w in wd.items() if k in losses), losses


def batch_loss(model, items: List[Dict], a: Dict, device, assign_fn=scipy_assign):
    """Loss of a collated batch; backward runs inside (clip by clip, each
    clip's share divided by the batch's clips). Returns the loss."""
    total = 0.0
    for it in items:
        loss, _ = clip_loss(model, to_device(it, device), a, assign_fn)
        (loss / len(items)).backward()
        total = total + loss.detach() / len(items)
    return total


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def lr_group(name: str, a: Dict) -> str:
    s = a["solver"]
    if any(k in name for k in list(s["frozen_params"]) + list(s["always_frozen"])):
        return "frozen"
    for group, key in (("temporal_linear_proj", "temporal_linear_proj_names"),
                       ("linear_proj", "linear_proj_names"),
                       ("mask_head", "mask_head_names"), ("backbone", "backbone_names")):
        if any(k in name for k in s[key]):
            return group
    return "base"


def group_lrs(a: Dict) -> Dict[str, float]:
    s = a["solver"]
    return {"base": s["base_lr"], "backbone": s["lr_backbone"],
            "linear_proj": s["base_lr"] * s["lr_linear_proj_mult"],
            "mask_head": s["base_lr"] * s["lr_mask_head_mult"],
            "temporal_linear_proj": s["base_lr"] * s["lr_temporal_linear_proj_mult"]}


class AdamW:
    """torch's AdamW arithmetic over the trained groups, after the gradient
    (every parameter's, the frozen ones' too) is clipped by its global norm."""

    def __init__(self, model, a: Dict):
        self.a = a
        self.params = dict(model.named_parameters())
        lrs = group_lrs(a)
        self.lr = {n: lrs.get(lr_group(n, a)) for n in self.params}
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items() if self.lr[n] is not None}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.m}
        self.t = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        s = self.a["solver"]
        grads = {n: p.grad for n, p in self.params.items() if p.grad is not None}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads.values()]))
        scale = 1.0 if norm < s["grad_clip_max_norm"] else s["grad_clip_max_norm"] / norm
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n in self.m:
            g = grads[n] * scale
            p, lr = self.params[n], self.lr[n]
            p.mul_(1 - lr * s["weight_decay"])
            self.m[n].lerp_(g, 1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(eps)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
        return norm


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to `dtype` and back; an 8-bit type scaled per tensor (the
    scale maps the tensor's largest magnitude to the type's largest)."""
    if torch.finfo(dtype).bits > 8:
        return x.to(dtype).to(x.dtype)
    hi = torch.finfo(dtype).max
    scale = (x.detach().abs().amax().float() / hi).clamp(min=1e-30)
    return (x / scale).clamp(-hi, hi).to(dtype).to(x.dtype) * scale


# the gradients' type where the values' is an 8-bit one: fp8 training's
# e4m3 forward, e5m2 backward
_GRAD_DTYPE = {torch.float8_e4m3fn: torch.float8_e5m2}


class _Round(torch.autograd.Function):
    """A value rounded to a narrower type in the forward pass, and its
    gradient rounded in the backward pass (the low type of the program's
    policy holds both)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = _GRAD_DTYPE.get(dtype, dtype)
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


def quantizer(dtype: torch.dtype):
    """The computation's precision: float32 is the reference itself; a
    narrower type (the control, or bfloat16 as a witness beside the
    program) rounds each value the model passes to `q`, and its gradient,
    as `_Round` does."""
    if dtype == torch.float32:
        return M.identity

    def q(x):
        return _Round.apply(x, dtype) if x.is_floating_point() else x
    return q
