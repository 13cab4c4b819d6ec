"""Seeded weights, made on the device in a few large calls.

A configuration file's `init` lists rules `[regex, kind, arg]`; the first
rule whose regex matches (`re.search`) a tensor's name sets it:

  * `const`   every element `arg`;
  * `normal`  N(0, 1) times `arg`;
  * `fan_in`  N(0, 1) times `arg` / sqrt(fan_in), fan_in = numel / shape[0];
  * `values`  the given list, repeated to fill the tensor;
  * `grid`    DeVIS's directional offset bias: head m points at angle
              2 pi m / M, L-infinity normalised, point p scaled by p + 1;
              `arg` = [M, P], the layout (M, ..., P, 2).

One normal draw of every random element at once from a generator seeded by
`seed` on `device`, laid out over the tensors in the order of their names,
then per-tensor scales and constants with foreach calls: the same seed gives
the same tensors in every model with the same names and shapes.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Sequence, Tuple

import torch


def _rule(name: str, rules: Sequence) -> Tuple[str, object]:
    for pattern, kind, arg in rules:
        if re.search(pattern, name):
            return kind, arg
    raise KeyError(f"no init rule matches {name!r}")


def _grid(numel: int, M: int, P: int) -> torch.Tensor:
    th = torch.arange(M, dtype=torch.float64) * (2 * math.pi / M)
    g = torch.stack([th.cos(), th.sin()], -1)
    g = g / g.abs().amax(-1, keepdim=True)                     # (M, 2)
    rest = numel // (M * P * 2)
    scale = torch.arange(1, P + 1, dtype=torch.float64)
    out = g[:, None, :, None] * scale[None, None, None, :]   # (M, 1, 2, P)
    out = out.permute(0, 1, 3, 2).expand(M, rest, P, 2)
    return out.reshape(-1).float()


def plan(named: Iterable[Tuple[str, torch.Tensor]], rules: Sequence) -> List[Dict]:
    """Each tensor's rule, in order."""
    return [dict(name=n, tensor=t, kind=_rule(n, rules)[0], arg=_rule(n, rules)[1])
            for n, t in named]


@torch.no_grad()
def fill(named: Iterable[Tuple[str, torch.Tensor]], rules: Sequence, seed: int) -> None:
    """Sets every tensor of `named` (name, tensor) in place from `seed`."""
    items = sorted(plan(named, rules), key=lambda it: it["name"])
    if not items:
        return
    device = items[0]["tensor"].device
    rand = [it for it in items if it["kind"] in ("normal", "fan_in")]
    total = sum(it["tensor"].numel() for it in rand)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, scales, start = [], [], 0
    for it in rand:
        t = it["tensor"]
        views.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
        fan_in = t.numel() // t.shape[0]
        scales.append(float(it["arg"]) / (math.sqrt(fan_in) if it["kind"] == "fan_in" else 1.0))
    torch._foreach_mul_(views, scales)
    if rand:
        torch._foreach_copy_([it["tensor"] for it in rand], views)
    consts = [it for it in items if it["kind"] == "const"]
    for value in {float(it["arg"]) for it in consts}:
        ts = [it["tensor"] for it in consts if float(it["arg"]) == value]
        torch._foreach_zero_(ts)
        if value:
            torch._foreach_add_(ts, value)
    for it in items:
        t = it["tensor"]
        if it["kind"] == "values":
            v = torch.tensor(it["arg"], dtype=t.dtype)
            t.copy_(v.repeat(t.numel() // v.numel()).view(t.shape).to(device))
        elif it["kind"] == "grid":
            t.copy_(_grid(t.numel(), *it["arg"]).view(t.shape).to(device))


def named_tensors(model: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """Parameters and buffers by name, each once (a module shared under two
    names keeps the first)."""
    seen, out = set(), []
    for n, t in list(model.named_parameters()) + list(model.named_buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            out.append((n, t))
    return out
