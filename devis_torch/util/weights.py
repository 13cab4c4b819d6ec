"""JAX variables → the port's state_dict.

`from_jax_params` is the inverse of the torch→flax loader of the JAX package
(`devis_tpu/util/checkpoint.py`), with its own copy of the name mapping: the
port's parameters carry the reference torch `state_dict` names, so the same
mapping serves reference checkpoints. One rule set covers the clip model
(`DeVIS`) and the image models (`DeformableDETRSegm`, `DeformableDETR`):
`detr` → `def_detr`, indexed layers and heads, the `MSDeformAttn` and
temporal attention projections by their own names, the mask head's
`regular_conv`, the Swin backbone's reference names (`patch_embed.proj`,
`layers.{i}.blocks.{j}`, `layers.{i}.downsample`, `mlp.fc1`). The layout
changes are transposes, so the same function carries a JAX gradient tree (its
leaves under `params/`) to the port's parameter names. Beside each Swin
attention's bias table it emits the block's `relative_position_index`, a
buffer the JAX package computes and the port keeps, so the result loads
strictly.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from ..models.backbones.swin import relative_position_index

_IDX_SUFFIX = re.compile(r"^(.*)_(\d+)$")
_IDX_MODULES = ("class_embed", "bbox_embed", "ref_point_embed", "layers",
                "layer1", "layer2", "layer3", "layer4", "downsample")
_QKV = ("q_proj", "k_proj", "v_proj")


def _map_component(p: str) -> str:
    if p == "detr":
        return "def_detr"
    if p == "backbone":
        return "backbone.0.body"
    if p == "position_encoding":
        return "backbone.1"
    if p.startswith("patch_embed_"):
        return "patch_embed." + p[len("patch_embed_"):]
    m = re.match(r"layers_(\d+)_(blocks_(\d+)|downsample)$", p)
    if m:
        return f"layers.{m.group(1)}." + (f"blocks.{m.group(3)}" if m.group(3) else "downsample")
    if p.startswith("mlp_fc"):
        return f"mlp.{p.split('_', 1)[1]}"
    for prefix, torch_name in (("encoder_layers_", "encoder.layers"),
                               ("decoder_layers_", "decoder.layers"),
                               ("input_proj_", "input_proj")):
        if p.startswith(prefix):
            return f"{torch_name}.{p.rsplit('_', 1)[1]}"
    m = _IDX_SUFFIX.match(p)
    if m and m.group(1) in _IDX_MODULES:
        return f"{m.group(1)}.{m.group(2)}"
    return p


def torch_key(module_parts: List[str], leaf: str, collection: str) -> str:
    """The torch state_dict key of one flax leaf."""
    parts = list(module_parts)
    member = None
    if parts and any(p.startswith("input_proj_") for p in parts) \
            and parts[-1] in ("conv", "norm"):
        parts, member = parts[:-1], "0" if parts[-1] == "conv" else "1"
    base = ".".join(_map_component(p) for p in parts)
    if member is not None:
        base = f"{base}.{member}"
    join = lambda *n: ".".join(x for x in n if x)  # noqa: E731
    if collection == "frozen":
        return join(base, leaf)
    if leaf == "query_embed":
        return join(base, "query_embed.weight")
    if leaf in ("level_embed", "temporal_embed"):
        return join(base, leaf)
    name = "weight" if leaf in ("kernel", "scale", "weight") else leaf
    if leaf in ("weight", "bias") and parts and re.match(r"(lay\d+|out_lay)$", parts[-1]):
        return join(base, f"regular_conv.{name}")
    return join(base, name)


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" or (leaf == "weight" and arr.ndim == 4):
        if arr.ndim == 2:
            return arr.T                                  # (in, out) → (out, in)
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)              # HWIO → OIHW
    return arr


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"collection/module/.../leaf": array}`` → the port's state_dict (f32).
    Decoder self-attention q/k/v pack into `in_proj_weight`/`in_proj_bias`
    in that order. Raises if two leaves map to one key."""
    out: Dict[str, np.ndarray] = {}
    packs: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in flat.items():
        collection, *parts = path.split("/")
        leaf, module_parts = parts[-1], parts[:-1]
        arr = np.asarray(arr, np.float32)
        if (len(module_parts) >= 2 and module_parts[-1] in _QKV
                and module_parts[-2] == "self_attn"
                and any(p.startswith("decoder_layers_") for p in module_parts)):
            base = ".".join(_map_component(p) for p in module_parts[:-1])
            key = f"{base}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
            slot = packs.setdefault(key, {})
            if module_parts[-1] in slot:
                raise ValueError(f"{path}: mapped twice")
            slot[module_parts[-1]] = arr.T if leaf == "kernel" else arr
            continue
        key = torch_key(module_parts, leaf, collection)
        if key in out:
            raise ValueError(f"{path}: maps to {key}, which is already set")
        out[key] = _to_torch_layout(arr, leaf)
    for key, slot in packs.items():
        if set(slot) != set(_QKV):
            raise ValueError(f"{key}: needs q, k and v, got {sorted(slot)}")
        out[key] = np.concatenate([slot[p] for p in _QKV], axis=0)
    for key in [k for k in out if k.endswith(".relative_position_bias_table")]:
        window = (int(round(out[key].shape[0] ** 0.5)) + 1) // 2
        out[key.replace("bias_table", "index")] = \
            relative_position_index(window).astype(np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
