"""JAX variables → the port's state_dict.

`from_jax_params` is the inverse of the torch→flax loader of the JAX package
(`devis_tpu/util/checkpoint.py`), with its own copy of the name mapping: the
port's parameters carry the reference torch `state_dict` names, so the same
mapping serves reference checkpoints. One rule set covers the clip model
(`DeVIS`) and the image models (`DeformableDETRSegm`, `DeformableDETR`):
`detr` → `def_detr`, indexed layers and heads, the `MSDeformAttn` and
temporal attention projections by their own names, the mask head's
`regular_conv` (DCNv2) or, for the plain-conv head, the `Conv2d` itself
(the JAX `PlainConv` wrapper's `conv` is dropped), the 3-d conv head
(`conv_head_3d.conv{i}`, `gn{i}`, `out`), the Swin backbone's reference
names (`patch_embed.proj`, `layers.{i}.blocks.{j}`, `layers.{i}.downsample`,
`mlp.fc1`). The layout changes are transposes, so the same function carries
a JAX gradient tree (its leaves under `params/`) to the port's parameter
names. Beside each Swin attention's bias table it emits the block's
`relative_position_index`, a buffer the JAX package computes and the port
keeps; where the JAX model shares one class and one box head over the
decoder layers (`class_embed_0` only, no box refinement) it repeats them
under every layer's index, as the reference `state_dict` names them. So the
result loads strictly.
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
    plain_conv = len(parts) >= 2 and parts[-1] == "conv" \
        and re.match(r"(lay\d+|out_lay)$", parts[-2]) is not None
    if plain_conv:
        parts = parts[:-1]
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
    if not plain_conv and leaf in ("weight", "bias") and parts \
            and re.match(r"(lay\d+|out_lay)$", parts[-1]):
        return join(base, f"regular_conv.{name}")
    return join(base, name)


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" or (leaf == "weight" and arr.ndim == 4):
        if arr.ndim == 2:
            return arr.T                                  # (in, out) → (out, in)
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)              # HWIO → OIHW
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)           # DHWIO → OIDHW
    return arr


def _share_heads(flat: Dict[str, np.ndarray], out: Dict[str, np.ndarray]) -> None:
    """Shared heads (a JAX tree with `class_embed_0` and no `class_embed_1`)
    under the index of every decoder layer: `class_embed.{i}` and
    `bbox_embed.{i}` for each of the tree's `decoder_layers_{i}`."""
    n_dec = len({m.group(1) for p in flat for m in [re.search(r"decoder_layers_(\d+)/", p)]
                 if m})
    if not any("class_embed_0/" in p for p in flat) \
            or any("class_embed_1/" in p for p in flat):
        return
    for key in [k for k in out if re.search(r"(class|bbox)_embed\.0\.", k)]:
        for i in range(1, n_dec):
            out[re.sub(r"_embed\.0\.", f"_embed.{i}.", key, count=1)] = out[key]


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
    _share_heads(flat, out)
    for key in [k for k in out if k.endswith(".relative_position_bias_table")]:
        window = (int(round(out[key].shape[0] ** 0.5)) + 1) // 2
        out[key.replace("bias_table", "index")] = \
            relative_position_index(window).astype(np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
