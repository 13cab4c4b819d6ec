"""Checkpoints of the port (port of `devis_tpu/util/checkpoint.py`).

  * The weight surgery of the reference (`src/util/weights_loading_utils.py`):
    `shift_class_neurons` (L10-24), `prefix_def_detr` (`adapt_weights_mask_head`,
    L27-49) and `adapt_weights_devis` (L52-183): temporal parameters cloned
    from the spatial ones, the COCO-to-YouTube-VIS class-logit transplant,
    query-embedding subsampling. They run on flat {name: numpy} dicts in the
    reference's `state_dict` naming, which is the port's own
    (`model_keys(model)`), so no name mapping stands between a reference
    `.pth` and the model.
  * `load_state_into`: a surgery's result into a model, shapes checked.
  * Native training checkpoints (`save_checkpoint`, `restore_checkpoint`): one
    directory holding `state.pt` (`torch.save` of the model's state_dict, the
    AdamW state, the schedule's step and the RNG states the caller names),
    in the JAX CLI's layout (`checkpoint/`, `checkpoint_epoch_{e}/`,
    `checkpoint_best_{key}/`, with `meta.json` written by `main`).
"""
from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

STATE_FILE = "state.pt"

IDS_COCO_TO_YVIS = np.array(
    [1, -1, -1, -1, 41, -1, 3, 18, -1, -1, -1, -1, -1, 17, 21, -1, 7, 19, -1,
     23, -1, 4, -1, -1, -1, -1, 42, 5, 8, 24, -1, 22, 36, 9, -1, 74, -1, -1,
     -1, -1, -1])


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference `.pth` file (its "model" entry, or the file itself) as a
    flat {name: numpy} dict. Only tensors, plain containers and the
    reference's `argparse.Namespace` of arguments are unpickled."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in state.items() if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------
# Weight adaptation on the flat torch-style dict
# ---------------------------------------------------------------------------

def shift_class_neurons(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rotate class logits so label 0 sits at neuron 0 (reference L10-24)."""
    out = {}
    for k, v in state.items():
        if "class_embed" in k:
            r = v.copy()
            r[:-1] = v[1:]
            r[-1] = v[0]
            out[k] = r
        else:
            out[k] = v
    return out


def prefix_def_detr(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Prefix a plain-DETR checkpoint for the segmentation wrapper
    (reference adapt_weights_mask_head, L27-49)."""
    out = {}
    for k, v in state.items():
        if (not k.startswith("def_detr") and "bbox_attention" not in k
                and "mask_head" not in k):
            out[f"def_detr.{k}"] = v
        else:
            out[k] = v
    return out


def adapt_weights_devis(state: Dict[str, np.ndarray],
                        model_keys: Dict[str, Tuple[int, ...]],
                        lvl_res: int, focal_loss: bool,
                        finetune_class_logits: bool, num_frames: int,
                        finetune_query_embds: bool,
                        finetune_temporal_modules: bool,
                        enc_connect_all_frames: bool,
                        enc_temporal_window: int,
                        enc_n_temporal_points: int,
                        dec_n_temporal_points: int) -> Dict[str, np.ndarray]:
    """COCO/image checkpoint → DeVIS surgery (reference L52-183).

    model_keys: {state_dict key: shape} of the target DeVIS model
    (`model_keys(model)`). Returns a dict covering the keys it could fill
    (missing ones stay at init)."""
    ckpt: Dict[str, np.ndarray] = {}
    for k, v in state.items():
        if "def_detr" not in k and any(s in k for s in (
                "transformer", "class_embed", "bbox_embed", "input_proj",
                "query_embed", "backbone")):
            ckpt[f"def_detr.{k}"] = v
            if lvl_res == 1 and "input_proj.2" in k:
                name = "def_detr." + k.split(".")[0] + ".0." + ".".join(k.split(".")[2:])
                ckpt[name] = v.copy()
        else:
            ckpt[k] = v
        # Clone spatial attention params into the temporal ones (L75-86).
        if finetune_temporal_modules and (
                ("transformer.encoder" in k and "self_attn" in k)
                or ("transformer.decoder" in k and "cross_attn" in k)) \
                and "value_proj" not in k and "output_proj" not in k:
            parts = k.split(".")
            idx = 6 if "def_detr" in k else 5
            name = ".".join(parts[:idx]) + ".temporal_" + ".".join(parts[idx:])
            if "def_detr" not in k:
                name = "def_detr." + name
            ckpt[name] = v.copy()

    out: Dict[str, np.ndarray] = {}
    for k, shape in model_keys.items():
        if (k not in ckpt
                or ("query_embed" in k and not finetune_query_embds)
                or ("class_embed" in k and not finetune_class_logits)):
            continue                                      # stays at init
        v = ckpt[k]
        if "query_embed" in k and finetune_query_embds:
            n_traj = shape[0] // num_frames
            if n_traj < v.shape[0]:
                assert v.shape[0] % n_traj == 0
                step = v.shape[0] // n_traj
                picked = v[::step][:shape[0]]
                out[k] = np.tile(picked, (num_frames, 1))
            elif n_traj == v.shape[0]:
                out[k] = v
            else:
                raise NotImplementedError
        elif tuple(v.shape) != tuple(shape):
            if "level_embed" in k:
                out[k] = v[:shape[0]]
            elif "temporal" in k and finetune_temporal_modules:
                if "transformer.encoder" in k:
                    W = num_frames - 1 if enc_connect_all_frames else enc_temporal_window
                    Pt = enc_n_temporal_points
                else:
                    W = num_frames - 1
                    Pt = dec_n_temporal_points
                if "sampling_offsets" in k:
                    if "bias" not in k:
                        t = np.tile(v.reshape(8, 1, 4, 4, 2, 256), (1, W, 1, 1, 1, 1))
                        out[k] = t[:, :, :lvl_res, :Pt].reshape(-1, 256)
                    else:
                        t = np.tile(v.reshape(8, 1, 4, 4, 2), (1, W, 1, 1, 1))
                        out[k] = t[:, :, :lvl_res, :Pt].reshape(-1)
                else:
                    if "bias" not in k:
                        t = np.tile(v.reshape(8, 1, 4, 4, 256), (1, W, 1, 1, 1))
                        out[k] = t[:, :, :lvl_res, :Pt].reshape(-1, 256)
                    else:
                        t = np.tile(v.reshape(8, 1, 4, 4), (1, W, 1, 1))
                        out[k] = t[:, :, :lvl_res, :Pt].reshape(-1)
            elif re.search(r"(self_attn|cross_attn)\.attention_weights", k):
                if "bias" not in k:
                    out[k] = v.reshape(8, 4, 4, 256)[:, :lvl_res].reshape(-1, 256)
                else:
                    out[k] = v.reshape(8, 4, 4)[:, :lvl_res].reshape(-1)
            elif re.search(r"(self_attn|cross_attn)\.sampling_offsets", k):
                if "bias" not in k:
                    out[k] = v.reshape(8, 4, 4, 2, 256)[:, :lvl_res].reshape(-1, 256)
                else:
                    out[k] = v.reshape(8, 4, 4, 2)[:, :lvl_res].reshape(-1)
            elif "class_embed" in k:
                ids = IDS_COCO_TO_YVIS[:-1] if focal_loss else IDS_COCO_TO_YVIS
                gather = ids != -1
                logits = ids[gather] - 1
                tmp = np.zeros(shape, v.dtype)
                tmp[gather] = v[logits]
                out[k] = tmp
            else:
                raise NotImplementedError(
                    f"shape mismatch for {k}: model {shape} vs ckpt {v.shape}")
        else:
            out[k] = v
    return out


def model_keys(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{state_dict key: shape} of the model (what `adapt_weights_devis`
    fills)."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def load_state_into(model: nn.Module, state: Dict[str, np.ndarray],
                    verbose: bool = False) -> Tuple[List[str], List[str]]:
    """Copies every entry of `state` that names a tensor of the model into
    it; a shape that differs raises. Returns (missing: the model's keys left
    as they were, unused: the state's keys the model lacks)."""
    own = model.state_dict()
    missing = [k for k in own if k not in state]
    unused = [k for k in state if k not in own]
    with torch.no_grad():
        for k, v in state.items():
            if k not in own:
                continue
            if tuple(own[k].shape) != tuple(np.shape(v)):
                raise ValueError(f"shape mismatch for {k}: model {tuple(own[k].shape)} vs "
                                 f"checkpoint {tuple(np.shape(v))}")
            own[k].copy_(torch.as_tensor(np.asarray(v)).to(own[k].dtype))
    if verbose:
        for k in missing:
            print(f"Load {k} from scratch.")
        for k in unused:
            print(f"Ignoring {k} from checkpoint")
    return missing, unused


def save_checkpoint(path: str, state, rng_states: Optional[Dict] = None) -> None:
    """Writes a train state (`engine.TrainState`: model, AdamW, step) and
    `rng_states` (e.g. a torch.Generator's `get_state()`, a random.Random's
    `getstate()`) into directory `path`, replacing what was there."""
    os.makedirs(path, exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": int(state.step), "rng": rng_states or {}}
    tmp = os.path.join(path, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def load_checkpoint(path: str) -> Dict:
    """The payload `save_checkpoint` wrote into directory `path`, on the
    CPU (tensors and plain containers only)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state) -> Dict:
    """Restores the train state saved in `path` into `state` in place (the
    model's tensors, the AdamW moments and counts, the step); returns the
    saved RNG states for the caller to set."""
    ckpt = load_checkpoint(path)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return ckpt["rng"]
