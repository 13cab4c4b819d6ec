"""Model factory (port of `devis_tpu/models/__init__.py`).

`build_model(num_classes, cfg)` returns, with its parameters made from a seed,
on the GPU unless ``device`` says otherwise, in eval mode (`model.train()`
turns the dropout on):

  * DATASETS.TYPE == 'vis'                  → DeVIS (the clip model)
  * DATASETS.TYPE == 'coco', MASK_ON=True   → DeformableDETRSegm
  * DATASETS.TYPE == 'coco', MASK_ON=False  → DeformableDETR

With focal loss the model emits `num_classes - 1` logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..util.misc import resolve_device
from .attention import MSDeformAttn, TemporalMSDeformAttnBase
from .backbones.resnet import NUM_CHANNELS, FrozenBatchNorm2d, ResNet
from .detr import DeformableDETR, bbox_bias_init, class_bias_init
from .devis_model import DeVIS
from .layers import GroupNorm
from .position_encoding import (PositionEmbeddingSine,
                                PositionEmbeddingSineWithLearnableTemporal)
from .segmentation import DeformableDETRSegm


def matcher_cfg_from(cfg, clip: bool = True) -> dict:
    """Keyword arguments of the clip matcher or of the image matcher."""
    m = dict(cost_class=cfg.MODEL.MATCHER.CLASS_COST,
             cost_bbox=cfg.MODEL.MATCHER.BBX_L1_COST,
             cost_giou=cfg.MODEL.MATCHER.BBX_GIOU_COST,
             focal_alpha=cfg.MODEL.LOSS.FOCAL_ALPHA)
    if clip:
        m["use_l1_distance_sum"] = cfg.MODEL.MATCHER.USE_SUM_L1_DISTANCE
    else:
        m["focal_loss"] = cfg.MODEL.LOSS.FOCAL_LOSS
    return m


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Reset every parameter from `generator`, with the reference's special
    initialisations: zero offset/logit weights with directional offset
    biases, the focal class prior, zero-initialised last box layers,
    normal(1) embeddings, identity norms and frozen batch norms."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("level_embed", "temporal_embed") or name.endswith("query_embed.weight"):
            p.normal_(0.0, 1.0, generator=generator)
        elif p.dim() >= 2:
            fan_in = p[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            p.uniform_(-bound, bound, generator=generator)
        else:
            p.zero_()
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.LayerNorm, GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, (TemporalMSDeformAttnBase, MSDeformAttn)):
            mod.reset_offsets()
        elif isinstance(mod, DeformableDETR):
            for ce in mod.class_embed:
                ce.bias.copy_(torch.from_numpy(class_bias_init(ce.bias.numel())))
            for i, be in enumerate(mod.bbox_embed):
                be.layers[-1].weight.zero_()
                if i == 0:
                    be.layers[-1].bias.copy_(torch.from_numpy(bbox_bias_init()))
        elif name.endswith(("offset_conv", "modulator_conv")):
            mod.weight.zero_()
            mod.bias.zero_()


def build_model(num_classes: int, cfg, device=None, seed: int = 0) -> nn.Module:
    """The model of `cfg` (module docstring), parameters from `seed`, on
    `device` (the GPU unless the caller passes another; without a GPU the
    caller must pass ``device="cpu"``)."""
    device = resolve_device(device)
    if cfg.DATASETS.TYPE not in ("vis", "coco"):
        raise NotImplementedError(f"DATASETS.TYPE {cfg.DATASETS.TYPE!r}: the "
                                  "panoptic model is ROADMAP.md queue A item 5 "
                                  "of the port")
    is_vis = cfg.DATASETS.TYPE == "vis"
    if "swin" in cfg.MODEL.BACKBONE:
        raise NotImplementedError("the Swin backbone is ROADMAP.md queue A item 5 "
                                  "of the port")
    da = cfg.MODEL.DEVIS.DEFORMABLE_ATTENTION
    if not cfg.MODEL.WITH_BBX_REFINE or cfg.MODEL.WITH_REF_POINT_REFINE \
            or not cfg.MODEL.MASK_HEAD.USE_MDC:
        raise NotImplementedError("the port runs box refinement with per-layer "
                                  "heads and the MDC mask head; shared heads, "
                                  "reference-point refinement and the plain-"
                                  "conv mask head are ROADMAP items")
    if is_vis and (da.DISABLE_TEMPORAL_CONNECTIONS
                   or cfg.MODEL.MASK_HEAD.DEVIS.CONV_HEAD_3D
                   or cfg.MODEL.DEVIS.TEMPORAL_EMBEDDING != "learned"):
        raise NotImplementedError("the port runs DeVIS with temporal "
                                  "connections, learned temporal embedding "
                                  "and no 3-d conv head; other variants are "
                                  "ROADMAP items")
    if cfg.TPU.TRANSFORMER_GRADIENT_CHECKPOINT:
        raise NotImplementedError("per-layer recomputation (remat_layers) is "
                                  "a ROADMAP item of the port")
    dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    eff_num_classes = num_classes - 1 if cfg.MODEL.LOSS.FOCAL_LOSS else num_classes
    T = cfg.MODEL.DEVIS.NUM_FRAMES
    transformer_kwargs = dict(
        n_heads=cfg.MODEL.TRANSFORMER.N_HEADS,
        num_encoder_layers=cfg.MODEL.TRANSFORMER.ENCODER_LAYERS,
        num_decoder_layers=cfg.MODEL.TRANSFORMER.DECODER_LAYERS,
        dim_feedforward=cfg.MODEL.DIM_FEEDFORWARD,
        dropout=cfg.MODEL.DROPOUT,
        enc_n_points=cfg.MODEL.TRANSFORMER.ENC_N_POINTS,
        dec_n_points=cfg.MODEL.TRANSFORMER.DEC_N_POINTS,
        variant="devis" if is_vis else "image")
    if is_vis:
        transformer_kwargs.update(
            num_frames=T,
            enc_connect_all=da.ENC_CONNECT_ALL_FRAMES,
            enc_temporal_window=da.ENC_TEMPORAL_WINDOW,
            enc_n_temporal_points=da.ENC_N_POINTS_TEMPORAL_FRAME,
            dec_n_temporal_points=da.DEC_N_POINTS_TEMPORAL_FRAME,
            instance_aware=da.INSTANCE_AWARE_ATTENTION)
        position_encoding = PositionEmbeddingSineWithLearnableTemporal(
            cfg.MODEL.HIDDEN_DIM, T)
    else:
        position_encoding = PositionEmbeddingSine(cfg.MODEL.HIDDEN_DIM // 2)
    detr = DeformableDETR(
        ResNet(cfg.MODEL.BACKBONE, cfg.MODEL.BACKBONE_DILATION, dtype=dtype),
        position_encoding,
        num_classes=eff_num_classes, num_queries=cfg.MODEL.NUM_QUERIES,
        num_feature_levels=cfg.MODEL.NUM_FEATURE_LEVELS,
        hidden_dim=cfg.MODEL.HIDDEN_DIM, aux_loss=cfg.MODEL.LOSS.AUX_LOSS,
        with_gradient=cfg.MODEL.BBX_GRADIENT_PROP,
        backbone_num_channels=NUM_CHANNELS,
        transformer_kwargs=transformer_kwargs, dtype=dtype)
    head = dict(mask_head_used_features=cfg.MODEL.MASK_HEAD.USED_FEATURES,
                att_maps_used_res=cfg.MODEL.MASK_HEAD.UPSAMPLING_RESOLUTIONS,
                mask_aux_loss=cfg.MODEL.LOSS.MASK_AUX_LOSS,
                matcher_cfg=matcher_cfg_from(cfg, clip=is_vis),
                num_out=cfg.TEST.NUM_OUT, dtype=dtype)
    if is_vis:
        model = DeVIS(detr, num_frames=T, **head)
    elif cfg.MODEL.MASK_ON:
        model = DeformableDETRSegm(detr, focal_loss=cfg.MODEL.LOSS.FOCAL_LOSS, **head)
    else:
        model = detr
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
