"""Model factory (port of `devis_tpu/models/__init__.py`).

`build_model(num_classes, cfg)` returns the DeVIS clip model for
``DATASETS.TYPE == 'vis'`` with its parameters made from a seed, on the GPU
unless ``device`` says otherwise, in eval mode (`model.train()` turns the
dropout on). With focal loss the model emits `num_classes` logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..util.misc import resolve_device
from .attention import TemporalMSDeformAttnBase
from .backbones.resnet import NUM_CHANNELS, FrozenBatchNorm2d, ResNet
from .detr import DeformableDETR, bbox_bias_init, class_bias_init
from .devis_model import DeVIS
from .layers import GroupNorm
from .position_encoding import PositionEmbeddingSineWithLearnableTemporal


def matcher_cfg_from(cfg) -> dict:
    """Keyword arguments of the clip matcher."""
    return dict(cost_class=cfg.MODEL.MATCHER.CLASS_COST,
                cost_bbox=cfg.MODEL.MATCHER.BBX_L1_COST,
                cost_giou=cfg.MODEL.MATCHER.BBX_GIOU_COST,
                focal_alpha=cfg.MODEL.LOSS.FOCAL_ALPHA,
                use_l1_distance_sum=cfg.MODEL.MATCHER.USE_SUM_L1_DISTANCE)


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
        elif isinstance(mod, TemporalMSDeformAttnBase):
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


def build_model(num_classes: int, cfg, device=None, seed: int = 0) -> DeVIS:
    """The DeVIS model of `cfg`, parameters from `seed`, on `device` (the GPU
    unless the caller passes another; without a GPU the caller must pass
    ``device="cpu"``)."""
    device = resolve_device(device)
    if cfg.DATASETS.TYPE != "vis":
        raise NotImplementedError("the COCO image model is ROADMAP queue A "
                                  "item 12 of the port")
    if "swin" in cfg.MODEL.BACKBONE:
        raise NotImplementedError("the Swin backbone is ROADMAP queue A item 14 "
                                  "of the port")
    da = cfg.MODEL.DEVIS.DEFORMABLE_ATTENTION
    if da.DISABLE_TEMPORAL_CONNECTIONS or cfg.MODEL.MASK_HEAD.DEVIS.CONV_HEAD_3D \
            or not cfg.MODEL.MASK_HEAD.USE_MDC or not cfg.MODEL.WITH_BBX_REFINE \
            or cfg.MODEL.WITH_REF_POINT_REFINE \
            or cfg.MODEL.DEVIS.TEMPORAL_EMBEDDING != "learned":
        raise NotImplementedError("the port runs DeVIS with temporal "
                                  "connections, box refinement, learned "
                                  "temporal embedding and the MDC mask "
                                  "head; other variants are ROADMAP items")
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
        num_frames=T,
        enc_connect_all=da.ENC_CONNECT_ALL_FRAMES,
        enc_temporal_window=da.ENC_TEMPORAL_WINDOW,
        enc_n_temporal_points=da.ENC_N_POINTS_TEMPORAL_FRAME,
        dec_n_temporal_points=da.DEC_N_POINTS_TEMPORAL_FRAME,
        instance_aware=da.INSTANCE_AWARE_ATTENTION)
    detr = DeformableDETR(
        ResNet(cfg.MODEL.BACKBONE, cfg.MODEL.BACKBONE_DILATION, dtype=dtype),
        PositionEmbeddingSineWithLearnableTemporal(cfg.MODEL.HIDDEN_DIM, T),
        num_classes=eff_num_classes, num_queries=cfg.MODEL.NUM_QUERIES,
        num_feature_levels=cfg.MODEL.NUM_FEATURE_LEVELS,
        hidden_dim=cfg.MODEL.HIDDEN_DIM, aux_loss=cfg.MODEL.LOSS.AUX_LOSS,
        with_gradient=cfg.MODEL.BBX_GRADIENT_PROP,
        backbone_num_channels=NUM_CHANNELS,
        transformer_kwargs=transformer_kwargs, dtype=dtype)
    model = DeVIS(detr, num_frames=T,
                  mask_head_used_features=cfg.MODEL.MASK_HEAD.USED_FEATURES,
                  att_maps_used_res=cfg.MODEL.MASK_HEAD.UPSAMPLING_RESOLUTIONS,
                  mask_aux_loss=cfg.MODEL.LOSS.MASK_AUX_LOSS,
                  matcher_cfg=matcher_cfg_from(cfg),
                  num_out=cfg.TEST.NUM_OUT, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
