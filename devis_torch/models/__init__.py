"""Model factory (port of `devis_tpu/models/__init__.py`).

`build_model(num_classes, cfg)` returns, with its parameters made from a seed,
on the GPU unless ``device`` says otherwise, in eval mode (`model.train()`
turns the dropout on):

  * DATASETS.TYPE == 'vis'                  → DeVIS (the clip model)
  * DATASETS.TYPE == 'coco', MASK_ON=True   → DeformableDETRSegm
  * DATASETS.TYPE == 'coco', MASK_ON=False  → DeformableDETR

Every variant of the config tree builds but the panoptic model: box
refinement with per-layer heads or shared heads (WITH_BBX_REFINE),
reference-point refinement (WITH_REF_POINT_REFINE), the DCNv2 or the
plain-conv mask head (MASK_HEAD.USE_MDC), and for DeVIS the transformer with
or without temporal connections (DISABLE_TEMPORAL_CONNECTIONS), the 3-d conv
head (MASK_HEAD.DEVIS.CONV_HEAD_3D) and the learned or sine temporal
encoding (DEVIS.TEMPORAL_EMBEDDING). The backbone is the ResNet of
MODEL.BACKBONE or, for a `swin_*` name, the Swin Transformer of
`SWIN_CONFIGS`. TPU.SWIN_GRADIENT_CHECKPOINT and
TPU.TRANSFORMER_GRADIENT_CHECKPOINT recompute each Swin block and each
encoder and decoder layer in the backward pass. With focal loss the model
emits `num_classes` logits (the reference passes `num_classes - 1` and adds
one).
"""
from __future__ import annotations

import math
import re

import torch
import torch.nn as nn

from ..util.misc import resolve_device
from .attention import MSDeformAttn, TemporalMSDeformAttnBase
from .backbones.resnet import NUM_CHANNELS, FrozenBatchNorm2d, ResNet
from .backbones.swin import SWIN_CONFIGS, SwinTransformer
from .detr import DeformableDETR, bbox_bias_init, class_bias_init
from .devis_model import DeVIS
from .layers import Conv2d, GroupNorm
from .position_encoding import (PositionEmbeddingSine,
                                PositionEmbeddingSineWithLearnableTemporal,
                                PositionEmbeddingSpatialTemporalSine)
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


_PLAIN_CONV = re.compile(r"mask_head\.(lay\d+|out_lay)$")


def build_backbone(cfg, dtype=torch.float32):
    """(trunk, its four stages' channel counts) of MODEL.BACKBONE; an
    unregistered Swin name raises KeyError."""
    name = cfg.MODEL.BACKBONE
    if "swin" in name:
        return (SwinTransformer(**SWIN_CONFIGS[name],
                                use_checkpoint=cfg.TPU.SWIN_GRADIENT_CHECKPOINT,
                                dtype=dtype),
                SWIN_CONFIGS[name]["num_channels"])
    return ResNet(name, cfg.MODEL.BACKBONE_DILATION, dtype=dtype), NUM_CHANNELS


def build_position_encoding(cfg) -> nn.Module:
    """The positional encoding of `cfg`: for DeVIS the learned temporal one
    or VisTR's sine over (t, y, x), which asserts HIDDEN_DIM 252 as the JAX
    package does; for images the 2-d sine."""
    if cfg.DATASETS.TYPE == "vis":
        kind = cfg.MODEL.DEVIS.TEMPORAL_EMBEDDING
        if kind == "learned":
            return PositionEmbeddingSineWithLearnableTemporal(
                cfg.MODEL.HIDDEN_DIM, cfg.MODEL.DEVIS.NUM_FRAMES)
        if kind == "sine":
            assert cfg.MODEL.HIDDEN_DIM == 252
            return PositionEmbeddingSpatialTemporalSine(84, cfg.MODEL.DEVIS.NUM_FRAMES)
        raise NotImplementedError(f"temporal embedding {kind}")
    return PositionEmbeddingSine(cfg.MODEL.HIDDEN_DIM // 2)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Reset every parameter from `generator`, with the reference's special
    initialisations: zero offset/logit weights with directional offset
    biases, the focal class prior, zero-initialised last box and
    reference-point layers, kaiming-uniform plain mask-head convs, normal(1)
    embeddings, identity norms and frozen batch norms."""
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
            for rp in mod.ref_point_embed or ():
                rp.layers[-1].weight.zero_()
        elif name.endswith(("offset_conv", "modulator_conv")):
            mod.weight.zero_()
            mod.bias.zero_()
        elif isinstance(mod, Conv2d) and _PLAIN_CONV.search(name):
            # the reference's kaiming-uniform 3x3 convs of the plain mask head
            bound = math.sqrt(6.0 / mod.weight[0].numel())
            mod.weight.uniform_(-bound, bound, generator=generator)


def build_model(num_classes: int, cfg, device=None, seed: int = 0) -> nn.Module:
    """The model of `cfg` (module docstring), parameters from `seed`, on
    `device` (the GPU unless the caller passes another; without a GPU the
    caller must pass ``device="cpu"``)."""
    device = resolve_device(device)
    if cfg.DATASETS.TYPE not in ("vis", "coco", "coco_panoptic"):
        raise ValueError(f"DATASETS.TYPE {cfg.DATASETS.TYPE!r}")
    if cfg.MODEL.WITH_REF_POINT_REFINE and cfg.MODEL.WITH_BBX_REFINE:
        raise ValueError("WITH_REF_POINT_REFINE requires WITH_BBX_REFINE=False")
    is_vis = cfg.DATASETS.TYPE == "vis"
    da = cfg.MODEL.DEVIS.DEFORMABLE_ATTENTION
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
        remat_layers=cfg.TPU.TRANSFORMER_GRADIENT_CHECKPOINT,
        variant=("devis_ablation" if da.DISABLE_TEMPORAL_CONNECTIONS else "devis")
        if is_vis else "image")
    if is_vis:
        transformer_kwargs.update(
            num_frames=T,
            enc_connect_all=da.ENC_CONNECT_ALL_FRAMES,
            enc_temporal_window=da.ENC_TEMPORAL_WINDOW,
            enc_n_temporal_points=da.ENC_N_POINTS_TEMPORAL_FRAME,
            dec_n_temporal_points=da.DEC_N_POINTS_TEMPORAL_FRAME,
            instance_aware=da.INSTANCE_AWARE_ATTENTION)
    position_encoding = build_position_encoding(cfg)
    body, num_channels = build_backbone(cfg, dtype)
    detr = DeformableDETR(
        body, position_encoding,
        num_classes=eff_num_classes, num_queries=cfg.MODEL.NUM_QUERIES,
        num_feature_levels=cfg.MODEL.NUM_FEATURE_LEVELS,
        hidden_dim=cfg.MODEL.HIDDEN_DIM, aux_loss=cfg.MODEL.LOSS.AUX_LOSS,
        with_box_refine=cfg.MODEL.WITH_BBX_REFINE,
        with_ref_point_refine=cfg.MODEL.WITH_REF_POINT_REFINE,
        with_gradient=cfg.MODEL.BBX_GRADIENT_PROP,
        backbone_num_channels=num_channels,
        transformer_kwargs=transformer_kwargs, dtype=dtype)
    head = dict(mask_head_used_features=cfg.MODEL.MASK_HEAD.USED_FEATURES,
                att_maps_used_res=cfg.MODEL.MASK_HEAD.UPSAMPLING_RESOLUTIONS,
                mask_aux_loss=cfg.MODEL.LOSS.MASK_AUX_LOSS,
                matcher_cfg=matcher_cfg_from(cfg, clip=is_vis),
                num_out=cfg.TEST.NUM_OUT,
                use_deformable_conv=cfg.MODEL.MASK_HEAD.USE_MDC, dtype=dtype)
    if is_vis:
        model = DeVIS(detr, num_frames=T,
                      add_3d_conv_head=cfg.MODEL.MASK_HEAD.DEVIS.CONV_HEAD_3D, **head)
    elif cfg.MODEL.MASK_ON:
        model = DeformableDETRSegm(detr, focal_loss=cfg.MODEL.LOSS.FOCAL_LOSS, **head)
    else:
        model = detr
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
