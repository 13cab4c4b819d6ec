"""Every config file of the repo resolves through the port's own YAML reader
and `build_model(..., device="cpu")` builds it at full width: the three
`deformable_mask_head` files as the COCO image model, every other file as
the model its `DATASETS.TYPE` names. The built model carries the file's
variant: the transformer with or without temporal connections, the number
of feature levels, the DCNv2 or plain-conv mask head, the 3-d conv head,
shared or per-layer heads, the backbone. The depth is cut to keep the file
fast: 1 encoder and 2 decoder layers, and a Swin's stages at 2 blocks each
(Swin-L's third stage has 18)."""
import glob
import os

import pytest
import torch

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(p, ROOT)
               for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def test_every_config_file_is_listed():
    assert len(FILES) == 19
    assert sum("ablations" in p for p in FILES) == 8


@pytest.mark.parametrize("path", FILES)
def test_config_file_builds(path, monkeypatch):
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_torch.models.backbones.swin import SWIN_CONFIGS
    from devis_torch.models.segmentation import ModulatedDeformableConv

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, path))
    if path.startswith(os.path.join("configs", "deformable_mask_head")):
        cfg.DATASETS.TYPE = "coco"
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.freeze()
    if cfg.MODEL.BACKBONE in SWIN_CONFIGS:
        monkeypatch.setitem(SWIN_CONFIGS, cfg.MODEL.BACKBONE,
                            dict(SWIN_CONFIGS[cfg.MODEL.BACKBONE], depths=(2, 2, 2, 2)))
    is_vis = cfg.DATASETS.TYPE == "vis"
    with torch.random.fork_rng():
        model = build_model(41 if is_vis else 91, cfg, device="cpu")
    assert type(model).__name__ == ("DeVIS" if is_vis else
                                    "DeformableDETRSegm" if cfg.MODEL.MASK_ON else
                                    "DeformableDETR")
    detr = getattr(model, "def_detr", model)
    t = detr.transformer
    da = cfg.MODEL.DEVIS.DEFORMABLE_ATTENTION
    assert t.variant == ("image" if not is_vis else
                         "devis_ablation" if da.DISABLE_TEMPORAL_CONNECTIONS else "devis")
    assert len(t.encoder.layers) == cfg.MODEL.TRANSFORMER.ENCODER_LAYERS
    assert len(t.decoder.layers) == cfg.MODEL.TRANSFORMER.DECODER_LAYERS
    assert len(detr.input_proj) == cfg.MODEL.NUM_FEATURE_LEVELS
    assert detr.query_embed.weight.shape[0] == cfg.MODEL.NUM_QUERIES
    assert (detr.class_embed[0] is detr.class_embed[-1]) == (not cfg.MODEL.WITH_BBX_REFINE)
    assert type(detr.backbone[0].body).__name__ == \
        ("SwinTransformer" if "swin" in cfg.MODEL.BACKBONE else "ResNet")
    if is_vis or cfg.MODEL.MASK_ON:
        dcn = any(isinstance(m, ModulatedDeformableConv) for m in model.mask_head.modules())
        assert dcn == cfg.MODEL.MASK_HEAD.USE_MDC
    if is_vis:
        assert model.num_frames == cfg.MODEL.DEVIS.NUM_FRAMES
        assert (model.conv_head_3d is not None) == cfg.MODEL.MASK_HEAD.DEVIS.CONV_HEAD_3D
        assert (model.mask_head.out_lay is None) == cfg.MODEL.MASK_HEAD.DEVIS.CONV_HEAD_3D
    assert all(torch.isfinite(p).all() for p in model.parameters())
