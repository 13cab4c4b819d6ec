"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its entry points run on the GPU unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "devis_tpu", "yaml", "cv2", "ml_dtypes", "scipy")
PORT_MODULES = ("devis_torch", "devis_torch.config", "devis_torch.models",
                "devis_torch.inference", "devis_torch.util.weights",
                "devis_torch.util.box_ops", "devis_torch.ops.ms_deform_attn_cuda",
                "devis_torch.ops.deform_conv", "devis_torch.ops.interpolate",
                "devis_torch.ops.hungarian", "devis_torch.models.matcher",
                "devis_torch.models.criterion", "devis_torch.engine",
                "devis_torch.util.misc", "devis_torch.util.synthetic",
                "devis_torch.ops.ms_deform_attn", "devis_torch.ops._build",
                "devis_torch.models.attention", "devis_torch.models.transformer",
                "devis_torch.models.position_encoding", "devis_torch.models.detr",
                "devis_torch.models.segmentation", "devis_torch.models.devis_model",
                "devis_torch.ops.probes", "devis_torch.ops.msda_lab",
                "devis_torch.evaluation.rle", "devis_torch.evaluation._native",
                "devis_torch.evaluation.track_map", "devis_torch.datasets.transforms",
                "devis_torch.datasets.vis", "devis_torch.datasets.synthetic",
                "devis_torch.tracking.track", "devis_torch.tracking.inference_matcher",
                "devis_torch.tracking.pipeline", "devis_torch.tracking.tracker",
                "devis_torch.main", "devis_torch.datasets", "devis_torch.datasets.coco",
                "devis_torch.datasets.image_io", "devis_torch.evaluation.coco_eval",
                "devis_torch.util.checkpoint", "devis_torch.util.logging_utils",
                "devis_torch.util.fixtures")


def test_import_leaves_jax_out_of_sys_modules():
    """Importing the port, reading and dumping a config file, running its
    RLE codec (built at first use) and decoding a PNG loads none of the
    forbidden modules, nor Pillow."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "from devis_torch.config import get_cfg_defaults\n"
            "cfg = get_cfg_defaults()\n"
            "cfg.merge_from_file('configs/devis/YT-19/devis_R_50_YT-19.yaml')\n"
            "cfg.dump()\n"
            "import numpy as np\n"
            "from devis_torch.evaluation import rle\n"
            "rle.decode(rle.encode(np.eye(3, dtype=bool)))\n"
            "from devis_torch.datasets import image_io\n"
            "image_io.decode_png(image_io.encode_png(np.zeros((2, 3, 3), np.uint8)))\n"
            f"print([m for m in {FORBIDDEN!r} + ('PIL',) if m in sys.modules])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_no_module_of_the_port_names_a_forbidden_import():
    """Covers imports inside functions too. No exemption: the config files
    are read by the port's own YAML reader. Pillow is imported only in
    `datasets/image_io.py`, inside the function that decodes a JPEG."""
    offenders = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "devis_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for node in ast.walk(ast.parse(open(path).read())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    if top in FORBIDDEN:
                        offenders.append(f"{path}: {n}")
                    elif top == "PIL" and not (f == "image_io.py" and node.col_offset > 0):
                        offenders.append(f"{path}: {n} (PIL only lazily, in image_io.py)")
    assert offenders == []


def _small_cfg():
    from devis_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.HIDDEN_DIM = 64
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 1
    cfg.MODEL.NUM_QUERIES = 4
    cfg.MODEL.DEVIS.NUM_FRAMES = 2
    return cfg


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    from devis_torch.inference import VISInferFn
    from devis_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(41, _small_cfg())
    model = build_model(41, _small_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VISInferFn(model, 2, [(64, 64)])
    VISInferFn(model, 2, [(64, 64)], device="cpu")


def test_image_entry_points_need_an_explicit_cpu(monkeypatch):
    """`build_model` for `coco` and `evaluate_coco` raise without a GPU
    rather than run on the CPU, unless the caller asks for the CPU."""
    from devis_torch.inference import evaluate_coco
    from devis_torch.models import build_model
    from devis_torch.util.synthetic import SyntheticImageDataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mask_on in (True, False):
        cfg = _small_cfg()
        cfg.DATASETS.TYPE = "coco"
        cfg.MODEL.MASK_ON = mask_on
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(91, cfg)
        model = build_model(91, cfg, device="cpu")
        assert type(model).__name__ == ("DeformableDETRSegm" if mask_on else "DeformableDETR")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_coco(model, SyntheticImageDataset(0, []), cfg, None)


def test_other_model_families_name_their_roadmap_item():
    from devis_torch.models import build_model
    cfg = _small_cfg()
    cfg.DATASETS.TYPE = "coco_panoptic"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(91, cfg, device="cpu")
    for key in ("WITH_BBX_REFINE", "WITH_REF_POINT_REFINE"):
        cfg = _small_cfg()
        cfg.DATASETS.TYPE = "coco"
        setattr(cfg.MODEL, key, key == "WITH_REF_POINT_REFINE")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(91, cfg, device="cpu")
    cfg = _small_cfg()
    cfg.MODEL.BACKBONE = "swin_t"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(41, cfg, device="cpu")


def test_tracker_entry_point_needs_an_explicit_cpu(monkeypatch):
    from devis_torch.inference import build_tracker
    from devis_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_cfg()
    model = build_model(41, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_tracker(cfg, model)
    assert build_tracker(cfg, model, device="cpu").infer_fn.device.type == "cpu"
