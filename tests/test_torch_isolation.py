"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its entry points run on the GPU unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "devis_tpu", "yaml", "cv2", "ml_dtypes")
PORT_MODULES = ("devis_torch", "devis_torch.config", "devis_torch.models",
                "devis_torch.inference", "devis_torch.util.weights",
                "devis_torch.util.box_ops", "devis_torch.ops.ms_deform_attn_cuda",
                "devis_torch.ops.deform_conv", "devis_torch.ops.interpolate")


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "from devis_torch.config import get_cfg_defaults\n"
            "get_cfg_defaults()\n"
            f"print([m for m in {FORBIDDEN!r} if m in sys.modules])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_no_module_of_the_port_names_a_forbidden_import():
    """Covers imports inside functions too (yaml only in the config's
    file and dump helpers)."""
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
                    if top in FORBIDDEN and not (top == "yaml" and f == "config.py"):
                        offenders.append(f"{path}: {n}")
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


def test_other_model_families_name_their_roadmap_item():
    from devis_torch.models import build_model
    cfg = _small_cfg()
    cfg.DATASETS.TYPE = "coco"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(91, cfg, device="cpu")
    cfg = _small_cfg()
    cfg.MODEL.BACKBONE = "swin_t"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(41, cfg, device="cpu")
