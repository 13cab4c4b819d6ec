"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its entry points run on the GPU unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
                "devis_torch.util.trace",
                "devis_torch.util.fixtures", "devis_torch.parallel",
                "devis_torch.parallel.mesh", "devis_torch.parallel.multihost",
                "devis_torch.overfit_synthetic", "devis_torch.util.visualization",
                "devis_torch.visualize_att_maps", "devis_torch.visualize_dataset",
                "devis_torch.evaluation.panoptic_eval", "devis_torch.datasets.coco_panoptic",
                "devis_torch.datasets.coco_joint_vis", "devis_torch.datasets.warp",
                "devis_torch.accuracy_gate")


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
    """Covers imports inside functions too. The config files are read by the
    port's own YAML reader. Pillow is imported only in `datasets/image_io.py`,
    inside functions (the JPEG decode and encode); cv2 only in
    `util/visualization.py`, inside a function (the renders draw with it)."""
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
                    lazy_cv2 = (top == "cv2" and node.col_offset > 0
                                and path.endswith(os.path.join("util", "visualization.py")))
                    if top in FORBIDDEN and not lazy_cv2:
                        offenders.append(f"{path}: {n}")
                    elif top == "PIL" and not (f == "image_io.py" and node.col_offset > 0):
                        offenders.append(f"{path}: {n} (PIL only inside functions of "
                                         "image_io.py)")
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


def test_overfit_and_process_group_need_an_explicit_cpu(monkeypatch):
    """The overfit check runs on the GPU unless told otherwise; a process
    group on the GPU needs NCCL, and without it joining fails loudly (this
    build of torch has none), while outside torchrun nothing is joined."""
    import torch.distributed as dist

    from devis_torch import overfit_synthetic
    from devis_torch.parallel import init_process_group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overfit_synthetic.main(steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overfit_synthetic.build()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_process_group() is None and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        init_process_group()
    assert not dist.is_initialized()


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
    """Every model family builds: `coco_panoptic` the image model (as the
    JAX `is_vis = TYPE == "vis"` does), shared heads, reference-point
    refinement and the Swin backbones."""
    from devis_torch.models import build_model
    cfg = _small_cfg()
    cfg.DATASETS.TYPE = "coco_panoptic"
    cfg.MODEL.MASK_ON = True
    assert type(build_model(250, cfg, device="cpu")).__name__ == "DeformableDETRSegm"
    cfg.DATASETS.TYPE = "kinetics"
    with pytest.raises(ValueError, match="kinetics"):
        build_model(91, cfg, device="cpu")
    # shared heads and reference-point refinement are ported: both build,
    # and reference-point refinement asks for shared heads, as the config's
    # sanity check does
    for ref_point in (False, True):
        cfg = _small_cfg()
        cfg.DATASETS.TYPE = "coco"
        cfg.MODEL.WITH_BBX_REFINE = False
        cfg.MODEL.WITH_REF_POINT_REFINE = ref_point
        model = build_model(91, cfg, device="cpu")
        detr = getattr(model, "def_detr", model)
        assert detr.class_embed[0] is detr.class_embed[-1]
        assert (detr.ref_point_embed is not None) == ref_point
    cfg.MODEL.WITH_BBX_REFINE = True
    with pytest.raises(ValueError, match="WITH_BBX_REFINE=False"):
        build_model(91, cfg, device="cpu")
    # the Swin backbones are ported: an unregistered name raises KeyError, as
    # in the JAX package, and a registered one builds
    cfg = _small_cfg()
    cfg.MODEL.BACKBONE = "swin_t"
    with pytest.raises(KeyError):
        build_model(41, cfg, device="cpu")
    cfg = _small_cfg()
    cfg.MODEL.BACKBONE = "swin_t_p4w7"
    cfg.TPU.TRANSFORMER_GRADIENT_CHECKPOINT = True
    model = build_model(41, cfg, device="cpu")
    assert type(model.def_detr.backbone[0].body).__name__ == "SwinTransformer"
    assert model.def_detr.transformer.remat_layers


def test_tracker_entry_point_needs_an_explicit_cpu(monkeypatch):
    from devis_torch.inference import build_tracker
    from devis_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_cfg()
    model = build_model(41, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_tracker(cfg, model)
    assert build_tracker(cfg, model, device="cpu").infer_fn.device.type == "cpu"
