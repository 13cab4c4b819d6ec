"""Configuration system of the PyTorch port.

The port's own copy of `devis_tpu/config.py`: a minimal YACS-compatible
config node plus the default config tree, with the same key names, so the
YAML files under `configs/` load verbatim. `yaml` is imported only where a
file or string is parsed or dumped, so the defaults work on machines that
lack it.
"""
from __future__ import annotations

import copy
import io
from typing import Any, Dict, List


class CfgNode(dict):
    """A dict with attribute access and recursive merge, YACS-style."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set {name!r}")
        self[name] = value

    # -- mutability -------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        new = CfgNode()
        memo[id(self)] = new
        for k, v in self.items():
            new[k] = copy.deepcopy(v, memo)
        return new

    def __reduce__(self):
        return (CfgNode, (dict((k, dict(v) if isinstance(v, dict) else v)
                               for k, v in self.items()),))

    # -- merging ----------------------------------------------------------
    def _merge_other(self, other: Dict[str, Any], path: str = "") -> None:
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite config group {full} with a value")
                self[k]._merge_other(v, full)
            else:
                self[k] = _coerce(v, self[k], full)

    def merge_from_file(self, filename: str) -> None:
        import yaml
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self._merge_other(loaded)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_other(other)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list must be key/value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                import yaml
                value = yaml.safe_load(value)
            node[leaf] = _coerce(value, node[leaf], key)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def dump(self) -> str:
        import yaml
        buf = io.StringIO()
        yaml.safe_dump(self.to_dict(), buf, default_flow_style=False)
        return buf.getvalue()


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Light type checking/coercion when overriding a leaf value."""
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Config key {key} expects bool, got {value!r}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (list, tuple)):
        return list(value)
    if not isinstance(value, type(old)) and not (isinstance(old, int) and isinstance(value, float)):
        raise TypeError(f"Config key {key} expects {type(old).__name__}, got {value!r}")
    return value


# ---------------------------------------------------------------------------
# Default configuration tree. Defaults correspond to Deformable DETR, with the
# DeVIS video additions under MODEL.DEVIS, with the reference config's key names.
# ---------------------------------------------------------------------------
_C = CfgNode()

_C.MODEL = CfgNode()
_C.MODEL.WEIGHTS = ""                    # checkpoint to load (torch .pth or orbax dir)
_C.MODEL.SHIFT_CLASS_NEURON = False      # remap class logits from official DefDETR ordering
_C.MODEL.BACKBONE = "resnet50"           # resnet50 | resnet101 | swin_*
_C.MODEL.BACKBONE_DILATION = False       # DC5 variant
_C.MODEL.NUM_QUERIES = 300
_C.MODEL.HIDDEN_DIM = 256
_C.MODEL.DIM_FEEDFORWARD = 1024
_C.MODEL.DROPOUT = 0.1
_C.MODEL.NUM_FEATURE_LEVELS = 4
_C.MODEL.WITH_BBX_REFINE = True
_C.MODEL.BBX_GRADIENT_PROP = False
_C.MODEL.WITH_REF_POINT_REFINE = False
_C.MODEL.MASK_ON = False

_C.MODEL.TRANSFORMER = CfgNode()
_C.MODEL.TRANSFORMER.ENCODER_LAYERS = 6
_C.MODEL.TRANSFORMER.DECODER_LAYERS = 6
_C.MODEL.TRANSFORMER.N_HEADS = 8
_C.MODEL.TRANSFORMER.ENC_N_POINTS = 4
_C.MODEL.TRANSFORMER.DEC_N_POINTS = 4

_C.MODEL.MASK_HEAD = CfgNode()
_C.MODEL.MASK_HEAD.USE_MDC = True        # modulated deformable convs in mask head
_C.MODEL.MASK_HEAD.UPSAMPLING_RESOLUTIONS = ["/32", "/16", "/8"]
_C.MODEL.MASK_HEAD.USED_FEATURES = [["/32", "encoded"], ["/16", "encoded"],
                                    ["/8", "encoded"], ["/4", "backbone"]]
_C.MODEL.MASK_HEAD.DEVIS = CfgNode()
_C.MODEL.MASK_HEAD.DEVIS.CONV_HEAD_3D = False

_C.MODEL.DEVIS = CfgNode()
_C.MODEL.DEVIS.NUM_FRAMES = 6
_C.MODEL.DEVIS.TEMPORAL_EMBEDDING = "learned"   # learned | sine

_C.MODEL.DEVIS.DEFORMABLE_ATTENTION = CfgNode()
_C.MODEL.DEVIS.DEFORMABLE_ATTENTION.DISABLE_TEMPORAL_CONNECTIONS = False
_C.MODEL.DEVIS.DEFORMABLE_ATTENTION.ENC_CONNECT_ALL_FRAMES = True
_C.MODEL.DEVIS.DEFORMABLE_ATTENTION.ENC_TEMPORAL_WINDOW = 4
_C.MODEL.DEVIS.DEFORMABLE_ATTENTION.INSTANCE_AWARE_ATTENTION = True
_C.MODEL.DEVIS.DEFORMABLE_ATTENTION.ENC_N_POINTS_TEMPORAL_FRAME = 4
_C.MODEL.DEVIS.DEFORMABLE_ATTENTION.DEC_N_POINTS_TEMPORAL_FRAME = 4

_C.MODEL.LOSS = CfgNode()
_C.MODEL.LOSS.AUX_LOSS = True
_C.MODEL.LOSS.AUX_LOSS_WEIGHTING = False
_C.MODEL.LOSS.FOCAL_LOSS = True
_C.MODEL.LOSS.MASK_AUX_LOSS = [2]
_C.MODEL.LOSS.SEGM_MASK_COEF = 1.0
_C.MODEL.LOSS.SEGM_DICE_COEF = 1.0
_C.MODEL.LOSS.BBX_L1_COEF = 5.0
_C.MODEL.LOSS.BBX_GIOU_COEF = 2.0
_C.MODEL.LOSS.CLASS_COEF = 2.0
_C.MODEL.LOSS.FOCAL_ALPHA = 0.25
_C.MODEL.LOSS.EOS = 0.1

_C.MODEL.MATCHER = CfgNode()
_C.MODEL.MATCHER.CLASS_COST = 2.0
_C.MODEL.MATCHER.BBX_L1_COST = 5.0
_C.MODEL.MATCHER.BBX_GIOU_COST = 2.0
_C.MODEL.MATCHER.USE_SUM_L1_DISTANCE = False

_C.DATASETS = CfgNode()
_C.DATASETS.TYPE = "coco"                # coco | coco_panoptic | vis
_C.DATASETS.DATA_PATH = "data"
_C.DATASETS.TRAIN_DATASET = "train"
_C.DATASETS.VAL_DATASET = "val"
_C.DATASETS.DEVIS = CfgNode()
_C.DATASETS.DEVIS.COCO_JOINT_TRAINING = False

_C.INPUT = CfgNode()
_C.INPUT.SCALE_FACTOR_TRAIN = 1.0
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.DEVIS = CfgNode()
_C.INPUT.DEVIS.MULTI_SCALE_TRAIN = True
_C.INPUT.DEVIS.SAMPLE_EACH_FRAME = False
_C.INPUT.DEVIS.CREATE_BBX_FROM_MASK = True

_C.SOLVER = CfgNode()
_C.SOLVER.BASE_LR = 0.0002
_C.SOLVER.FROZEN_PARAMS = []
_C.SOLVER.BACKBONE_NAMES = ["backbone.0"]
_C.SOLVER.LR_BACKBONE = 0.00002
_C.SOLVER.LR_LINEAR_PROJ_NAMES = ["self_attn.sampling_offsets", "cross_attn.sampling_offsets",
                                  "reference_points"]
_C.SOLVER.LR_LINEAR_PROJ_MULT = 0.1
_C.SOLVER.LR_MASK_HEAD_NAMES = ["bbox_attention", "mask_head"]
_C.SOLVER.LR_MASK_HEAD_MULT = 1
_C.SOLVER.DEVIS = CfgNode()
_C.SOLVER.DEVIS.LR_TEMPORAL_LINEAR_PROJ_NAMES = ["temporal_sampling_offsets"]
_C.SOLVER.DEVIS.LR_TEMPORAL_LINEAR_PROJ_MULT = 0.1
_C.SOLVER.DEVIS.FINETUNE_QUERY_EMBEDDINGS = False
_C.SOLVER.DEVIS.FINETUNE_TEMPORAL_MODULES = True
_C.SOLVER.DEVIS.FINETUNE_CLASS_LOGITS = False
_C.SOLVER.EPOCHS = 50
_C.SOLVER.STEPS = [40]
_C.SOLVER.BATCH_SIZE = 2
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.RESUME_OPTIMIZER = False
_C.SOLVER.CHECKPOINT_INTERVAL = 1
_C.SOLVER.GRAD_CLIP_MAX_NORM = 0.1

_C.START_EPOCH = 1

_C.TEST = CfgNode()
_C.TEST.EVAL_PERIOD = 1
_C.TEST.START_EVAL_EPOCH = 1
_C.TEST.SAVE_PATH = "eval_results"
_C.TEST.NUM_OUT = 100
_C.TEST.EVAL_BATCH_SIZE = 1     # images per forward in the COCO evaluation
_C.TEST.USE_TOP_K = True
_C.TEST.CLIP_TRACKING = CfgNode()
_C.TEST.CLIP_TRACKING.STRIDE = 4
_C.TEST.CLIP_TRACKING.PER_CLASS_MATCHING = False
_C.TEST.CLIP_TRACKING.USE_BINARY_MASK_IOU = False
_C.TEST.CLIP_TRACKING.USE_FRAME_AVERAGE_IOU = False
_C.TEST.CLIP_TRACKING.FINAL_CLASS_POLICY = "most_common"
_C.TEST.CLIP_TRACKING.FINAL_SCORE_POLICY = "mean"
_C.TEST.CLIP_TRACKING.CLASS_COST = 1
_C.TEST.CLIP_TRACKING.MASK_COST = 1
_C.TEST.CLIP_TRACKING.SCORE_COST = 1
_C.TEST.CLIP_TRACKING.CENTER_COST = 0
_C.TEST.CLIP_TRACKING.MIN_FRAME_SCORE = 0.001
_C.TEST.CLIP_TRACKING.MIN_TRACK_SCORE = 0.002
_C.TEST.CLIP_TRACKING.MIN_DETECTIONS = 1
_C.TEST.INPUT_FOLDER = ""
_C.TEST.EPOCHS_TO_EVAL = [6, 7, 8, 9, 10]
_C.TEST.VIZ = CfgNode()
_C.TEST.VIZ.OUT_VIZ_PATH = ""
_C.TEST.VIZ.SAVE_CLIP_VIZ = False
_C.TEST.VIZ.SAVE_MERGED_TRACKS = False
_C.TEST.VIZ.VIDEO_NAMES = ""

_C.NUM_WORKERS = 4
_C.OUTPUT_DIR = "./output"
_C.VISDOM_AND_LOG_INTERVAL = 100
_C.VISDOM_ON = False
_C.RESUME_VIS = False
_C.VISDOM_PORT = 8090
_C.VISDOM_SERVER = "http://localhost"
_C.SEED = 42
_C.DEVICE = "cuda"

# Additions of the JAX package, kept under the same keys so one YAML serves
# both packages. The port reads COMPUTE_DTYPE; the others configure the JAX
# package (Pallas route, device mesh, remat, the banded DCNv2 window) and are
# carried here unread.
_C.TPU = CfgNode()
_C.TPU.MSDA_IMPL = "auto"
_C.TPU.COMPUTE_DTYPE = "float32"     # float32 | bfloat16 for the model compute path
_C.TPU.MESH_DP = 0
_C.TPU.EVAL_SIZE_BUCKETS = 1
_C.TPU.SWIN_GRADIENT_CHECKPOINT = False
_C.TPU.TRANSFORMER_GRADIENT_CHECKPOINT = False
_C.TPU.MAX_INSTANCES = 25            # target-slot capacity per sample
_C.TPU.MASKHEAD_BAND_NCAND = [3, 3]


def get_cfg_defaults() -> CfgNode:
    """Return a fresh clone of the default config."""
    return _C.clone()


def sanity_check(cfg: CfgNode) -> None:
    """Startup config invariants (reference: main.py:52-94)."""
    assert cfg.DATASETS.TYPE in ("coco", "coco_panoptic", "vis"), \
        cfg.DATASETS.TYPE
    if cfg.DATASETS.TYPE == "vis":
        assert cfg.SOLVER.BATCH_SIZE == 1, "VIS training requires BATCH_SIZE=1"
        assert cfg.MODEL.NUM_QUERIES % cfg.MODEL.DEVIS.NUM_FRAMES == 0, \
            "NUM_QUERIES must be divisible by NUM_FRAMES"
    if cfg.MODEL.WITH_REF_POINT_REFINE:
        assert not cfg.MODEL.WITH_BBX_REFINE, \
            "WITH_REF_POINT_REFINE requires WITH_BBX_REFINE=False"
    assert cfg.MODEL.NUM_FEATURE_LEVELS in (1, 2, 3, 4)
    assert cfg.MODEL.HIDDEN_DIM % cfg.MODEL.TRANSFORMER.N_HEADS == 0
