"""The port's overfit check (`devis_torch.overfit_synthetic`) on the CPU:
its settings against the JAX script's (`benchmarks/overfit_synthetic.py`,
read with `ast`, key by key), and a few steps through training, tracking and
TrackMAP with the MDC head and with the plain conv, narrowed (128 wide,
1 + 2 layers, 64x96 videos) to stay small on the CPU.
"""
import ast
import math
import os

import pytest

from devis_torch import overfit_synthetic as ov

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "overfit_synthetic.py")


def _script_main():
    tree = ast.parse(open(SCRIPT).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    return ".".join([node.id] + parts[::-1]) if isinstance(node, ast.Name) else None


def _calls(fn, name):
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call) and _dotted(n.func) in (
        name, name.split(".")[-1])]


def _kwargs(call):
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg and not isinstance(k.value, (ast.Name, ast.Tuple, ast.Attribute))
            or (isinstance(k.value, ast.Tuple) and all(isinstance(e, ast.Constant)
                                                       for e in k.value.elts))}


def test_settings_are_the_jax_scripts():
    fn = _script_main()
    # `T, H, W = 4, 128, 192` and every `cfg.X.Y = value` (lines 37-52)
    sets, thw = {}, None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple) \
                and [e.id for e in node.targets[0].elts] == ["T", "H", "W"]:
            thw = ast.literal_eval(node.value)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute):
            key = _dotted(node.targets[0])
            if key and key.startswith("cfg."):
                sets[key[4:]] = node.value
    names = dict(zip("THW", thw))
    sets = {k: names[v.id] if isinstance(v, ast.Name) else ast.literal_eval(v)
            for k, v in sets.items()}
    s = ov.SETTINGS
    assert thw == (s["num_frames"],) + tuple(s["size"]) == (4, 128, 192)
    cfg = ov.overfit_cfg(mdc=True)
    want_plain = sets.pop("MODEL.MASK_HEAD.USE_MDC")        # set under `--no-mdc`
    assert want_plain is False and ov.overfit_cfg(mdc=False).MODEL.MASK_HEAD.USE_MDC is False
    assert cfg.MODEL.MASK_HEAD.USE_MDC is True
    assert sorted(sets) == sorted([
        "DATASETS.TYPE", "MODEL.MASK_ON", "MODEL.TRANSFORMER.ENCODER_LAYERS",
        "MODEL.TRANSFORMER.DECODER_LAYERS", "MODEL.DEVIS.NUM_FRAMES", "MODEL.NUM_QUERIES",
        "MODEL.LOSS.MASK_AUX_LOSS", "TEST.NUM_OUT", "TEST.CLIP_TRACKING.STRIDE",
        "INPUT.MIN_SIZE_TEST", "INPUT.MAX_SIZE_TEST", "SOLVER.BASE_LR"])
    for key, value in sets.items():
        node = cfg
        for part in key.split("."):
            node = getattr(node, part)
        assert node == value, key
    # the JAX script keeps the default compute dtype, f32, in both packages
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    assert cfg.TPU.COMPUTE_DTYPE == jax_cfg().TPU.COMPUTE_DTYPE == s["compute_dtype"] == "float32"
    # the data (lines 56-58 and 88-90), the classes and the seeds
    train = _kwargs(_calls(fn, "SyntheticVISDataset")[0])
    assert train == {"n_videos": s["n_videos"], "video_len": s["video_len"]}
    val = _kwargs(_calls(fn, "SyntheticVISValDataset")[0])
    assert val == {"stride": s["stride"], "n_videos": s["n_videos"],
                   "video_len": s["video_len"], "min_size": s["min_size_test"],
                   "max_size": s["max_size_test"]}
    assert _kwargs(_calls(fn, "collate_clip")[0]) == {"max_instances": s["max_instances"]}
    assert {_kwargs(c).get("num_classes") for c in _calls(fn, "build_model")} == {ov.NUM_CLASSES}
    keys = sorted(ast.literal_eval(c.args[0]) for c in _calls(fn, "jax.random.PRNGKey"))
    assert keys == sorted([s["model_seed"], s["dropout_seed"], 0])   # the last: train-path IoU
    # the port's pieces build what the script builds
    clips = ov.train_clips(cfg)
    assert len(clips) == s["n_videos"] * (s["video_len"] - s["num_frames"] + 1)
    assert clips[0]["images"].shape == (4, 128, 192, 3)
    assert clips[0]["targets"]["labels"].shape == (s["max_instances"],)
    val_ds = ov.val_dataset(cfg)
    assert len(val_ds) == s["n_videos"] and val_ds.overlap_window == 2


NARROW = ["MODEL.HIDDEN_DIM", 128, "MODEL.DIM_FEEDFORWARD", 128,
          "MODEL.TRANSFORMER.ENCODER_LAYERS", 1, "MODEL.TRANSFORMER.DECODER_LAYERS", 2,
          "MODEL.NUM_QUERIES", 16, "TEST.NUM_OUT", 4,
          "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96]


@pytest.mark.parametrize("mdc", [True, False], ids=["mdc", "no-mdc"])
def test_a_few_steps_run_through_tracking_and_trackmap(mdc, monkeypatch):
    monkeypatch.setitem(ov.SETTINGS, "size", (64, 96))
    monkeypatch.setitem(ov.SETTINGS, "video_len", 5)
    monkeypatch.setitem(ov.SETTINGS, "min_size_test", 64)
    monkeypatch.setitem(ov.SETTINGS, "max_size_test", 96)
    res = ov.main(steps=3, mdc=mdc, device="cpu", overrides=NARROW, verbose=False,
                  checked=False)
    assert [i for i, _ in res["losses"]] == [0, 2]
    assert all(math.isfinite(v) and v > 0 for _, v in res["losses"])
    assert res["mdc"] is mdc and res["sec_per_step"] > 0
    assert isinstance(res["halved"], bool)
    e = res["eval"]
    assert {"AP", "AP50", "AP75", "AR"} <= set(e)
    assert all(0.0 <= e[k] <= 100.0 for k in ("AP", "AP50", "AP75"))
    d = res["diagnostics"]
    assert d["gt_tracks"] == 2 * 3 and d["pred_tracks"] >= 1
    assert len(d["best_gt_iou"]) == d["pred_tracks"]
    assert all(0.0 <= v <= 1.0 for v in d["best_gt_iou"] + d["pred_pred_iou"])
    assert isinstance(d["collapsed"], bool)
    assert len(d["train_mask_iou"]) == 3 and all(0.0 <= v <= 1.0 for v in d["train_mask_iou"])


def test_the_checks_raise():
    """The loss must halve; the tracks must not collapse (the r4 fault)."""
    gt = {"annotations": [{"video_id": 1, "segmentations": [None]}]}
    from devis_torch.evaluation import rle
    import numpy as np
    m = np.zeros((8, 8), bool)
    m[2:6, 2:6] = True
    seg = [rle.encode(m)]
    same = [{"video_id": 1, "segmentations": seg}, {"video_id": 1, "segmentations": seg}]
    assert ov.track_diagnostics(same, gt)["collapsed"] is True
    other = np.zeros((8, 8), bool)
    other[0:2, 0:2] = True
    apart = [same[0], {"video_id": 1, "segmentations": [rle.encode(other)]}]
    d = ov.track_diagnostics(apart, gt)
    assert d["collapsed"] is False and d["pred_pred_iou"] == [0.0]
    assert ov.track_diagnostics(same[:1], gt)["collapsed"] is False     # no pair
    ok = {"losses": [(0, 20.0), (9, 9.9)], "halved": True, "diagnostics": d}
    ov.check(ok)
    with pytest.raises(AssertionError, match="did not halve"):
        ov.check({**ok, "losses": [(0, 20.0), (9, 10.0)], "halved": False})
    with pytest.raises(AssertionError, match="collapsed"):
        ov.check({**ok, "diagnostics": ov.track_diagnostics(same, gt)})
