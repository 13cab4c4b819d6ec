"""The visualizers against the JAX package's (`devis_tpu/util/visualization.py`,
the tracker's `TEST.VIZ` renders, `visualize_dataset.py`), pixel for pixel:
both draw with the same cv2 calls on the same seeded inputs, so the images
are equal. Then the port's entry points on the CPU: `visualize_att_maps`
(`--device cpu`), `visualize_dataset` and the visualization config through
`devis_torch.main` on a YouTube-VIS 2021 fixture tree."""
import os

import cv2
import numpy as np
import pytest
import torch

from devis_torch.evaluation import rle
from devis_torch.tracking.inference_matcher import HungarianInferenceMatcher
from devis_torch.tracking.tracker import Tracker
from devis_torch.util import visualization as viz
from devis_torch.util.fixtures import write_vis_tree
from devis_tpu.tracking.inference_matcher import \
    HungarianInferenceMatcher as JaxMatcher
from devis_tpu.tracking.tracker import Tracker as JaxTracker
from devis_tpu.util import visualization as viz_jax

from .test_rle_tracking import TRACKER_CFG, _fake_infer
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from .test_visualization import _VizVideo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIZ_CONFIG = os.path.join(ROOT, "configs", "devis", "devis_R_50_visualization_YT-21.yaml")
VIDEO_NAMES = ("4b1a561480", "c34989e3")
# the config at a width the CPU runs in seconds; the file's own settings
# (180 queries, bf16, 6 + 6 layers, the 360x640 test size) run on the card
NARROW = ["MODEL.HIDDEN_DIM", "64", "MODEL.DIM_FEEDFORWARD", "64",
          "MODEL.TRANSFORMER.ENCODER_LAYERS", "1", "MODEL.TRANSFORMER.DECODER_LAYERS", "2",
          "MODEL.NUM_QUERIES", "36", "TPU.COMPUTE_DTYPE", "float32",
          "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96"]


def _frame(seed, h=48, w=64):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(np.uint8)


def _read_tree(root):
    """{relative path: image array or text} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            out[rel] = open(p).read() if f.endswith(".txt") else cv2.imread(p)
    return out


def _same_tree(a, b):
    ta, tb = _read_tree(a), _read_tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for k, v in ta.items():
        if isinstance(v, str):
            assert v == tb[k], k
        else:
            assert v is not None and np.array_equal(v, tb[k]), k


def test_color_maps_equal_the_jax_ones():
    for n, norm in ((256, False), (15, False), (256, True)):
        got, want = viz.create_color_map(n, norm), viz_jax.create_color_map(n, norm)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for i in range(30):
        assert np.array_equal(viz.color_for(i), viz_jax.color_for(i))


@pytest.mark.parametrize("form", ["rle", "probs", "small"])
@pytest.mark.parametrize("box", [True, False])
def test_draw_instance_equals_the_jax_one(form, box):
    """One instance on a frame: the mask as an RLE, as probabilities and as
    a stride-4 `SmallMask` (the tracker's form, each package's own), with a
    box and without (the label at the mask's leftmost column)."""
    from devis_torch.tracking.track import SmallMask
    from devis_tpu.tracking.track import SmallMask as JaxSmallMask
    rs = np.random.RandomState(4)
    probs = np.zeros((48, 64), np.float32)
    probs[10:30, 14:40] = rs.uniform(0.3, 1.0, (20, 26))
    logits = (probs[::4, ::4] - 0.5) * 8
    masks = {"rle": (rle.encode(probs > 0.5),) * 2, "probs": (probs,) * 2,
             "small": (SmallMask(logits, (48, 64)), JaxSmallMask(logits, (48, 64)))}[form]
    cmap = viz.create_color_map()
    outs = []
    for mod, mask in zip((viz, viz_jax), masks):
        inst = {"mask": mask, "score": 0.8125, "category_id": 3, "instance_id": 5,
                "bbox": np.array([12.3, 9.7, 41.2, 31.9]) if box else None}
        outs.append(mod.draw_instance(_frame(1), inst, cmap, {3: "cat"}, draw_box=box))
    assert np.array_equal(*outs) and not np.array_equal(outs[0], _frame(1))


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_overlay_tracks_on_frame_equals_the_jax_one(threshold):
    rs = np.random.RandomState(2)
    results = []
    for k in range(3):
        m = np.zeros((48, 64), bool)
        m[5 + 10 * k:15 + 10 * k, 3 + 15 * k:20 + 15 * k] = True
        results.append({"video_id": 1, "score": 0.3 + 0.3 * k, "category_id": k + 1,
                        "segmentations": [rle.encode(m) if rs.rand() > 0.2 else None
                                          for _ in range(3)]})
    for t in range(3):
        got = viz.overlay_tracks_on_frame(_frame(t), results, t, {1: "a", 2: "b"},
                                          score_threshold=threshold)
        want = viz_jax.overlay_tracks_on_frame(_frame(t), results, t, {1: "a", 2: "b"},
                                               score_threshold=threshold)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("level,level_colors", [(None, True), (0, True), (2, True),
                                                (None, False)])
def test_render_sampling_points_equals_the_jax_one(level, level_colors):
    rs = np.random.RandomState(0)
    loc = rs.rand(2, 3, 2, 4, 4, 2).astype(np.float32) * 1.2 - 0.1
    att = rs.rand(2, 3, 2, 4, 4).astype(np.float32)
    for q, t in ((1, 0), (2, 1)):
        got = viz.render_sampling_points(_frame(5), loc, att, q, t, level_colors, level)
        want = viz_jax.render_sampling_points(_frame(5), loc, att, q, t, level_colors, level)
        assert np.array_equal(got, want) and not np.array_equal(got, _frame(5))


def _sample(seed=3, T=2, N=3, h=40, w=56):
    rs = np.random.RandomState(seed)
    masks = np.zeros((N, T, h, w), np.uint8)
    boxes = np.zeros((N, T, 4), np.float32)
    for n in range(N):
        for t in range(T):
            y0, x0 = rs.randint(0, h // 2), rs.randint(0, w // 2)
            masks[n, t, y0:y0 + 10, x0:x0 + 14] = 1
            boxes[n, t] = [(x0 + 7) / w, (y0 + 5) / h, 14 / w, 10 / h]
    return {"images": rs.randn(T, h, w, 3).astype(np.float32), "labels": np.arange(N) + 4,
            "boxes": boxes, "masks": masks, "valid": rs.rand(N, T) > 0.3}


def test_visualize_dataset_sample_equals_the_jax_one(tmp_path):
    got = viz.visualize_dataset_sample(_sample(), str(tmp_path / "port"), idx=2)
    want = viz_jax.visualize_dataset_sample(_sample(), str(tmp_path / "jax"), idx=2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_save_video_visualization_equals_the_jax_one(tmp_path):
    from types import SimpleNamespace
    names = [f"v/{t:05d}.png" for t in range(3)]
    for t, name in enumerate(names):
        os.makedirs(tmp_path / "img" / "v", exist_ok=True)
        cv2.imwrite(str(tmp_path / "img" / name), _frame(t))
    video = SimpleNamespace(file_names=names + ["v/missing.png"],
                            images_folder=str(tmp_path / "img"), video_id=9)
    m = np.zeros((48, 64), bool)
    m[4:30, 8:50] = True
    results = [{"score": 0.9, "category_id": 2, "segmentations": [rle.encode(m)] * 4},
               {"score": 0.05, "category_id": 1, "segmentations": [rle.encode(~m)] * 4}]
    got = viz.save_video_visualization(video, results, str(tmp_path / "port"), {2: "two"})
    want = viz_jax.save_video_visualization(video, results, str(tmp_path / "jax"), {2: "two"})
    assert len(got) == len(want) == 3
    _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("merge", [False, True], ids=["independent", "merged"])
def test_tracker_renders_equal_the_jax_tracker_s(tmp_path, merge):
    """Both trackers on the fake clip outputs of `tests/test_visualization.py`
    (a square moving right, three clips): the per-clip folders and the final
    tracks, merged on the frames or a folder a track with matches.txt, the
    same files with the same pixels; the tracks are the same."""
    out = {}
    for tag, cls, matcher in (("port", Tracker, HungarianInferenceMatcher),
                              ("jax", JaxTracker, JaxMatcher)):
        viz_cfg = dict(out_viz_path=str(tmp_path / tag), save_clip_viz=True, merge_tracks=merge)
        tracker = cls(_fake_infer, matcher(overlap_window=2, cost_class=1, cost_mask_iou=1,
                                           score_cost=1),
                      TRACKER_CFG, num_frames=6, overlap_window=2, visualization_cfg=viz_cfg)
        out[tag] = tracker(_VizVideo())
    assert out["port"] == out["jax"] and len(out["port"]) == 1
    _same_tree(tmp_path / "port", tmp_path / "jax")
    names = os.listdir(tmp_path / "port" / "vid7")
    assert "clip_results" in names
    assert ("tracks_results" in names) != merge


def test_tracker_renders_nothing_without_a_path(tmp_path, monkeypatch):
    """`TEST.VIZ` unset (the default): no render function is called."""
    called = []
    for name in ("visualize_results_merged", "visualize_tracks_independently",
                 "visualize_clips_after_processing"):
        monkeypatch.setattr(viz, name, lambda *a, **k: called.append(1))
    tracker = Tracker(_fake_infer, HungarianInferenceMatcher(overlap_window=2), TRACKER_CFG,
                      num_frames=6, overlap_window=2,
                      visualization_cfg=dict(save_clip_viz=True, merge_tracks=True))
    assert tracker(_VizVideo()) and called == []


def test_decoder_attention_reads_the_capture_records():
    recs = [dict(loc_c=torch.full((1, 2, 1, 1, 1, 2), float(i)),
                 att_c=torch.full((1, 2, 1, 1, 1), float(i), dtype=torch.bfloat16))
            for i in range(3)]
    loc, att = viz.decoder_attention(recs, layer=1)
    assert loc.dtype == att.dtype == np.float32 and (loc == 1).all() and (att == 1).all()
    assert (viz.decoder_attention(recs)[0] == 2).all()


def _yt21(tmp_path):
    return write_vis_tree(str(tmp_path / "data"), seed=1, n_train=1, n_val=2, n_frames=6,
                          size=(48, 64), version="2021", val_names=VIDEO_NAMES)


def test_visualization_config_runs_through_main(tmp_path):
    """The visualization config's eval-only run through `devis_torch.main`
    on a YouTube-VIS 2021 tree: the two named videos are tracked and each
    frame of both is rendered with the merged tracks (SAVE_MERGED_TRACKS);
    no per-clip renders (SAVE_CLIP_VIZ False)."""
    from devis_torch.main import main
    data = _yt21(tmp_path)
    viz_out = str(tmp_path / "viz")
    res = main(["--config-file", VIZ_CONFIG, "--eval-only", "DATASETS.DATA_PATH", data,
                "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(tmp_path / "out"),
                "TEST.VIZ.OUT_VIZ_PATH", viz_out] + NARROW, device="cpu")
    assert "eval" in res["eval"]
    assert sorted(os.listdir(viz_out)) == sorted(VIDEO_NAMES)
    for name in VIDEO_NAMES:
        files = sorted(os.listdir(os.path.join(viz_out, name)))
        assert files == [f"{t:05d}.png" for t in range(6)]


def test_visualize_att_maps_on_the_cpu(tmp_path, monkeypatch):
    """`visualize_att_maps.main` with `--device cpu` on the same tree: the
    last decoder layer's capture of the current frame, (T, Lq, M, L, P, 2)
    locations and weights that sum with the temporal frames' to one; a
    merged overlay a (query, frame) and one a level with `--per-level`.
    Without a GPU and without `--device cpu` it raises."""
    from devis_torch import visualize_att_maps
    data = _yt21(tmp_path)
    out_dir = str(tmp_path / "maps")
    args = ["--config-file", VIZ_CONFIG, "--videos", "2", "--queries", "2", "--per-level",
            "--out-dir", out_dir, "--device", "cpu", "DATASETS.DATA_PATH", data,
            "MODEL.WEIGHTS", ""] + NARROW
    got = visualize_att_maps.main(args)
    assert len(got) == 2
    for rec in got.values():
        T, Lq, M, L, P, _ = rec["loc"].shape
        assert (T, Lq, M, L, P) == (6, 6, 8, 4, 4) and rec["att"].shape == (T, Lq, M, L, P)
        assert (rec["att"] > 0).all() and (rec["att"].sum((-1, -2)) < 1).all()
        assert len(rec["queries"]) == 2 and len(rec["paths"]) == 2 * T * (1 + L)
        assert all(cv2.imread(p) is not None for p in rec["paths"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        visualize_att_maps.main(["--config-file", VIZ_CONFIG, "DATASETS.DATA_PATH", data,
                                 "MODEL.WEIGHTS", ""] + NARROW)


def test_visualize_dataset_renders_clips_and_images(tmp_path):
    """`visualize_dataset.main` on the YouTube-VIS 2021 tree's training
    videos (a clip of the config's frames a sample) and on a COCO tree (a
    clip of one frame)."""
    from devis_torch import visualize_dataset
    from devis_torch.util.fixtures import write_coco_tree
    data = _yt21(tmp_path)
    got = visualize_dataset.main(["--config-file", VIZ_CONFIG, "--samples", "1", "--out-dir",
                                  str(tmp_path / "clips"), "DATASETS.DATA_PATH", data,
                                  "INPUT.SCALE_FACTOR_TRAIN", "0.25"])
    assert len(got) == 1 and len(got[0]) == 6
    assert all(cv2.imread(p) is not None for p in got[0])
    coco = write_coco_tree(str(tmp_path / "coco"), seed=2, n_train=2, n_val=1,
                           sizes=((48, 64),))
    got = visualize_dataset.main(["--samples", "1", "--out-dir", str(tmp_path / "imgs"),
                                  "DATASETS.TYPE", "coco", "DATASETS.DATA_PATH", coco,
                                  "INPUT.SCALE_FACTOR_TRAIN", "0.25"])
    assert len(got) == 1 and len(got[0]) == 1 and cv2.imread(got[0][0]) is not None
