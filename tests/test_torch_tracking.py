"""The port's tracking slice (video in, tracks and TrackMAP out) against the
JAX package, on the CPU: the RLE codec (C and numpy) and its string form,
OpenCV's bilinear resizes without OpenCV (`SmallMask.to_rle`, the frames),
the synthetic videos and their ground truth, the two trackers fed the same
clip outputs, TrackMAP, and the whole slice (`build_tracker` +
`inference_vis`) with one model's weights in both packages.
"""
import cv2
import ml_dtypes
import numpy as np
import pytest
import torch

from devis_torch.datasets import transforms as T_port
from devis_torch.datasets.synthetic import SyntheticVISValDataset
from devis_torch.evaluation import rle
from devis_torch.evaluation import track_map
from devis_torch.tracking import track as track_port
from devis_torch.tracking.inference_matcher import HungarianInferenceMatcher
from devis_torch.tracking.tracker import Tracker
from devis_tpu.datasets import synthetic as synthetic_jax
from devis_tpu.datasets import transforms as T_jax
from devis_tpu.evaluation import rle as rle_jax
from devis_tpu.evaluation import track_map as track_map_jax
from devis_tpu.tracking import track as track_jax
from devis_tpu.tracking.inference_matcher import \
    HungarianInferenceMatcher as JaxMatcher
from devis_tpu.tracking.tracker import Tracker as JaxTracker

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# size pairs (h, w) -> (oh, ow) the mask resize is held at: the two e2e
# corpus shapes, then seeded up- and downscales, odd sizes among them
SIZE_PAIRS = [((90, 160), (360, 640)), ((120, 80), (480, 320)), ((45, 80), (360, 640)),
              ((135, 90), (480, 320)), ((64, 64), (32, 32)), ((33, 47), (33, 47))]
_rs = np.random.RandomState(11)
while len(SIZE_PAIRS) < 60:
    h, w = (int(v) for v in _rs.randint(2, 140, size=2))
    if len(SIZE_PAIRS) % 2:                      # downscale
        oh, ow = int(_rs.randint(1, h + 1)), int(_rs.randint(1, w + 1))
    else:
        oh, ow = int(_rs.randint(h, 4 * h + 1)), int(_rs.randint(w, 4 * w + 1))
    SIZE_PAIRS.append(((h, w), (oh, ow)))


def _masks(seed):
    rs = np.random.RandomState(seed)
    out = [np.zeros((5, 7), bool), np.ones((5, 7), bool), np.ones((1, 1), bool),
           np.zeros((0, 4), bool)]
    for _ in range(12):
        h, w = (int(v) for v in rs.randint(1, 60, size=2))
        out.append(rs.rand(h, w) > rs.uniform(0.2, 0.9))
    blob = np.zeros((40, 50), bool)
    blob[8:30, 10:44] = True
    out.append(blob)
    return out


def test_rle_codec_matches_numpy_and_the_jax_package():
    """Strings, decode, area and counts: the C codec, its plain numpy
    version and the JAX package give the same."""
    for m in _masks(0):
        c, p, j = rle.encode(m), rle.encode_plain(m), rle_jax.encode(m)
        assert c == p == j
        np.testing.assert_array_equal(rle.decode(c), m.astype(np.uint8))
        np.testing.assert_array_equal(rle.decode_plain(c), m.astype(np.uint8))
        assert rle.area(c) == rle.area_plain(c) == rle_jax.area(j) == int(m.sum())
        assert rle.counts_of(c).tolist() == rle.string_to_counts_plain(c["counts"]) \
            == list(rle_jax._ensure_counts(j))
        assert rle.counts_to_string_plain(rle.counts_plain(c)) == c["counts"]


def test_rle_iou_intersection_and_merge_match():
    rs = np.random.RandomState(1)
    shape = (23, 31)
    masks = [rs.rand(*shape) > rs.uniform(0.3, 0.8) for _ in range(7)]
    masks.append(np.zeros(shape, bool))
    enc = [rle.encode(m) for m in masks]
    dt, gt = enc[:4], enc[4:]
    crowd = [False, True, False, True]
    got = rle.iou(dt, gt, crowd)
    np.testing.assert_allclose(got, rle.iou_plain(dt, gt, crowd), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, rle_jax.iou(dt, gt, crowd), rtol=0, atol=1e-12)
    assert rle.iou([], gt).shape == (0, 4)
    for a, b in zip(enc, enc[1:]):
        want = rle_jax.intersection(a, b)
        assert rle.intersection(a, b) == rle.intersection_plain(a, b) == want
        for inter in (False, True):
            assert rle.merge([a, b], intersect=inter) == rle_jax.merge([a, b], intersect=inter)


def _f8_logits(rs, shape):
    """float8 e4m3 logits as the two packages hold them, from the same
    bytes: an ml_dtypes array (JAX) and a torch float8_e4m3fn tensor."""
    f8 = (rs.randn(*shape) * 3).astype(np.float32).astype(ml_dtypes.float8_e4m3fn)
    bits = f8.view(np.uint8)
    return f8, torch.from_numpy(bits.copy()).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("chunk", range(3))
def test_small_mask_rle_equals_the_jax_package(chunk):
    """`SmallMask.to_rle` (OpenCV's bilinear resize repeated in numpy, then
    logit > 0) gives the JAX package's RLE strings (cv2) at 60 size pairs."""
    rs = np.random.RandomState(chunk)
    for (h, w), (oh, ow) in SIZE_PAIRS[chunk::3]:
        f8, t8 = _f8_logits(rs, (h, w))
        want = track_jax.SmallMask(f8, (oh, ow)).to_rle()
        assert track_port.SmallMask(t8, (oh, ow)).to_rle() == want, ((h, w), (oh, ow))
        np.testing.assert_array_equal(track_port.SmallMask(t8, (oh, ow)).probs,
                                      track_jax.SmallMask(f8, (oh, ow)).probs)


def test_float_resize_is_bit_exact_against_cv2():
    """The C resize, its numpy version and OpenCV agree bit for bit on 2-d
    sources (and C with numpy on 3 channels)."""
    rs = np.random.RandomState(3)
    for (h, w), (oh, ow) in SIZE_PAIRS:
        x = (rs.randn(h, w) * 4).astype(np.float32)
        want = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(T_port.resize_linear_f32(x, (oh, ow)), want)
        np.testing.assert_array_equal(T_port.resize_linear_f32_plain(x, (oh, ow)), want)
        x3 = (rs.rand(h, w, 3) * 255).astype(np.float32)
        np.testing.assert_array_equal(T_port.resize_linear_f32(x3, (oh, ow)),
                                      T_port.resize_linear_f32_plain(x3, (oh, ow)))


def test_uint8_frame_resize_within_one_grey_level_of_cv2():
    """OpenCV's fixed-point path rounds its scalar tail once where its SIMD
    body rounds twice; the port rounds as the SIMD body everywhere. No pixel
    differs by more than one grey level; a fraction of a percent differ
    (0.23 % over this scan when it was written)."""
    rs = np.random.RandomState(4)
    off = total = 0
    for (h, w), (oh, ow) in SIZE_PAIRS + [((360, 640), (360, 640)), ((480, 320), (540, 360)),
                                         ((720, 1280), (360, 640))]:
        x = rs.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
        d = np.abs(T_port.resize_linear_u8(x, (oh, ow)).astype(int)
                   - cv2.resize(x, (ow, oh), interpolation=cv2.INTER_LINEAR).astype(int))
        assert d.max() <= 1, ((h, w), (oh, ow))
        off += int((d > 0).sum())
        total += d.size
    assert off / total < 0.01, off / total


@pytest.mark.parametrize("hw", [(360, 640), (480, 320), (100, 640), (37, 53)])
def test_val_transform_matches_the_jax_package(hw):
    """The evaluation resize rule and frames within one grey level, for uint8
    frames and for the float frames of the synthetic corpus."""
    rs = np.random.RandomState(5)
    port, jax_t = T_port.ValTransform(360, 640), T_jax.ValTransform(360, 640, normalize=False)
    for frame in (rs.randint(0, 256, size=hw + (3,)).astype(np.uint8),
                  np.round(rs.rand(*hw, 3) * 255).astype(np.float32)):
        got, want = port(frame), jax_t(frame)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert T_port.get_size_with_aspect_ratio(hw, 360, 640) == \
        T_jax.get_size_with_aspect_ratio(hw, 360, 640)


SYN = dict(num_frames=4, stride=2, n_videos=2, video_len=11, sizes=[(40, 56), (52, 36)],
           n_inst=4, min_size=48, max_size=64)


def test_synthetic_videos_and_ground_truth_equal_the_jax_package():
    port, jax_ds = SyntheticVISValDataset(**SYN), synthetic_jax.SyntheticVISValDataset(**SYN)
    assert port.gt_dict() == jax_ds.gt_dict()
    assert port.get_total_num_frames() == jax_ds.get_total_num_frames()
    for vp, vj in zip(port, jax_ds):
        assert (vp.video_clips, vp.last_real_idx, vp.real_video_length, vp.original_size,
                vp.final_video_length, len(vp)) == \
            (vj.video_clips, vj.last_real_idx, vj.real_video_length, vj.original_size,
             vj.final_video_length, len(vj))
        for i in range(len(vp)):
            a, b = vp.load_clip(i), vj.load_clip(i)
            assert a.dtype == np.uint8 and a.shape == b.shape
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_cached_frames_are_the_drawn_frames():
    """`SyntheticVideo.frame` is the JAX package's `render` image, drawn
    without the masks; every frame is drawn once and kept, and a second pass
    loads the same clips from the kept frames."""
    port, jax_ds = SyntheticVISValDataset(**SYN), synthetic_jax.SyntheticVISValDataset(**SYN)
    for vp, vj in zip(port, jax_ds):
        first = [vp.load_clip(i) for i in range(len(vp))]
        video = vp.synthetic_video
        assert sorted(video._frames) == list(range(video.n_frames))
        for t in range(video.n_frames):
            np.testing.assert_array_equal(video.frame(t), vj.synthetic_video.render(t)[0])
        for i in range(len(vp)):
            np.testing.assert_array_equal(vp.load_clip(i), first[i])


# ---------------------------------------------------------------------------
# The two trackers on the same clip outputs
# ---------------------------------------------------------------------------

TRACKER_CFG = dict(per_class_matching=False, track_min_detection_score=0.001,
                   track_min_score=0.002, track_min_detections=1,
                   final_class_policy="most_common", final_score_policy="mean")
NUM_FRAMES, STRIDE, K, NM, STEP = 4, 2, 5, 4, 4
GATHER = np.asarray([0, 1, 2, 3, 1])          # two tracks share mask row 1


def _parse(n_frames):
    """Clips, last_real_idx and real length of an n-frame video, as the
    synthetic dataset parses it."""
    idxs = list(range(n_frames))
    clips = [idxs[:NUM_FRAMES]]
    start, end = STRIDE, STRIDE + NUM_FRAMES
    while end < n_frames:
        clips.append(idxs[start:end])
        start = end - (NUM_FRAMES - STRIDE)
        end = start + NUM_FRAMES
    clips.append(idxs[-NUM_FRAMES:])
    return clips, start - (n_frames - 1 - NUM_FRAMES) - 1


class _FakeVideo:
    """Drifting random blobs, at 44 x 60; clip outputs are made from them."""

    def __init__(self, seed=7, n_frames=13):
        rs = np.random.RandomState(seed)
        self.video_id, self.original_size = 3, (44, 60)
        self.final_video_length, self.real_video_length = n_frames, None
        self.clips_idx, self.last_real_idx = _parse(n_frames)
        self.centres = rs.rand(K, 2) * [44, 60]
        self.speed = rs.randn(K, 2) * 2
        self.cats = rs.randint(1, 4, size=K)

    def __len__(self):
        return len(self.clips_idx)

    def masks(self, t):
        yy, xx = np.mgrid[0:44, 0:60]
        c = self.centres + t * self.speed
        return [((yy - cy) ** 2 + (xx - cx) ** 2 < 80) for cy, cx in c]

    def gt_dict(self):
        anns = []
        for i in range(K):
            segs = [rle_jax.encode(self.masks(t)[i]) for t in range(self.final_video_length)]
            anns.append({"video_id": 3, "category_id": int(self.cats[i]), "iscrowd": 0,
                         "segmentations": [s if rle_jax.area(s) else None for s in segs],
                         "areas": [rle_jax.area(s) or None for s in segs], "id": i})
        return {"videos": [{"id": 3}], "annotations": anns,
                "categories": [{"id": c} for c in range(1, 4)]}


def _clip_outputs(masks_at, cats, clips, seed, size):
    """Seeded clip outputs of the tracker contract from per-frame masks:
    mask logits (NM, T, h/4 + 2, w/4 + 2) at stride 4 with noise, scores,
    labels, boxes. Returns one (jax_dict, port_dict) per clip, the logits
    from the same float8 bytes."""
    rs = np.random.RandomState(seed)
    hv, wv = -(-size[0] // STEP), -(-size[1] // STEP)
    out = []
    for clip in clips:
        logits = np.zeros((NM, NUM_FRAMES, hv + 2, wv + 2), np.float32)
        for t, f in enumerate(clip):
            ms = masks_at(f)
            for r in range(NM):
                small = ms[r % len(ms)][::STEP, ::STEP].astype(np.float32)
                logits[r, t, :hv, :wv] = (small * 2 - 1) * 3 + rs.randn(hv, wv)
        f8 = logits.astype(ml_dtypes.float8_e4m3fn)
        t8 = torch.from_numpy(f8.view(np.uint8).copy()).view(torch.float8_e4m3fn)
        boxes = rs.rand(NUM_FRAMES, K, 4).astype(np.float32) * 0.5 + 0.1
        labels = (np.asarray(cats)[np.arange(K) % len(cats)] - 1).astype(np.int32)
        labels[-1] = rs.randint(0, 3)     # one track changes class: kill and spawn
        common = {"scores": rs.uniform(0.2, 0.9, (NUM_FRAMES, K)).astype(np.float32),
                  "labels": labels,
                  "boxes": boxes, "center_points": boxes[..., :2], "mask_gather": GATHER,
                  "valid_hw": (hv, wv)}
        out.append((dict(common, mask_logits=f8), dict(common, mask_logits=t8)))
    return out


def _videos(kind):
    """(jax video, port video, jax-side gt, port-side gt, per-video outputs)"""
    if kind == "fake":
        v = _FakeVideo()
        outs = _clip_outputs(v.masks, v.cats, v.clips_idx, 0, v.original_size)
        return [(v, v, outs)], v.gt_dict(), v.gt_dict()
    syn = dict(SYN, sizes=[(44, 60), (52, 36)])
    jd, pd = synthetic_jax.SyntheticVISValDataset(**syn), SyntheticVISValDataset(**syn)
    vids = []
    for i, (vj, vp) in enumerate(zip(jd, pd)):
        sv = vj.synthetic_video
        outs = _clip_outputs(lambda f: [m > 0 for m in sv.render(f)[1]],
                             [inst["cat"] for inst in sv.insts], vj.clips_idx, i + 1,
                             vj.original_size)
        vids.append((vj, vp, outs))
    return vids, jd.gt_dict(), pd.gt_dict()


def _with_ids(cls):
    """Track.get_formatted_result with the track's id added."""
    orig = cls.get_formatted_result

    def formatted(self, *a, **k):
        return dict(orig(self, *a, **k), track_id=self.get_id())
    return formatted


@pytest.mark.parametrize("kind", ["fake", "synthetic"])
@pytest.mark.parametrize("per_class", [False, True], ids=["global", "per_class"])
@pytest.mark.parametrize("binary", [False, True], ids=["soft_iou", "binary_iou"])
def test_trackers_agree_on_the_same_clip_outputs(monkeypatch, kind, per_class, binary):
    """Equal track ids, categories and RLE strings, scores to 1e-6, and
    TrackMAP to 1e-9. The costs have no ties (continuous seeded scores and
    masks), where the two assignment solvers could choose differently."""
    monkeypatch.setattr(track_jax.Track, "get_formatted_result", _with_ids(track_jax.Track))
    monkeypatch.setattr(track_port.Track, "get_formatted_result", _with_ids(track_port.Track))
    cfg = dict(TRACKER_CFG, per_class_matching=per_class)
    costs = dict(overlap_window=NUM_FRAMES - STRIDE, cost_class=1, cost_mask_iou=1,
                 score_cost=1, center_distance_cost=1, use_binary_mask_iou=binary)
    vids, gt_j, gt_p = _videos(kind)
    res_j, res_p = [], []
    for vj, vp, outs in vids:
        jt = JaxTracker(lambda v, i: outs[i][0], JaxMatcher(**costs), cfg, NUM_FRAMES,
                        NUM_FRAMES - STRIDE)
        pt = Tracker(lambda v, i: outs[i][1], HungarianInferenceMatcher(**costs), cfg,
                     NUM_FRAMES, NUM_FRAMES - STRIDE)
        res_j += jt(vj)
        res_p += pt(vp)
    assert len(res_p) == len(res_j) > 0
    for p, j in zip(res_p, res_j):
        assert (p["track_id"], p["video_id"], p["category_id"]) == \
            (j["track_id"], j["video_id"], j["category_id"])
        assert p["segmentations"] == j["segmentations"]
        assert abs(p["score"] - j["score"]) <= 1e-6
    e_p, e_j = track_map.evaluate_vis(gt_p, res_p), track_map_jax.evaluate_vis(gt_j, res_j)
    for key in ("AP", "AP50", "AP75", "AR"):
        assert abs(e_p[key] - e_j[key]) <= 1e-9, key
    for key, arr in e_j["per_threshold"].items():
        np.testing.assert_allclose(e_p["per_threshold"][key], arr, rtol=0, atol=1e-9)


def test_matcher_takes_more_video_tracks_than_clip_tracks():
    """scipy's row/column convention with more rows than columns."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    from devis_torch.tracking.inference_matcher import linear_sum_assignment
    rs = np.random.RandomState(6)
    for shape in [(7, 3), (3, 7), (5, 5), (4, 1), (0, 3)]:
        cost = rs.rand(*shape)
        got, want = linear_sum_assignment(cost), scipy_lsa(cost)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_visualization_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 5"):
        Tracker(lambda v, i: None, HungarianInferenceMatcher(), TRACKER_CFG, 4, 2,
                visualization_cfg=dict(out_viz_path="viz"))


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _slice_cfg(get_cfg_defaults):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.BBX_GRADIENT_PROP = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.NUM_QUERIES = 6
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 1
    cfg.MODEL.DEVIS.NUM_FRAMES = 3
    cfg.TEST.NUM_OUT = 4
    cfg.TEST.CLIP_TRACKING.STRIDE = 2
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 64
    cfg.freeze()
    return cfg


def test_inference_vis_matches_the_jax_package(tmp_path):
    """`build_tracker` + `inference_vis` in both packages, f32, the port with
    the JAX twin's weights (`from_jax_params`), on the JAX dataset's videos
    (two canvases): the same tracks and categories, scores to 1e-3, every
    frame's mask IoU >= 0.99, TrackMAP to 1e-3.

    The JAX fetch rounds scores and boxes to f16 (its transfer packing). An
    overlap frame keeps the higher-scoring of two detections, and a seeded
    model's trajectories score nearly alike from clip to clip, so two scores
    that tie in f16 but not in f32 keep different frames. The port's fetched
    scores and boxes are rounded to f16 here too, so that both trackers
    decide on the same numbers; both round mask logits to float8."""
    import jax
    import jax.numpy as jnp

    from devis_torch.config import get_cfg_defaults
    from devis_torch.inference import build_tracker, inference_vis
    from devis_torch.models import build_model
    from devis_torch.util.weights import from_jax_params
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.inference import build_tracker as jax_build_tracker
    from devis_tpu.inference import inference_vis as jax_inference_vis
    from devis_tpu.models import build_model as jax_build

    from .test_torch_slice import _flatten, random_variables

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg, cfg = _slice_cfg(jax_cfg), _slice_cfg(get_cfg_defaults)
    jmodel = jax_build(num_classes=41, cfg=jcfg, impl="xla")
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3)), jnp.zeros((3, 64, 64), bool),
        train=False))
    variables = random_variables(template, seed=3)
    tmodel = build_model(41, cfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    tmodel.eval()

    dataset = synthetic_jax.SyntheticVISValDataset(
        num_frames=3, stride=2, n_videos=2, video_len=7, sizes=[(36, 48), (48, 36)],
        n_inst=3, min_size=48, max_size=64)
    want = jax_inference_vis(jax_build_tracker(jcfg, jmodel, variables), dataset, verbose=False)
    tracker = build_tracker(cfg, tmodel, device="cpu")
    fetch = tracker.infer_fn.fetch

    def fetch_f16(dispatched):
        out = fetch(dispatched)
        for k in ("scores", "boxes", "center_points"):
            out[k] = out[k].astype(np.float16).astype(np.float32)
        return out

    tracker.infer_fn.fetch = fetch_f16
    got = inference_vis(tracker, dataset, verbose=False, output_dir=str(tmp_path))
    assert (tmp_path / "results.json").exists() and (tmp_path / "results.zip").exists()
    assert got["fps"] > 0
    rp, rj = got["results"], want["results"]
    assert len(rp) == len(rj) > 0
    for p, j in zip(rp, rj):
        assert (p["video_id"], p["category_id"]) == (j["video_id"], j["category_id"])
        assert abs(p["score"] - j["score"]) <= 1e-3
        for sp, sj in zip(p["segmentations"], j["segmentations"]):
            assert (sp is None) == (sj is None)
            if sp is not None:
                assert sp["size"] == sj["size"]
                if rle.area(sp) or rle.area(sj):
                    assert rle.iou([sp], [sj])[0, 0] >= 0.99
    for key in ("AP", "AP50", "AP75", "AR"):
        assert abs(got["eval"][key] - want["eval"][key]) <= 1e-3, key
