"""The image model's modules in the PyTorch port against the JAX package on
the CPU, f32: `MSDeformAttn` (against the JAX module on its Pallas route, in
interpret mode), the detector with the image transformer, both branches of
`DeformableDETRSegm`, the image matcher and criterion, the top-k
postprocessing, the mask bit-packing and the nearest resize. Weights are
numpy draws over the JAX parameter tree, carried over with `from_jax_params`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.synthetic import synthetic_image_batch
from devis_torch.util.weights import from_jax_params

from .test_torch_slice import _flatten, random_variables

H, W = 64, 96
NUM_CLASSES = 7               # with the background; the model emits 6 logits
N_SLOTS = 4


def _cfg(get_cfg_defaults, mask_on=True):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "coco"
    cfg.MODEL.MASK_ON = mask_on
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.DROPOUT = 0.0
    cfg.MODEL.NUM_QUERIES = 12
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.TEST.NUM_OUT = 5
    cfg.freeze()
    return cfg


def _batch():
    return synthetic_image_batch(seed=3, canvas=(H, W), valid_hw=(56, 80), n_instances=2,
                                 max_instances=N_SLOTS, num_classes=NUM_CLASSES - 1,
                                 batch=2)


def _close(got, want, what, rel=1e-3):
    # f32 on both sides; summation order and conv algorithms differ
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err)


def make_pair(cfg_fn, mask_on=True, seed=0):
    """(JAX `impl='xla'` twin, its variables, the port's model, same weights)."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jmodel = jax_build(num_classes=NUM_CLASSES, cfg=cfg_fn(jax_cfg, mask_on), impl="xla")
    imgs, pad = jnp.zeros((1, H, W, 3), jnp.float32), jnp.zeros((1, H, W), bool)
    kw = dict(train=False) if mask_on else {}
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), imgs, pad, **kw))
    variables = random_variables(template, seed=seed)
    tmodel = build_model(NUM_CLASSES, cfg_fn(get_cfg_defaults, mask_on), device="cpu")
    tmodel.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def segm():
    return make_pair(_cfg, True)


# ---------------------------------------------------------------------------
# MSDeformAttn
# ---------------------------------------------------------------------------

SHAPES = ((8, 12), (4, 6), (2, 3))
S = sum(h * w for h, w in SHAPES)


@pytest.mark.parametrize("ref_dim,n_queries", [(2, S), (2, 10), (4, 10)])
def test_msdeformattn_matches_jax_pallas_module(monkeypatch, ref_dim, n_queries):
    """2-d references take the projection-fused op on both sides (the JAX
    module must really reach `ms_deform_attn_proj`, hence `_fwd_kernel_proj`),
    4-d references the q-major op; a padding mask zeroes the value."""
    from devis_tpu.models.attention import MSDeformAttn as JaxAttn
    from devis_tpu.ops import ms_deform_attn_pallas as jp
    from devis_torch.models.attention import MSDeformAttn
    from devis_torch.ops import ms_deform_attn_cuda as K
    calls = {"proj": 0}
    real = jp.ms_deform_attn_proj

    def counted(*a, **k):
        calls["proj"] += 1
        return real(*a, **k)
    monkeypatch.setattr(jp, "ms_deform_attn_proj", counted)

    C, M, P, L, B = 64, 4, 2, len(SHAPES), 2
    rs = np.random.RandomState(ref_dim * 100 + n_queries)
    query = rs.randn(B, n_queries, C).astype(np.float32)
    flat = rs.randn(B, S, C).astype(np.float32)
    ref = rs.rand(B, n_queries, L, ref_dim).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] *= 0.5
    pad = np.zeros((B, S), bool)
    pad[1, -20:] = True
    jmod = JaxAttn(d_model=C, n_levels=L, n_heads=M, n_points=P, impl="pallas")
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(flat), SHAPES, jnp.asarray(pad))
    template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = random_variables(template, seed=1)
    calls["proj"] = 0                                    # the init traced it once
    want = jmod.apply(variables, *args)
    assert calls["proj"] == (1 if ref_dim == 2 else 0)

    tmod = MSDeformAttn(C, L, M, P)
    tmod.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    before = (K.msda_proj.plain_calls, K.msda_taps.plain_calls)
    got = tmod(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(flat),
               SHAPES, torch.from_numpy(pad))
    after = (K.msda_proj.plain_calls, K.msda_taps.plain_calls)
    assert after == ((before[0] + 1, before[1]) if ref_dim == 2
                     else (before[0], before[1] + 1))
    _close(got, want, "output", rel=1e-4)


def test_msdeformattn_reset_offsets_is_the_reference_init():
    from devis_tpu.models.attention import sampling_offsets_bias_init as jax_init
    from devis_torch.models.attention import MSDeformAttn
    mod = MSDeformAttn(64, 3, 4, 2)
    mod.reset_offsets()
    np.testing.assert_array_equal(mod.sampling_offsets.bias.detach().numpy(),
                                  jax_init(4, 3, 2))
    assert not mod.sampling_offsets.weight.any() and not mod.attention_weights.weight.any()
    assert not mod.attention_weights.bias.any()


# ---------------------------------------------------------------------------
# detector (image transformer) and segmentation model
# ---------------------------------------------------------------------------

def test_detector_and_image_transformer_match_jax():
    """`build_model` with MASK_ON false gives the detector; batched queries,
    per-image valid ratios, and the 2-d to 4-d reference hand-over."""
    jmodel, variables, tmodel = make_pair(_cfg, mask_on=False, seed=2)
    assert type(tmodel).__name__ == "DeformableDETR"
    b = _batch()
    b["pad_mask"][1, :, 64:] = True                      # the images differ in width
    jout, jint = jax.jit(lambda v, x, m: jmodel.apply(v, x, m))(
        variables, jnp.asarray(b["images"]), jnp.asarray(b["pad_mask"]))
    with torch.no_grad():
        tout, tint = tmodel(torch.from_numpy(b["images"]), torch.from_numpy(b["pad_mask"]))
    assert tint["init_reference"].shape == (2, 12, 2)
    assert tint["inter_references"].shape == (2, 2, 12, 4)
    assert not np.allclose(np.asarray(jint["valid_ratios"])[0], np.asarray(jint["valid_ratios"])[1])
    for k in ("valid_ratios", "init_reference", "inter_references", "hs"):
        _close(tint[k], jint[k], k)
    for lvl, (t, j) in enumerate(zip(tint["memories"], jint["memories"])):
        _close(t, j, f"memory {lvl}")
    for k in ("pred_logits", "pred_boxes"):
        _close(tout[k], jout[k], k)
        _close(tout["aux_outputs"][0][k], jout["aux_outputs"][0][k], "aux " + k)


def test_segm_eval_branch_matches_jax(segm):
    jmodel, variables, tmodel = segm
    b = _batch()
    jout = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
        variables, jnp.asarray(b["images"]), jnp.asarray(b["pad_mask"]))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(b["images"]), torch.from_numpy(b["pad_mask"]))
    jk, tk = jout["top_k"], tout["top_k"]
    scores = np.asarray(jk["scores"])
    assert np.all(np.diff(np.sort(scores, axis=1), axis=1) > 1e-5), "no ties"
    for k in ("labels", "query_top_k_indexes"):
        np.testing.assert_array_equal(tk[k].numpy(), np.asarray(jk[k]), k)
    assert tk["masks"].shape == (2, 5, H // 4, W // 4)
    for k in ("scores", "boxes", "masks"):
        _close(tk[k], jk[k], k)


def test_segm_train_branch_matches_jax(segm):
    """Matched per mask level, masks of the matched embeddings, image-major
    expansion (sample b * N + n)."""
    jmodel, variables, tmodel = segm
    b = _batch()
    targets = {k: jnp.asarray(v) for k, v in b["targets"].items()}
    jout = jax.jit(lambda v, x, m, t: jmodel.apply(v, x, m, targets=t, train=True))(
        variables, jnp.asarray(b["images"]), jnp.asarray(b["pad_mask"]), targets)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(b["images"]), torch.from_numpy(b["pad_mask"]),
                      targets={k: torch.from_numpy(v) for k, v in b["targets"].items()},
                      train=True)
    assert "top_k" not in tout
    valid = b["targets"]["valid"]
    for name, t, j in (("final", tout, jout),
                       ("aux 0", tout["aux_outputs"][0], jout["aux_outputs"][0])):
        np.testing.assert_array_equal(t["indices"].numpy()[valid],
                                      np.asarray(j["indices"])[valid], name)
        assert t["pred_masks"].shape == (2, N_SLOTS, H // 4, W // 4)
        _close(t["pred_masks"][torch.from_numpy(valid)],
               np.asarray(j["pred_masks"])[valid], name + " masks")


# ---------------------------------------------------------------------------
# matcher, criterion, postprocessing
# ---------------------------------------------------------------------------

def _predictions(seed, B=2, Q=12, K=6, N=N_SLOTS):
    rs = np.random.RandomState(seed)
    f = np.float32
    valid = np.zeros((B, N), bool)
    valid[0, :3] = True
    valid[1, :1] = True
    out = {"pred_logits": rs.randn(B, Q, K).astype(f),
           "pred_boxes": rs.uniform(0.2, 0.6, (B, Q, 4)).astype(f)}
    out["aux_outputs"] = [{"pred_logits": rs.randn(B, Q, K).astype(f),
                           "pred_boxes": rs.uniform(0.2, 0.6, (B, Q, 4)).astype(f),
                           "pred_masks": rs.randn(B, N, 8, 12).astype(f)}]
    out["pred_masks"] = rs.randn(B, N, 8, 12).astype(f)
    targets = {"labels": rs.randint(0, K, (B, N)).astype(np.int32),
               "boxes": rs.uniform(0.2, 0.6, (B, N, 4)).astype(f), "valid": valid,
               "masks": (rs.rand(B, N, 16, 24) > 0.5).astype(f)}
    return out, targets


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("focal", [True, False])
def test_hungarian_match_image_gives_the_jax_assignment(focal):
    from devis_tpu.models.matcher import hungarian_match_image as jax_match
    from devis_torch.models.matcher import hungarian_match_image
    out, tg = _predictions(4)
    want = np.asarray(jax_match(jnp.asarray(out["pred_logits"]), jnp.asarray(out["pred_boxes"]),
                                jnp.asarray(tg["labels"]), jnp.asarray(tg["boxes"]),
                                jnp.asarray(tg["valid"]), focal_loss=focal))
    got = hungarian_match_image(
        torch.from_numpy(out["pred_logits"]), torch.from_numpy(out["pred_boxes"]),
        torch.from_numpy(tg["labels"]), torch.from_numpy(tg["boxes"]),
        torch.from_numpy(tg["valid"]), focal_loss=focal).numpy()
    assert got.shape == want.shape == (2, N_SLOTS)
    # an optimal assignment is unique here (continuous costs): equal matches
    # on the valid slots, hence equal total cost; and one query per slot
    np.testing.assert_array_equal(got[tg["valid"]], want[tg["valid"]])
    for b in range(2):
        assert len(set(got[b][tg["valid"][b]])) == tg["valid"][b].sum()


@pytest.mark.parametrize("matched_by_model", [False, True])
def test_image_criterion_matches_jax(matched_by_model):
    from devis_tpu.models.criterion import image_criterion as jax_criterion
    from devis_torch.models.criterion import image_criterion
    out, tg = _predictions(5)
    mcfg = dict(cost_class=2.0, cost_bbox=5.0, cost_giou=2.0, focal_alpha=0.25,
                focal_loss=True)
    if matched_by_model:
        rs = np.random.RandomState(6)
        out["indices"] = np.stack([rs.permutation(12)[:N_SLOTS] for _ in range(2)]).astype(np.int32)
    want = jax_criterion(_tree(out, jnp.asarray), _tree(tg, jnp.asarray), 6, mcfg, 0.25,
                         mask_on=True)
    tout = _tree(out, torch.from_numpy)
    if matched_by_model:
        tout["indices"] = tout["indices"].long()
    got = image_criterion(tout, _tree(tg, torch.from_numpy), mcfg, 0.25, mask_on=True)
    assert set(got) == set(want) and {"loss_mask", "loss_dice", "loss_mask_0",
                                      "loss_ce_0", "class_error"} <= set(got)
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k


def test_top_k_and_postprocess_match_jax():
    from devis_tpu.models.detr import postprocess_detections as jax_post
    from devis_tpu.models.detr import top_k_process as jax_topk
    from devis_torch.models.detr import postprocess_detections, top_k_process
    out, _ = _predictions(7)
    prob = 1 / (1 + np.exp(-out["pred_logits"]))
    want = jax_topk(jnp.asarray(prob), jnp.asarray(out["pred_boxes"]), 9)
    got = top_k_process(torch.from_numpy(prob), torch.from_numpy(out["pred_boxes"]), 9)
    for g, w in zip(got, want):                     # scores, labels, boxes, query_idx
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert top_k_process(torch.from_numpy(prob), torch.from_numpy(out["pred_boxes"]),
                         1000)[0].shape == (2, 72)
    sizes = np.asarray([[480, 640], [300, 500]], np.float32)
    for focal in (True, False):
        want = jax_post({k: jnp.asarray(v) for k, v in out.items() if k.startswith("pred_l")
                         or k == "pred_boxes"}, jnp.asarray(sizes), 5, focal_loss=focal)
        got = postprocess_detections(
            {k: torch.from_numpy(out[k]) for k in ("pred_logits", "pred_boxes")},
            torch.from_numpy(sizes), 5, focal_loss=focal)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_mask_bits_unpack_to_the_jax_masks():
    """Upsample, threshold and pack as the JAX `_fwd` does; `np.unpackbits`
    reads the port's bytes back to the same masks (MSB first)."""
    from devis_tpu.ops.interpolate import resize_bilinear
    from devis_torch.inference import pack_mask_bits
    rs = np.random.RandomState(8)
    logits = rs.randn(2, 3, 16, 24).astype(np.float32)
    Hc, Wc = 64, 96
    up = np.asarray(resize_bilinear(jnp.asarray(logits)[..., None], (Hc, Wc))[..., 0])
    want = up > 0
    weights = np.asarray([128, 64, 32, 16, 8, 4, 2, 1])
    want_bytes = (want.reshape(2, 3, Hc, Wc // 8, 8) * weights).sum(-1).astype(np.uint8)
    packed = pack_mask_bits(torch.from_numpy(logits), (Hc, Wc))
    assert packed.dtype == torch.uint8 and packed.shape == (2 * 3 * Hc * Wc // 8,)
    got = np.unpackbits(packed.numpy().reshape(2, 3, Hc, Wc // 8), axis=-1).astype(bool)
    # a logit within f32 rounding of 0 may fall on either side
    differ = got != want
    assert differ.mean() < 1e-4 and np.abs(up[differ]).max(initial=0.0) < 1e-5
    assert (packed.numpy().reshape(want_bytes.shape) != want_bytes).mean() < 1e-3
    with pytest.raises(ValueError, match="multiple of 8"):
        pack_mask_bits(torch.from_numpy(logits), (64, 100))


# (source, destination) shapes. The last four are where floor(dst * in / out)
# picks another source row or column than OpenCV: two COCO-like sizes resized
# by the 800/1333 rule, and two small ones found by a scan.
NEAREST_CASES = [((56, 80), (120, 200)), ((56, 80), (56, 80)), ((56, 80), (31, 47)),
                 ((56, 80), (7, 5)), ((454, 1332), (218, 640)), ((1332, 504), (640, 242)),
                 ((21, 22), (27, 18)), ((24, 20), (34, 52))]


@pytest.mark.parametrize("size", NEAREST_CASES)
def test_numpy_nearest_resize_is_cv2_inter_nearest(size):
    cv2 = pytest.importorskip("cv2")
    from devis_torch.inference import resize_nearest_numpy
    src, dst = size
    mask = (np.random.RandomState(9).rand(*src) > 0.5).astype(np.uint8)
    want = cv2.resize(mask, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest_numpy(mask, dst), want)
