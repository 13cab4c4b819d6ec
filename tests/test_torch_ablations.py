"""The paper's ablation variants in the PyTorch port against the JAX package
on the CPU: the plain-conv mask head and VisTR's 3-d conv head (f32 to 1e-5
of max|ref|, bf16 to 2e-2), the transformer without temporal connections
(``devis_ablation``, 1e-4), the spatio-temporal sine encoding (1e-6), the
temporal kernels' geometry limits, the checkpoint names of the new modules
and of shared heads, the image model with shared heads and with
reference-point refinement (eval to 1e-3), and tiny DeVIS models of
ablations 0 and 1 at 18 frames (the rule "all" at W = 17, past the 16
offsets a window rule may hold): eval outputs to 1e-3 of max|ref|, one train
step's losses to 1e-3 and each gradient to 1e-2 of its norm. Ablations 2,
2-5, 3 and 4 run the same checks in `test_torch_ablation_single_scale.py`
and `test_torch_ablation_four_levels.py`.

Weights are numpy draws over the JAX `impl='xla'` twin's parameter tree,
carried to the port with `from_jax_params` and loaded strictly. The models
are 128 wide: the mask head's group norms take 8 groups of the /16 width.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.synthetic import synthetic_clip_batch
from devis_torch.util.weights import from_jax_params

from .test_torch_slice import _flatten, random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATIONS = "configs/devis/ablations"
CONFIGS = {
    "0": "devis_ablation0_deformable_vistr.yaml",
    "1": "devis_ablation1_deformable_vistr_wo_temp_conn.yaml",
    "2": "devis_ablation2_single-scale.yaml",
    "2-5": "devis_ablation2-5_single-scale_wo_temp_conn.yaml",
    "3": "devis_ablation3_increased-spatial-inputs.yaml",
    "4": "devis_ablation4_instance-aware.yaml",
}
H, W = 64, 96                 # canvas; the clip's frames are 56x80
NUM_CLASSES = 7               # with the background; the model emits 6 logits
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, what, rel):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err, np.abs(want).max())


def _to_port(variables):
    return from_jax_params(_flatten(variables))


# ---------------------------------------------------------------------------
# the mask heads
# ---------------------------------------------------------------------------

DIM, FPN_DIMS, NHEADS = 64, (24, 16), 8
HW0 = (3, 5)                  # the coarsest map; the others double it


def _head_inputs(B, expand, num_att_levels, seed=0):
    rs = np.random.RandomState(seed)
    feats = [rs.randn(B, HW0[0] * 2 ** i, HW0[1] * 2 ** i, c).astype(np.float32)
             for i, c in enumerate((DIM,) + FPN_DIMS)]
    masks = [rs.rand(B * expand, NHEADS, HW0[0] * 2 ** i, HW0[1] * 2 ** i).astype(np.float32)
             for i in range(num_att_levels)]
    return feats, masks


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("num_att_levels,out_layer,expand_mode",
                         [(1, True, "tile"), (2, False, "tile"), (2, True, "repeat")])
def test_plain_conv_mask_head_matches_jax(dtype, rel, num_att_levels, out_layer, expand_mode):
    """`MaskHeadConv` with plain 3x3 convs (`USE_MDC: False`): the port's
    channel-first spine against the JAX NHWC one, with one or two attention
    levels, with and without the output layer, both expand modes."""
    from devis_tpu.models.segmentation import MaskHeadConv as JaxHead
    from devis_torch.models.segmentation import MaskHeadConv
    B, expand = 2, 3
    feats, masks = _head_inputs(B, expand, num_att_levels)
    jhead = JaxHead(DIM, FPN_DIMS, NHEADS, use_deformable_conv=False,
                    num_att_levels=num_att_levels, out_layer=out_layer,
                    expand_mode=expand_mode, impl="xla", dtype=getattr(jnp, dtype))
    jfeats = [jnp.asarray(f) for f in feats]
    jmasks = [jnp.asarray(m) for m in masks]
    template = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jfeats, jmasks, expand))
    variables = random_variables(template, seed=1)
    want = jhead.apply(variables, jfeats, jmasks, expand)
    head = MaskHeadConv(DIM, FPN_DIMS, NHEADS, num_att_levels, dtype=getattr(torch, dtype),
                        expand_mode=expand_mode, use_deformable_conv=False,
                        out_layer=out_layer)
    head.load_state_dict(_to_port(variables), strict=True)
    assert {"lay1.weight", "lay1.bias", "gn1.weight", "adapter1.weight"} <= \
        set(head.state_dict())
    assert ("out_lay.weight" in head.state_dict()) == out_layer
    with torch.no_grad():
        got = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
                   [torch.from_numpy(m) for m in masks], expand)
    assert got.dtype == getattr(torch, dtype)
    _close(got.permute(0, 2, 3, 1), np.asarray(want.astype(jnp.float32)), "mask head", rel)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_conv3d_head_matches_jax(dtype, rel):
    """`Conv3DHead` on (N, C, T, h, w) against the JAX module on
    (N, T, h, w, C): dilated 3x3x3 convs across the frames too."""
    from devis_tpu.models.devis_model import Conv3DHead as JaxHead3D
    from devis_torch.models.devis_model import Conv3DHead
    N, T, h, w, C = 2, 5, 6, 7, 8
    x = np.random.RandomState(2).randn(N, T, h, w, C).astype(np.float32)
    jhead = JaxHead3D(dtype=getattr(jnp, dtype))
    template = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_variables(template, seed=3)
    want = jhead.apply(variables, jnp.asarray(x))[..., 0]
    head = Conv3DHead(C, dtype=getattr(torch, dtype))
    state = _to_port(variables)
    # the 3-d kernels transpose (D, H, W, I, O) -> (O, I, D, H, W)
    k = np.asarray(variables["params"]["conv1"]["kernel"])
    np.testing.assert_array_equal(state["conv1.weight"].numpy(), k.transpose(4, 3, 0, 1, 2))
    head.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    _close(got, np.asarray(want.astype(jnp.float32)), "3-d conv head", rel)


# ---------------------------------------------------------------------------
# the transformer without temporal connections
# ---------------------------------------------------------------------------

def _box_heads(C, n_layers, seed=4):
    """Fixed linear box heads, the same numbers on both sides."""
    rs = np.random.RandomState(seed)
    mats = [(0.3 * rs.randn(C, 4) / np.sqrt(C)).astype(np.float32) for _ in range(n_layers)]
    return ([lambda x, m=m: x @ jnp.asarray(m) for m in mats],
            [lambda x, m=m: x @ torch.from_numpy(m) for m in mats])


@pytest.mark.parametrize("n_levels", [1, 2])
@pytest.mark.parametrize("refine", [False, True])
def test_devis_ablation_transformer_matches_jax(n_levels, refine):
    """Encoder frame by frame, decoder queries of frame t on frame t's
    memory: hs, references and memories to 1e-4 of max|ref| in f32; with
    box refinement the decoder's later layers take 4-d references (the
    q-major op)."""
    from devis_tpu.models.transformer import DeformableTransformer as JaxTransformer
    from devis_torch.models.transformer import DeformableTransformer
    T, C, Lq = 4, 32, 3
    shapes = ((6, 8), (3, 4))[:n_levels]
    rs = np.random.RandomState(5)
    srcs = [rs.randn(T, h, w, C).astype(np.float32) for h, w in shapes]
    pos = [rs.randn(T, h, w, C).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:
        m = np.zeros((T, h, w), bool)
        m[:, :, w - 1:] = True                         # the last column is padding
        masks.append(m)
    query = rs.randn(T * Lq, 2 * C).astype(np.float32)
    kw = dict(d_model=C, n_heads=8, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=48, dropout=0.0, num_feature_levels=n_levels,
              num_frames=T, variant="devis_ablation")
    jt = JaxTransformer(impl="xla", **kw)
    jbox, tbox = _box_heads(C, 2) if refine else (None, None)
    jargs = ([jnp.asarray(s) for s in srcs], [jnp.asarray(m) for m in masks],
             [jnp.asarray(p) for p in pos], jnp.asarray(query))
    template = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), *jargs, bbox_embed=jbox))
    variables = random_variables(template, seed=6)
    want = jt.apply(variables, *jargs, bbox_embed=jbox)
    tt = DeformableTransformer(**kw)
    tt.load_state_dict(_to_port(variables), strict=True)
    with torch.no_grad():
        got = tt([torch.from_numpy(s).permute(0, 3, 1, 2) for s in srcs],
                 [torch.from_numpy(m) for m in masks], [torch.from_numpy(p) for p in pos],
                 torch.from_numpy(query), tbox)
    assert got["hs"].shape == (2, 1, T * Lq, C)
    for key in ("hs", "inter_references", "init_reference"):
        _close(got[key], want[key], key, 1e-4)
    for lvl, mem in enumerate(want["memories"]):
        _close(got["memories"][lvl], mem, f"memory {lvl}", 1e-4)
    assert (got["inter_references"].shape[-1] == 4) == refine


# ---------------------------------------------------------------------------
# the spatio-temporal sine encoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_spatial_temporal_sine_matches_jax(padded):
    from devis_tpu.models.position_encoding import \
        PositionEmbeddingSpatialTemporalSine as JaxSine
    from devis_torch.models.position_encoding import PositionEmbeddingSpatialTemporalSine
    T, h, w = 5, 7, 9
    mask = np.zeros((T, h, w), bool)
    if padded:
        mask[:, 5:] = True
        mask[:, :, 6:] = True
    want = JaxSine(num_pos_feats=84, num_frames=T).apply({}, jnp.asarray(mask))
    got = PositionEmbeddingSpatialTemporalSine(84, T)(torch.from_numpy(mask))
    assert got.shape == (T, h, w, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_sine_branch_asserts_hidden_dim_252_as_the_jax_package():
    """Both `build_model`s take the sine encoding only at HIDDEN_DIM 252;
    the encoding then gives 256 channels, so no model is built through it
    (ROADMAP C)."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_torch.models.position_encoding import PositionEmbeddingSpatialTemporalSine
    for get, build in ((jax_cfg, lambda c: jax_build(41, c, impl="xla")),
                       (get_cfg_defaults, lambda c: build_model(41, c, device="cpu"))):
        cfg = get()
        cfg.DATASETS.TYPE = "vis"
        cfg.MODEL.DEVIS.TEMPORAL_EMBEDDING = "sine"
        with pytest.raises(AssertionError):
            build(cfg)
    from devis_torch.models import build_position_encoding
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.DEVIS.TEMPORAL_EMBEDDING = "sine"
    cfg.MODEL.HIDDEN_DIM = 252
    enc = build_position_encoding(cfg)
    assert isinstance(enc, PositionEmbeddingSpatialTemporalSine)
    assert enc(torch.zeros(6, 2, 3, dtype=torch.bool)).shape[-1] == 256 != 252


# ---------------------------------------------------------------------------
# the temporal kernels' geometry
# ---------------------------------------------------------------------------

def test_check_geometry_takes_the_all_rule_past_16_frames():
    """K1, K3 and K5 take the rule "all" at W = 35 (ablation 0's 36 frames
    at one level: 36 stages); a window rule still holds at most 16 offsets,
    and K1's header at most K1_MAX_LF stages (1 + W) * L. The Python limits
    are the C source's."""
    from devis_torch.ops import _build
    from devis_torch.ops import ms_deform_attn_cuda as K
    one = ((10, 18),)
    K._check_geometry("k1", one, 32, 35, ("all",), stages=True)
    K._check_geometry("k3", one, 32, 35, ("all",))
    K._check_geometry("k5", ((48, 80),) * 4, 32, 35, ("all",))   # 144 stages
    K._check_geometry("k1", ((48, 80),) * 4, 32, 16, ("window", tuple(range(1, 17))),
                      stages=True)
    with pytest.raises(ValueError, match="at most 16 offsets"):
        K._check_geometry("k3", one, 32, 17, ("window", tuple(range(1, 18))))
    with pytest.raises(ValueError, match="stages"):
        K._check_geometry("k1", ((6, 10),) * 8, 32, 35, ("all",), stages=True)  # 288
    with pytest.raises(ValueError, match="stages"):
        K._check_geometry("k2", ((6, 10),) * 16, 0, 17, stages=True)          # 288
    K._check_geometry("k1", ((6, 10),) * 16, 32, 16, ("all",), stages=True)   # 272
    with pytest.raises(ValueError, match="head dim"):
        K._check_geometry("k1", one, 33, 1)
    src = open(os.path.join(ROOT, "devis_torch", "csrc", "msda_common.cuh")).read()
    assert f"#define MAX_LEVELS {K._MAX_LEVELS}\n" in src
    assert _build.source_define("ms_deform_attn", "MAX_WINDOW") == K._MAX_WINDOW
    cu = open(os.path.join(ROOT, "devis_torch", "csrc", "ms_deform_attn.cu")).read()
    assert "#define K1_MAX_LF ((1 + MAX_WINDOW) * MAX_LEVELS)" in cu
    assert "#define K1_HEAD_BYTES (2 * K1_QB * 4 + 3 * K1_MAX_LF * 4)" in cu
    assert K.K1_HEAD_BYTES == 2 * K.Q_BLOCK * 4 + 3 * K.K1_MAX_STAGES * 4
    assert K.K1_MAX_STAGES == 272


def test_wrappers_run_the_plain_versions_at_36_frames_on_the_cpu():
    """On CPU tensors the wrappers of K1, K2, K3 and K5 take their plain
    versions at ablation 0's geometry (T 36, L 1, the rule "all"), and the
    windowed plain K1 on the plain K2's windows equals the plain K1: every
    tap lies in its window."""
    from devis_torch.ops import ms_deform_attn_cuda as K
    T, Q, M, D, P, shapes = 36, 12, 2, 4, 2, ((3, 4),)
    g = torch.Generator().manual_seed(7)
    value = torch.randn(T, 12, M, D, generator=g)
    ref = torch.rand(T, Q, 1, 2, generator=g)
    c_off = torch.randn(T, Q, M * P * 2, generator=g)
    t_off = torch.randn(T, Q, M * 35 * P * 2, generator=g)
    c_logit = torch.randn(T, Q, M * P, generator=g)
    t_logit = torch.randn(T, Q, M * 35 * P, generator=g)
    args = (value, shapes, ref, c_off, t_off, c_logit, t_logit, ("all",))
    out = K.msda_temporal_proj(*args)
    win = K.msda_tap_window(shapes, ref, c_off, t_off, M)
    assert win.shape == (T, M, 1, 36, 2)
    got, reads = K.msda_temporal_proj_windowed_plain(*args, win, (12,))
    assert reads.tolist() == [0, 0]
    torch.testing.assert_close(got, out, rtol=0, atol=1e-5)
    loc = K.temporal_proj_locations(shapes, ref, c_off, t_off, M)
    att = K.temporal_proj_weights(c_logit, t_logit, M, 1)
    torch.testing.assert_close(K.msda_temporal(value, shapes, loc, att), out, rtol=0,
                               atol=1e-5)
    grad = torch.randn(T, Q, M * D, generator=g)
    gv, gl, ga = K.msda_temporal_bwd(value, shapes, loc, att, grad)
    wv, wl, wa, _ = K.msda_temporal_bwd_windowed_plain(value, shapes, loc, att, grad)
    for a, b in ((gv, wv), (gl, wl), (ga, wa)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# tiny DeVIS models of the ablations
# ---------------------------------------------------------------------------

def ablation_cfg(get_cfg_defaults, key, n_frames):
    """The ablation's config file as it is, cut to a tiny size: width 128,
    FFN 64, 2 + 2 layers, `n_frames` frames of 4 queries, dropout off."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, ABLATIONS, CONFIGS[key]))
    cfg.merge_from_list(["MODEL.HIDDEN_DIM", 128, "MODEL.DIM_FEEDFORWARD", 64,
                         "MODEL.TRANSFORMER.ENCODER_LAYERS", 2,
                         "MODEL.TRANSFORMER.DECODER_LAYERS", 2,
                         "MODEL.DEVIS.NUM_FRAMES", n_frames, "MODEL.NUM_QUERIES", 4 * n_frames,
                         "MODEL.DROPOUT", 0.0, "SOLVER.STEPS", [1]])
    cfg.freeze()
    return cfg


def clip_batch(n_frames):
    return synthetic_clip_batch(seed=3, num_frames=n_frames, canvas=(H, W), valid_hw=(56, 80),
                                n_instances=2, max_instances=3, num_classes=NUM_CLASSES - 1)


def make_ablation_pair(key, n_frames):
    """(JAX `impl='xla'` twin, its variables, the port's model, the batch)."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    jmodel = jax_build(num_classes=NUM_CLASSES, cfg=ablation_cfg(jax_cfg, key, n_frames),
                       impl="xla")
    batch = clip_batch(n_frames)
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"][0]),
        jnp.asarray(batch["pad_mask"][0]), train=False))
    variables = random_variables(template, seed=0)
    tmodel = build_model(NUM_CLASSES, ablation_cfg(get_cfg_defaults, key, n_frames),
                         device="cpu")
    tmodel.load_state_dict(_to_port(variables), strict=True)
    return jmodel, variables, tmodel, batch


def check_eval(pair):
    """The clip forward at eval against the JAX twin: logits, boxes and the
    top-k results (scores, boxes, masks) to 1e-3 of max|ref|."""
    jmodel, variables, tmodel, batch = pair
    images, pad = batch["images"][0], batch["pad_mask"][0]
    jout, jres = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
        variables, jnp.asarray(images), jnp.asarray(pad))
    with torch.no_grad():
        tout, tres = tmodel(torch.from_numpy(images), torch.from_numpy(pad))
    _close(tout["pred_logits"], jout["pred_logits"], "pred_logits", 1e-3)
    _close(tout["pred_boxes"], jout["pred_boxes"], "pred_boxes", 1e-3)
    for k in ("labels", "query_top_k_indexes", "mask_gather"):
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]), k)
    for k in ("scores", "boxes", "masks"):
        _close(tres[k], jres[k], k, 1e-3)
    return tres


def check_train_step(pair, key, n_frames):
    """One train step against `jax.value_and_grad` of the JAX clip loss:
    every loss to 1e-3 of its value, each parameter's clipped gradient to
    1e-2 of its norm (f32 on both sides through 50 convolutions and group
    norms over a handful of pixels)."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import matcher_cfg_from
    from devis_tpu.models.criterion import build_weight_dict, clip_criterion, weighted_total
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import create_train_state, make_train_step
    jmodel, variables, tmodel, batch = pair
    jc = ablation_cfg(jax_cfg, key, n_frames)
    weight_dict, mcfg = build_weight_dict(jc), matcher_cfg_from(jc, clip=True)
    frozen = {k: v for k, v in variables.items() if k != "params"}
    images, pad = jnp.asarray(batch["images"][0]), jnp.asarray(batch["pad_mask"][0])
    targets = jax.tree.map(lambda x: jnp.asarray(x[0]), batch["targets"])

    def loss_fn(params):
        out = jmodel.apply({"params": params, **frozen}, images, pad, targets=targets,
                           train=True, deterministic=True)
        losses = clip_criterion(out, targets, NUM_CLASSES - 1, n_frames, mcfg,
                                jc.MODEL.LOSS.FOCAL_ALPHA, mask_on=True)
        return weighted_total(losses, weight_dict), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    cfg = ablation_cfg(get_cfg_defaults, key, n_frames)
    state = create_train_state(cfg, tmodel, STEPS_PER_EPOCH)
    _, metrics = make_train_step(tmodel, cfg)(state, batch)
    assert float(metrics["finite"]) == 1.0
    assert float(metrics["loss"]) == pytest.approx(float(jtotal), rel=1e-3)
    assert set(jlosses) | {"loss", "grad_norm", "finite"} == set(metrics)
    for k, v in jlosses.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-3, abs=1e-5), k
    want = from_jax_params(_flatten({"params": jgrads}))
    params = dict(tmodel.named_parameters())
    assert sorted(params) == sorted(want)
    jnorm = float(np.sqrt(sum(float(g.double().square().sum()) for g in want.values())))
    assert float(metrics["grad_norm"]) == pytest.approx(jnorm, rel=1e-3)
    scale = min(1.0, cfg.SOLVER.GRAD_CLIP_MAX_NORM / jnorm)
    for name, p in params.items():
        w = want[name] * scale
        err = float((p.grad - w).norm())
        assert err <= 1e-2 * float(w.norm()) + 1e-6 * cfg.SOLVER.GRAD_CLIP_MAX_NORM, name


_PAIRS = {}


def ablation_pair(key, n_frames):
    """The pair of the ablation the tests use now; one at a time is kept,
    and the tests of one ablation run one after another."""
    if key not in _PAIRS:
        _PAIRS.clear()
        _PAIRS[key] = make_ablation_pair(key, n_frames)
    return _PAIRS[key]


def test_ablation0_names_are_the_checkpoint_maps():
    """The port's state_dict names for ablation 0 are those
    `devis_tpu/util/checkpoint.py` gives the JAX twin (plus the decoder's
    packed self-attention, which that map skips), with equal shapes, and
    the map's torch -> flax direction takes the port's weights back to the
    JAX variables by value (the 3-d conv's (2, 3, 4, 1, 0) transpose
    among them)."""
    from devis_tpu.util.checkpoint import flax_variables_to_torch_keys, torch_to_flax_variables
    _, variables, tmodel, _ = ablation_pair("0", 18)
    state = tmodel.state_dict()
    keys = flax_variables_to_torch_keys(variables)
    packed = {k for k in state if ".decoder.layers." in k and ".self_attn." in k}
    assert set(state) == set(keys) | packed
    for k, shape in keys.items():
        # the map gives a 3-d conv kernel's shape in flax's (D, H, W, I, O)
        got = state[k].permute(2, 3, 4, 1, 0) if state[k].dim() == 5 else state[k]
        assert tuple(got.shape) == shape, k
    assert {"conv_head_3d.conv0.weight", "conv_head_3d.gn2.bias", "conv_head_3d.out.weight",
            "mask_head.lay1.weight", "mask_head.lay5.bias"} <= set(keys)
    assert state["conv_head_3d.conv0.weight"].dim() == 5
    back, missing, unused = torch_to_flax_variables(
        {k: v.numpy() for k, v in state.items()}, variables)
    assert missing == [] and unused == []
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), str(path))


@pytest.mark.parametrize("key,check", [(k, c) for k in ("0", "1") for c in ("eval", "step")])
def test_ablation_matches_jax_at_18_frames(key, check):
    """Ablation 0 (temporal attention over 17 other frames, one level, not
    instance-aware, plain-conv + 3-d head) and ablation 1 (the same without
    temporal connections) at 18 frames: eval, then one train step."""
    pair = ablation_pair(key, 18)
    if check == "step":
        check_train_step(pair, key, 18)
        return
    tmodel = pair[2]
    assert tmodel.def_detr.transformer.variant == ("devis" if key == "0" else "devis_ablation")
    assert tmodel.conv_head_3d is not None and tmodel.mask_head.out_lay is None
    res = check_eval(pair)
    assert res["masks"].shape[:2] == (4, 18)


# ---------------------------------------------------------------------------
# the image model with shared heads and with reference-point refinement
# ---------------------------------------------------------------------------

def _coco_cfg(get_cfg_defaults, ref_point):
    from .test_torch_coco_modules import _cfg
    cfg = _cfg(get_cfg_defaults, True)
    cfg.defrost()
    cfg.MODEL.WITH_BBX_REFINE = False
    cfg.MODEL.WITH_REF_POINT_REFINE = ref_point
    cfg.MODEL.MASK_HEAD.USE_MDC = False
    cfg.freeze()
    return cfg


@pytest.mark.parametrize("ref_point", [False, True])
def test_image_model_with_shared_heads_matches_jax(ref_point):
    """`WITH_BBX_REFINE: False`: one class head and one box head at every
    decoder level (the same module, so `class_embed.0` ... `class_embed.{n-1}`
    name one tensor, as the reference `state_dict` does); with
    `WITH_REF_POINT_REFINE` the per-layer reference-point heads move the
    references. The plain-conv mask head. Eval outputs to 1e-3 of
    max|ref|; the names are the checkpoint map's for the JAX twin."""
    from devis_tpu.util.checkpoint import flax_variables_to_torch_keys
    from .test_torch_coco_modules import H as CH, W as CW, make_pair
    jmodel, variables, tmodel = make_pair(lambda get, _: _coco_cfg(get, ref_point), True,
                                          seed=2)
    detr = tmodel.def_detr
    assert detr.class_embed[0] is detr.class_embed[1] and detr.bbox_embed[0] is detr.bbox_embed[1]
    state = tmodel.state_dict()
    assert state["def_detr.class_embed.1.weight"].data_ptr() == \
        state["def_detr.class_embed.0.weight"].data_ptr()
    keys = flax_variables_to_torch_keys(variables)
    packed = {k for k in state if ".decoder.layers." in k and ".self_attn." in k}
    shared = {k for k in state if k.startswith(("def_detr.class_embed.1.",
                                                "def_detr.bbox_embed.1."))}
    assert set(state) == set(keys) | packed | shared
    assert ("def_detr.ref_point_embed.1.layers.2.weight" in keys) == ref_point
    rs = np.random.RandomState(8)
    x = rs.randn(2, CH, CW, 3).astype(np.float32)
    pad = np.zeros((2, CH, CW), bool)
    pad[1, 50:] = True
    jout = jax.jit(lambda v, a, m: jmodel.apply(v, a, m, train=False))(
        variables, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x), torch.from_numpy(pad))
    _close(tout["pred_logits"], jout["pred_logits"], "pred_logits", 1e-3)
    _close(tout["pred_boxes"], jout["pred_boxes"], "pred_boxes", 1e-3)
    for lvl, (a, b) in enumerate(zip(tout["aux_outputs"], jout["aux_outputs"])):
        _close(a["pred_boxes"], b["pred_boxes"], f"aux boxes {lvl}", 1e-3)
    for k in ("scores", "boxes", "masks"):
        _close(tout["top_k"][k], jout["top_k"][k], k, 1e-3)
