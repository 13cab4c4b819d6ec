"""Unequal current and temporal point counts (`ENC_N_POINTS_TEMPORAL_FRAME`,
`DEC_N_POINTS_TEMPORAL_FRAME` other than the current frame's) and grouped
heads of the q-major op, in the port against the JAX package, on the CPU:

- the encoder (all frames and a window) and the decoder (instance-aware and
  not, 2-d and 4-d references) temporal modules against the JAX modules
  (`impl='xla'`, the plain route of the same two passes), f32: outputs and
  the gradients of a seeded loss with respect to query and input to 1e-4 of
  max|ref|;
- 20 levels (T = 6, all frames: W * L = 5 * 4) run as level groups of at
  most 16 (`by_level_groups`) equal one plain call to 1e-6 of max|ref|,
  gradients included;
- grouped heads: the plain version against the JAX `ms_deform_attn_pallas`
  with G query heads a value head (interpret mode) to 1e-5, and against
  the plain version on the value heads repeated (the JAX test's
  "replicated" form) exactly;
- a tiny DeVIS model with Pt = 2 (and Pc = 4) at eval against its JAX twin:
  logits, boxes and the top-k to 1e-3 of max|ref|; `capture_sampling`
  records the temporal taps' locations and weights with Pt points;
- `adapt_weights_devis` with Pt = 2 equals the JAX package's, and fills the
  port model's own shapes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.weights import from_jax_params

from .test_torch_modules import _flatten, _random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 12), (4, 6), (2, 3))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
C, M = 64, 4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (what, err, np.abs(want).max())


def _run_pair(jm, tm, query, ref, src, mask):
    """Forward of both modules and the gradients of sum(out * g) with
    respect to query and src."""
    args = tuple(jnp.asarray(a) for a in (query, ref, src))
    variables = _random_variables(jm, *args, SHAPES, jnp.asarray(mask))
    tm.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    g = np.random.RandomState(1).randn(*jax.eval_shape(
        lambda: jm.apply(variables, *args, SHAPES, jnp.asarray(mask))).shape).astype(np.float32)

    def loss(q, s):
        out = jm.apply(variables, q, args[1], s, SHAPES, jnp.asarray(mask))
        return (out * g).sum(), out
    (_, want), (jq, js) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        args[0], args[2])
    q, s = (torch.from_numpy(a).requires_grad_() for a in (query, src))
    out = tm(q, torch.from_numpy(ref), s, SHAPES, torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    for got, w, what in ((out, want, "out"), (q.grad, jq, "d query"), (s.grad, js, "d src")):
        _close(got, w, 1e-4, what)


@pytest.mark.parametrize("connect_all,Pc,Pt", [(True, 2, 1), (False, 1, 3), (True, 3, 2)])
def test_encoder_matches_jax(connect_all, Pc, Pt):
    from devis_torch.models.attention import TemporalMSDeformAttnEncoder
    from devis_tpu.models.attention import TemporalMSDeformAttnEncoder as JEnc
    rs = np.random.RandomState(0)
    T = 3
    W = T - 1 if connect_all else 2
    query = rs.randn(T, S, C).astype(np.float32)
    ref = rs.rand(T, S, L, 2).astype(np.float32)
    src = rs.randn(T, S, C).astype(np.float32)
    mask = np.zeros((T, S), bool)
    mask[:, -5:] = True
    jm = JEnc(n_frames=T, d_model=C, n_levels=L, t_window=W, n_heads=M, n_curr_points=Pc,
              n_temporal_points=Pt, connect_all=connect_all, impl="xla")
    tm = TemporalMSDeformAttnEncoder(T, C, L, W, M, Pc, Pt, connect_all=connect_all)
    assert not tm.fused
    _run_pair(jm, tm, query, ref, src, mask)


@pytest.mark.parametrize("instance_aware,refdim,Pc,Pt", [(True, 2, 2, 1), (True, 4, 1, 2),
                                                        (False, 4, 2, 3)])
def test_decoder_matches_jax(instance_aware, refdim, Pc, Pt):
    from devis_torch.models.attention import TemporalMSDeformAttnDecoder, capture_sampling
    from devis_tpu.models.attention import TemporalMSDeformAttnDecoder as JDec
    rs = np.random.RandomState(2)
    T, Lq = 3, 5
    query = rs.randn(1, T * Lq, C).astype(np.float32)
    ref = (rs.rand(1, T * Lq, L, refdim) * 0.8 + 0.1).astype(np.float32)
    src = rs.randn(T, S, C).astype(np.float32)
    mask = np.zeros((T, S), bool)
    jm = JDec(n_frames=T, d_model=C, n_levels=L, t_window=T - 1, n_heads=M, n_curr_points=Pc,
              n_temporal_points=Pt, instance_aware=instance_aware, impl="xla")
    tm = TemporalMSDeformAttnDecoder(T, C, L, T - 1, M, Pc, Pt, instance_aware=instance_aware)
    _run_pair(jm, tm, query, ref, src, mask)
    # the capture holds the JAX decoder's four sown tensors
    args = tuple(jnp.asarray(a) for a in (query, ref, src))
    variables = _random_variables(jm, *args, SHAPES, jnp.asarray(mask))
    tm.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    _, inter = jm.apply(variables, *args, SHAPES, jnp.asarray(mask), mutable=["intermediates"])
    sown = inter["intermediates"]
    with torch.no_grad(), capture_sampling(tm) as records:
        tm(*(torch.from_numpy(a) for a in (query, ref, src)), SHAPES, torch.from_numpy(mask))
    (rec,) = records
    assert rec["loc_t"].shape == (T, Lq, M, (T - 1) * L, Pt, 2)
    for key, name in (("loc_c", "viz_sampling_locations"), ("att_c", "viz_attention_weights"),
                      ("loc_t", "viz_temporal_sampling_locations"),
                      ("att_t", "viz_temporal_attention_weights")):
        _close(rec[key], sown[name][0], 1e-5, key)


def test_twenty_levels_in_groups_equal_one_plain_call():
    from devis_torch.ops.ms_deform_attn import make_temporal_shapes, ms_deform_attn
    from devis_torch.ops.ms_deform_attn_cuda import by_level_groups, level_groups
    shapes = make_temporal_shapes(((6, 8), (3, 4), (2, 2), (1, 1)), 5)
    assert len(shapes) == 20 and level_groups(20) == [(0, 16), (16, 20)]
    rs = np.random.RandomState(3)
    Sv = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rs.randn(2, Sv, 2, 8).astype(np.float32))
    loc = torch.from_numpy(rs.rand(2, 7, 2, 20, 2, 2).astype(np.float32) * 1.2 - 0.1)
    att = torch.from_numpy(rs.rand(2, 7, 2, 20, 2).astype(np.float32))
    got_in = [t.clone().requires_grad_() for t in (value, loc, att)]
    want_in = [t.clone().requires_grad_() for t in (value, loc, att)]
    got = by_level_groups(ms_deform_attn, *got_in[:1], shapes, *got_in[1:])
    want = ms_deform_attn(want_in[0], shapes, *want_in[1:])
    _close(got, want.detach(), 1e-6, "out")
    g = torch.from_numpy(rs.randn(*want.shape).astype(np.float32))
    (got * g).sum().backward()
    (want * g).sum().backward()
    for a, b, what in zip(got_in, want_in, ("value", "loc", "att")):
        _close(a.grad, b.grad, 1e-6, what)


@pytest.mark.parametrize("G,Mv", [(3, 1), (2, 2)])
def test_grouped_heads_plain_matches_jax(G, Mv):
    from devis_torch.ops.ms_deform_attn import ms_deform_attn
    from devis_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_pallas
    rs = np.random.RandomState(G)
    B, Q, D, P = 2, 40, 32, 2
    value = rs.rand(B, S, Mv, D).astype(np.float32)
    loc = rs.rand(B, Q, Mv * G, L, P, 2).astype(np.float32)
    att = rs.rand(B, Q, Mv * G, L, P).astype(np.float32)
    att /= att.sum((3, 4), keepdims=True)
    got = ms_deform_attn(*(torch.from_numpy(a) for a in (value,)), SHAPES,
                         torch.from_numpy(loc), torch.from_numpy(att))
    assert got.shape == (B, Q, Mv * G * D)
    want = ms_deform_attn_pallas(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(att))
    _close(got, want, 1e-5, "vs JAX grouped")
    rep = torch.from_numpy(value).repeat_interleave(G, dim=2)
    assert torch.equal(got, ms_deform_attn(rep, SHAPES, torch.from_numpy(loc),
                                           torch.from_numpy(att)))


def _devis_cfg(get_cfg_defaults):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "configs/devis/YT-19/devis_R_50_YT-19.yaml"))
    cfg.merge_from_list(["MODEL.HIDDEN_DIM", 128, "MODEL.DIM_FEEDFORWARD", 64,
                         "MODEL.TRANSFORMER.ENCODER_LAYERS", 1,
                         "MODEL.TRANSFORMER.DECODER_LAYERS", 1, "MODEL.LOSS.MASK_AUX_LOSS", [],
                         "MODEL.DEVIS.NUM_FRAMES", 3, "MODEL.NUM_QUERIES", 12,
                         "MODEL.DROPOUT", 0.0, "MODEL.WEIGHTS", "",
                         "MODEL.DEVIS.DEFORMABLE_ATTENTION.ENC_N_POINTS_TEMPORAL_FRAME", 2,
                         "MODEL.DEVIS.DEFORMABLE_ATTENTION.DEC_N_POINTS_TEMPORAL_FRAME", 2])
    cfg.freeze()
    return cfg


def test_devis_with_two_temporal_points_matches_jax():
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_torch.models.attention import TemporalMSDeformAttnEncoder
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build

    from .test_torch_ablations import NUM_CLASSES, _to_port, check_eval, clip_batch
    from .test_torch_slice import random_variables
    jmodel = jax_build(num_classes=NUM_CLASSES, cfg=_devis_cfg(jax_cfg), impl="xla")
    batch = clip_batch(3)
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"][0]),
        jnp.asarray(batch["pad_mask"][0]), train=False))
    variables = random_variables(template, seed=2)
    tmodel = build_model(NUM_CLASSES, _devis_cfg(get_cfg_defaults), device="cpu")
    tmodel.load_state_dict(_to_port(variables), strict=True)
    enc = [m for m in tmodel.modules() if isinstance(m, TemporalMSDeformAttnEncoder)]
    assert enc and all((m.n_points, m.n_temporal_points) == (4, 2) for m in enc)
    check_eval((jmodel, variables, tmodel, batch))


def test_adapt_weights_devis_with_two_temporal_points():
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_torch.util import checkpoint as ckpt
    from devis_tpu.util import checkpoint as jckpt

    from .test_torch_checkpoint import _model_keys, _source_state
    state = _source_state(np.random.RandomState(0))
    keys = _model_keys(4, T_=6, w_enc=5, pt=2)
    kw = dict(lvl_res=4, focal_loss=True, finetune_class_logits=False, num_frames=6,
              finetune_query_embds=True, finetune_temporal_modules=True,
              enc_connect_all_frames=True, enc_temporal_window=4, enc_n_temporal_points=2,
              dec_n_temporal_points=2)
    got = ckpt.adapt_weights_devis(dict(state), keys, **kw)
    want = jckpt.adapt_weights_devis(dict(state), keys, **kw)
    assert sorted(got) == sorted(want) and any("temporal" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the shapes it fills are the port model's own at full width
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "configs/devis/YT-19/devis_R_50_YT-19.yaml"))
    cfg.merge_from_list(["MODEL.TRANSFORMER.ENCODER_LAYERS", 1,
                         "MODEL.TRANSFORMER.DECODER_LAYERS", 1, "MODEL.LOSS.MASK_AUX_LOSS", [],
                         "MODEL.DEVIS.DEFORMABLE_ATTENTION.ENC_N_POINTS_TEMPORAL_FRAME", 2,
                         "MODEL.DEVIS.DEFORMABLE_ATTENTION.DEC_N_POINTS_TEMPORAL_FRAME", 2])
    model_keys = ckpt.model_keys(build_model(41, cfg, device="cpu"))
    for k, shape in keys.items():
        if "temporal" in k:
            assert model_keys[k] == shape, k
