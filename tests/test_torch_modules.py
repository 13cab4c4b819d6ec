"""The port's modules against their JAX counterparts, on the same numpy-drawn
weights (carried over with `from_jax_params`) and inputs, in f32: the
temporal attention modules against the JAX modules on their Pallas routes
(interpret mode), the ResNet stages, the position encoding, the attention
maps and the MDC mask head, and the weight transplant itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.weights import from_jax_params

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = ((8, 12), (4, 6), (2, 3))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
C, M, P = 64, 4, 2


def _flatten(variables):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [str(getattr(p, "key", getattr(p, "name", None))) for p in path]
        flat["/".join(keys)] = np.asarray(leaf)
    return flat


def _random_variables(module, *args, seed=0, **kw):
    """numpy draws over the module's variable tree (nonzero offsets and
    biases; positive frozen variances)."""
    template = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if str(getattr(path[0], "key", path[0])) == "frozen":
            if name == "running_var":
                return rs.uniform(0.5, 1.5, shape).astype(np.float32)
            return ((1.0 if name == "weight" else 0.0)
                    + 0.1 * rs.randn(*shape)).astype(np.float32)
        if name in ("kernel", "weight") and len(shape) >= 2:
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return rs.randn(*shape).astype(np.float32) * (1.0 if name.endswith("embed") else 0.1)

    return jax.tree_util.tree_map_with_path(draw, template)


def _load(tmodule, variables):
    tmodule.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    return tmodule.eval()


def _close(got, want, rel=1e-4):
    # f32 on both sides, different accumulation orders
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("connect_all", [True, False])
def test_encoder_attention_matches_pallas_module(rng, connect_all):
    from devis_tpu.models.attention import TemporalMSDeformAttnEncoder as JEnc
    from devis_torch.models.attention import TemporalMSDeformAttnEncoder
    T = 3
    W = T - 1 if connect_all else 2
    kw = dict(n_frames=T, d_model=C, n_levels=L, t_window=W, n_heads=M,
              n_curr_points=P, n_temporal_points=P)
    query = rng.randn(T, S, C).astype(np.float32)
    ref = rng.rand(T, S, L, 2).astype(np.float32)
    src = rng.randn(T, S, C).astype(np.float32)
    mask = np.zeros((T, S), bool)
    mask[:, -5:] = True
    jm = JEnc(connect_all=connect_all, impl="pallas", **kw)
    args = tuple(jnp.asarray(a) for a in (query, ref, src)) + (SHAPES, jnp.asarray(mask))
    variables = _random_variables(jm, *args)
    want = jm.apply(variables, *args)
    tm = _load(TemporalMSDeformAttnEncoder(T, C, L, W, M, P, P, connect_all=connect_all),
               variables)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, ref, src)), SHAPES,
                 torch.from_numpy(mask))
    _close(got.numpy(), want)


@pytest.mark.parametrize("refdim", [2, 4])
def test_decoder_attention_matches_pallas_module(rng, refdim):
    from devis_tpu.models.attention import TemporalMSDeformAttnDecoder as JDec
    from devis_torch.models.attention import TemporalMSDeformAttnDecoder
    T, Lq = 3, 5
    kw = dict(n_frames=T, d_model=C, n_levels=L, t_window=T - 1, n_heads=M,
              n_curr_points=P, n_temporal_points=P)
    query = rng.randn(1, T * Lq, C).astype(np.float32)
    ref = (rng.rand(1, T * Lq, L, refdim) * 0.8 + 0.1).astype(np.float32)
    src = rng.randn(T, S, C).astype(np.float32)
    mask = np.zeros((T, S), bool)
    jm = JDec(instance_aware=True, impl="pallas", **kw)
    args = tuple(jnp.asarray(a) for a in (query, ref, src)) + (SHAPES, jnp.asarray(mask))
    variables = _random_variables(jm, *args)
    want = jm.apply(variables, *args)
    tm = _load(TemporalMSDeformAttnDecoder(T, C, L, T - 1, M, P, P, instance_aware=True),
               variables)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, ref, src)), SHAPES,
                 torch.from_numpy(mask))
    _close(got.numpy(), want)


def test_multihead_attention_matches(rng):
    from devis_tpu.models.attention import MultiHeadAttention as JMHA
    from devis_torch.models.attention import MultiHeadAttention
    q = rng.randn(1, 12, C).astype(np.float32)
    v = rng.randn(1, 12, C).astype(np.float32)
    jm = JMHA(C, M)
    variables = _random_variables(jm, jnp.asarray(q), jnp.asarray(q), jnp.asarray(v))
    want = jm.apply(variables, jnp.asarray(q), jnp.asarray(q), jnp.asarray(v))
    # the JAX module's q/k/v leaves live under self_attn of a decoder layer
    flat = {f"params/decoder_layers_0/self_attn/{k.split('/', 1)[1]}": a
            for k, a in _flatten(variables).items()}
    sd = {k.split("self_attn.", 1)[1]: t for k, t in from_jax_params(flat).items()}
    tm = MultiHeadAttention(C, M)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v))
    _close(got.numpy(), want)


def test_resnet_stages_match(rng):
    from devis_tpu.models.backbones.resnet import ResNet as JResNet
    from devis_torch.models.backbones.resnet import ResNet
    x = rng.randn(1, 32, 48, 3).astype(np.float32)
    jm = JResNet()
    variables = _random_variables(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = _load(ResNet(), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)


def test_position_encoding_matches(rng):
    from devis_tpu.models.position_encoding import \
        PositionEmbeddingSineWithLearnableTemporal as JPos
    from devis_torch.models.position_encoding import \
        PositionEmbeddingSineWithLearnableTemporal
    mask = np.zeros((3, 7, 9), bool)
    mask[:, 5:] = True
    mask[:, :, 8:] = True
    jm = JPos(hidden_dim=C, num_frames=3)
    variables = _random_variables(jm, jnp.asarray(mask))
    want = jm.apply(variables, jnp.asarray(mask))
    tm = _load(PositionEmbeddingSineWithLearnableTemporal(C, 3), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(mask))
    # f32 sin/cos of the same arguments
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_maps_match(rng):
    from devis_tpu.models.segmentation import MultiScaleMHAttentionMap as JMap
    from devis_torch.models.segmentation import MultiScaleMHAttentionMap
    q = rng.randn(2, 3, C).astype(np.float32)
    mems = [rng.randn(2, h, w, C).astype(np.float32) for h, w in SHAPES]
    masks = [np.zeros((2, h, w), bool) for h, w in SHAPES]
    masks[0][:, :, -2:] = True
    jm = JMap(C, 8, L)
    jargs = (jnp.asarray(q), [jnp.asarray(m) for m in mems], [jnp.asarray(m) for m in masks])
    variables = _random_variables(jm, *jargs)
    want = jm.apply(variables, *jargs)
    tm = _load(MultiScaleMHAttentionMap(C, 8, L), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), [torch.from_numpy(m) for m in mems],
                 [torch.from_numpy(m) for m in masks])
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_mdc_mask_head_matches(rng):
    """Against the JAX head's exact MDC route (impl='xla'): the port's K4 is
    exact DCNv2, the TPU banded route is not."""
    from devis_tpu.models.segmentation import MaskHeadConv as JHead
    from devis_torch.models.segmentation import MaskHeadConv
    dim, heads, B, N = 128, 8, 2, 2
    sizes = ((2, 3), (4, 6), (8, 12), (16, 24))
    fpn_dims = (dim, dim, 32)
    feats = [rng.randn(B, h, w, c).astype(np.float32)
             for (h, w), c in zip(sizes, (dim,) + fpn_dims)]
    att = [rng.rand(N * B, heads, h, w).astype(np.float32) for h, w in sizes[:3]]
    jm = JHead(dim, fpn_dims, heads, True, num_att_levels=3, expand_mode="tile",
               impl="xla")
    jargs = ([jnp.asarray(f) for f in feats], [jnp.asarray(a) for a in att])
    variables = _random_variables(jm, *jargs, expand=N)
    want = jm.apply(variables, *jargs, expand=N)             # (N*B, h, w, 1)
    tm = _load(MaskHeadConv(dim, fpn_dims, heads, 3), variables)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
                 [torch.from_numpy(a) for a in att], expand=N)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_from_jax_params_covers_every_leaf_once():
    """Every leaf of the JAX DeVIS tree lands in exactly one port tensor, and
    the port loads the result strictly."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model

    def cfg(get):
        c = get()
        c.DATASETS.TYPE = "vis"
        c.MODEL.NUM_QUERIES = 4
        c.MODEL.HIDDEN_DIM = 128
        c.MODEL.DIM_FEEDFORWARD = 64
        c.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
        c.MODEL.TRANSFORMER.DECODER_LAYERS = 2
        c.MODEL.DEVIS.NUM_FRAMES = 2
        return c

    jm = jax_build(41, cfg(jax_cfg), impl="xla")
    variables = _random_variables(jm, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 64, 64), bool),
                                  train=False)
    flat = _flatten(variables)
    sd = from_jax_params(flat)
    tm = build_model(41, cfg(get_cfg_defaults), device="cpu")
    assert set(sd) == set(tm.state_dict())
    # q, k and v (kernel and bias) of each decoder self-attention pack into one
    n_dec = 2
    assert len(flat) == len(sd) + 4 * n_dec
    tm.load_state_dict(sd, strict=True)
    # layouts: a dense kernel is transposed, a conv kernel goes HWIO → OIHW
    np.testing.assert_array_equal(
        tm.def_detr.class_embed[0].weight.detach().numpy(),
        flat["params/detr/class_embed_0/kernel"].T)
    np.testing.assert_array_equal(
        tm.mask_head.lay1.regular_conv.weight.detach().numpy(),
        flat["params/mask_head/lay1/weight"].transpose(3, 2, 0, 1))
    q = flat["params/detr/transformer/decoder_layers_1/self_attn/q_proj/kernel"]
    np.testing.assert_array_equal(
        tm.def_detr.transformer.decoder.layers[1].self_attn.in_proj_weight.detach()
        .numpy()[:q.shape[1]], q.T)
