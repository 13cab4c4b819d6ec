"""The port's Swin backbone (`devis_torch/models/backbones/swin.py`) against
the JAX package's on the CPU: the window operations, relative index and
shift mask bit for bit; blocks, patch merging and the four stage outputs from
the same numpy weights; DropPath; the state-dict names; the learning-rate
groups; and the slices: a tiny DeVIS and a tiny COCO image model with a tiny
Swin backbone, eval outputs against the JAX `impl='xla'` twin.

Weights are numpy draws over the JAX parameter tree, carried to the port with
`from_jax_params` and loaded strictly. f32 runs with TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.weights import from_jax_params

from .test_torch_slice import _close, _flatten, random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window=4,
            num_channels=(16, 32, 64, 128), drop_path_rate=0.0)
TINY_NAME = "swin_tiny_test_p4w4"


@pytest.fixture(scope="module", autouse=True)
def _f32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def tiny_swin_name():
    """Registers the tiny Swin under one name in both packages' registries
    for this module's tests, so `build_model` reaches it on both sides."""
    from devis_torch.models.backbones import swin as P
    from devis_tpu.models.backbones import swin as J
    for reg in (J.SWIN_CONFIGS, P.SWIN_CONFIGS):
        reg[TINY_NAME] = TINY
    yield TINY_NAME
    for reg in (J.SWIN_CONFIGS, P.SWIN_CONFIGS):
        reg.pop(TINY_NAME)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _jax_pair(jmod, tmod, *inputs, seed=0):
    """Numpy draws over `jmod`'s variables, loaded strictly into `tmod`."""
    template = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *inputs))
    variables = random_variables(template, seed=seed)
    tmod.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    return variables


# ---------------------------------------------------------------------------
# window operations, relative index, shift mask: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,W,C,w", [(2, 8, 8, 3, 4), (1, 12, 28, 5, 4), (2, 24, 36, 2, 12)])
def test_window_ops_match_jax(B, H, W, C, w):
    from devis_torch.models.backbones import swin as P
    from devis_tpu.models.backbones import swin as J
    x = np.random.RandomState(0).randn(B, H, W, C).astype(np.float32)
    wins = P.window_partition(torch.from_numpy(x), w)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(J.window_partition(jnp.asarray(x), w)))
    back = P.window_reverse(wins, w, B, H, W)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("w", [2, 4, 7, 12])
def test_relative_position_index_matches_jax(w):
    from devis_torch.models.backbones import swin as P
    from devis_tpu.models.backbones import swin as J
    got = P.relative_position_index(w)
    np.testing.assert_array_equal(got, J.relative_position_index(w))
    assert got.dtype == np.int32 and got.min() == 0 and got.max() == (2 * w - 1) ** 2 - 1
    attn = P.WindowAttention(8, 2, w)
    np.testing.assert_array_equal(attn.relative_position_index.numpy(), got)
    assert "relative_position_index" in attn.state_dict()


@pytest.mark.parametrize("H,W,w,shift", [(8, 8, 4, 2), (12, 20, 4, 2), (24, 36, 12, 6),
                                         (14, 28, 7, 3)])
def test_shift_mask_matches_jax(H, W, w, shift):
    from devis_torch.models.backbones import swin as P
    from devis_tpu.models.backbones import swin as J
    got = P.shift_attn_mask(H, W, w, shift)
    np.testing.assert_array_equal(got, J.shift_attn_mask(H, W, w, shift))
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, -100.0}
    assert not got[0].any() and got[-1].any()


# ---------------------------------------------------------------------------
# blocks, patch merging, the stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0, 2])
def test_block_matches_jax(shift):
    """A plain and a shifted block at B 2, 8x12, C 16, window 4, f32."""
    from devis_torch.models.backbones.swin import SwinBlock
    from devis_tpu.models.backbones.swin import SwinBlock as JaxBlock
    x = np.random.RandomState(1).randn(2, 8, 12, 16).astype(np.float32)
    jblk = JaxBlock(16, 2, 4, shift)
    tblk = SwinBlock(16, 2, 4, shift)
    variables = _jax_pair(jblk, tblk, jnp.asarray(x), seed=1)
    want = jax.jit(jblk.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tblk(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("H,W", [(8, 12), (7, 9)])
def test_patch_merging_matches_jax(H, W):
    """The 2x2 concat order and the zero pad of an odd side."""
    from devis_torch.models.backbones.swin import PatchMerging
    from devis_tpu.models.backbones.swin import PatchMerging as JaxMerging
    x = np.random.RandomState(2).randn(2, H, W, 8).astype(np.float32)
    jm, tm = JaxMerging(8), PatchMerging(8)
    variables = _jax_pair(jm, tm, jnp.asarray(x), seed=2)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, (H + 1) // 2, (W + 1) // 2, 16)
    assert _rel(got.numpy(), want) <= 1e-4


# 128x256: every stage side a window multiple (stage 3's 4x8 unshifted: a side
# is one window); 72x100 pads every stage (tests/test_swin.py:62-71); 40x200:
# stage 2 pads to 4x16, a side of one window, so it does not shift
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", [(128, 256), (72, 100), (40, 200)])
def test_stages_match_jax(H, W, dtype):
    """Every stage output of the tiny Swin (embed 16, depths 2-2-2-2, window
    4): f32 to 1e-4 of max|ref|; bf16 to 2e-2. In bf16 the two packages round
    at other places (the port's linear layers add the bias before rounding,
    the JAX ones after; GELU in one rounding against several), and a stage's
    LayerNorm over 16-128 channels magnifies that: each side lies 1-2.5e-2 of
    max|ref| from its own f32 result, and 1.2-2.0e-2 from the other."""
    from devis_torch.models.backbones.swin import SwinTransformer
    from devis_tpu.models.backbones.swin import SwinTransformer as JaxSwin
    x = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    jm = JaxSwin(**TINY, dtype=getattr(jnp, dtype))
    tm = SwinTransformer(**TINY, dtype=getattr(torch, dtype))
    variables = _jax_pair(jm, tm, jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert len(got) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == getattr(torch, dtype) and g.is_contiguous()
        assert g.shape[1] == TINY["num_channels"][i]
        assert _rel(g.float().permute(0, 2, 3, 1).numpy(), w.astype(jnp.float32)) <= tol, i


def _per_block_padding_stage(stage, x, w):
    """A stage as the upstream detection Swin runs it: each block pads after
    `norm1`, attends (odd blocks shifted), crops before the residual."""
    import torch.nn.functional as F

    from devis_torch.models.backbones.swin import (shift_attn_mask, window_partition,
                                                   window_reverse)
    for blk in stage.blocks:
        B, H, W, C = x.shape
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        y = F.pad(blk.norm1(x), (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if blk.shift:
            y = torch.roll(y, (-blk.shift, -blk.shift), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(Hp, Wp, w, blk.shift))
        y = blk.attn(window_partition(y, w).reshape(-1, w * w, C), mask)
        y = window_reverse(y.reshape(-1, w, w, C), w, B, Hp, Wp)
        if blk.shift:
            y = torch.roll(y, (blk.shift, blk.shift), dims=(1, 2))
        x = x + y[:, :H, :W]
        x = x + blk.mlp(blk.norm2(x))
    return x


def test_port_equals_per_block_padding_at_window_multiples():
    """Where every stage side is a window multiple larger than the window,
    the JAX package's rule (pad once a stage; no shift where a padded side
    is one window) and the upstream one (pad inside each block, shift every
    odd block) are the same function. ROADMAP C holds the question of the
    sizes where they part."""
    from devis_torch.models.backbones.swin import SwinTransformer
    torch.manual_seed(0)
    model = SwinTransformer(**TINY)
    for p in model.parameters():
        p.data.normal_(0.0, 0.2)
    x = torch.randn(1, 3, 256, 256)          # stages 64, 32, 16, 8: all > the window 4
    with torch.no_grad():
        got = model(x)
        t = model.patch_embed(x)
        for i, stage in enumerate(model.layers):
            t = _per_block_padding_stage(stage, t, 4)
            want = getattr(model, f"norm{i}")(t).permute(0, 3, 1, 2)
            assert torch.equal(got[i], want), i
            if stage.downsample is not None:
                t = stage.downsample(t)


def test_droppath_matches_branch_outcomes():
    """In training each sample of a block with drop path 0.5 equals one of
    the four outcomes {attention branch kept, dropped} x {MLP branch kept,
    dropped}, a kept branch scaled by 2, as the JAX test of its block holds;
    eval and p = 0 are the identity. Draws come from the given generator."""
    from devis_torch.models.backbones.swin import SwinBlock, window_partition, window_reverse
    from devis_torch.models.layers import DropPath, set_dropout_generator
    torch.manual_seed(3)
    B, H, W, C = 8, 8, 8, 8
    x = torch.rand(B, H, W, C)
    blk = SwinBlock(C, 2, 4, 0, drop_path=0.5).train()
    for p in blk.parameters():
        p.data.normal_(0.0, 0.3)
    set_dropout_generator(blk, torch.Generator().manual_seed(7))
    with torch.no_grad():
        out = blk(x)
        again = blk(x)
        kinds = set()
        for b in range(B):
            xb = x[b:b + 1]
            a = window_reverse(blk.attn(window_partition(blk.norm1(xb), 4).reshape(-1, 16, C)
                                        ).reshape(-1, 4, 4, C), 4, 1, H, W)
            cands = []
            for s_attn in (0.0, 2.0):
                x1 = xb + s_attn * a
                for s_mlp in (0.0, 2.0):
                    cands.append(x1 + s_mlp * blk.mlp(blk.norm2(x1)))
            dists = [float((out[b:b + 1] - c).abs().max()) for c in cands]
            k = int(np.argmin(dists))
            assert dists[k] < 1e-5, (b, dists)
            kinds.add(k)
    assert len(kinds) >= 2
    assert not torch.equal(out, again)        # the generator moved on
    dp = DropPath(0.5)
    assert dp.eval()(x) is x and DropPath(0.0).train()(x) is x
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    dp.train().generator = g1
    first = dp(x)
    dp.generator = g2
    assert torch.equal(dp(x), first)


# ---------------------------------------------------------------------------
# factory, names, learning-rate groups
# ---------------------------------------------------------------------------

def test_registry_and_factory_match_jax():
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_backbone
    from devis_torch.models.backbones.swin import SWIN_CONFIGS, SwinTransformer
    from devis_tpu.models.backbones.swin import SWIN_CONFIGS as JAX_CONFIGS
    assert {k: v for k, v in JAX_CONFIGS.items() if k != TINY_NAME} == \
        {k: v for k, v in SWIN_CONFIGS.items() if k != TINY_NAME}
    assert len(SWIN_CONFIGS) - (TINY_NAME in SWIN_CONFIGS) == 5
    cfg = get_cfg_defaults()
    cfg.MODEL.BACKBONE = "swin_l_p4w12"
    cfg.TPU.SWIN_GRADIENT_CHECKPOINT = True
    body, ch = build_backbone(cfg, torch.bfloat16)
    assert isinstance(body, SwinTransformer) and body.use_checkpoint
    assert tuple(ch) == (192, 384, 768, 1536) and body.window == 12
    assert [len(s.blocks) for s in body.layers] == [2, 2, 18, 2]
    rates = [b.drop_path.p for s in body.layers for b in s.blocks]
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.3, 24))
    cfg.MODEL.BACKBONE = "swin_unregistered"
    with pytest.raises(KeyError):
        build_backbone(cfg)


def test_state_dict_keys_are_the_jax_checkpoint_map():
    """The port's Swin parameters are named as `devis_tpu/util/checkpoint.py`
    names the JAX Swin's for a reference state dict, plus each block's
    `relative_position_index` buffer; `from_jax_params` gives exactly that."""
    from devis_torch.models.backbones.swin import SwinTransformer
    from devis_tpu.models.backbones.swin import SwinTransformer as JaxSwin
    from devis_tpu.util.checkpoint import flax_path_to_torch_key
    cfg = dict(TINY, depths=(2, 2, 3, 2))
    jm = JaxSwin(**cfg)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    want = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(template)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        want.add(flax_path_to_torch_key(keys[1:-1], keys[-1], keys[0]))
    n_blocks = sum(cfg["depths"])
    index = {f"layers.{i}.blocks.{j}.attn.relative_position_index"
             for i, d in enumerate(cfg["depths"]) for j in range(d)}
    assert len(index) == n_blocks
    port = SwinTransformer(**cfg).state_dict()
    assert set(port) == want | index
    assert {"patch_embed.proj.weight", "layers.2.blocks.2.mlp.fc2.bias",
            "layers.0.downsample.reduction.weight", "norm3.bias",
            "layers.1.blocks.1.attn.relative_position_bias_table"} <= want
    mapped = from_jax_params(_flatten(random_variables(template, 0)))
    assert set(mapped) == set(port)
    assert mapped["layers.2.blocks.0.attn.relative_position_index"].dtype == torch.int64


# ---------------------------------------------------------------------------
# the slices: DeVIS and the COCO image model with the tiny Swin
# ---------------------------------------------------------------------------

T, H, W = 2, 64, 96


def devis_cfg(get_cfg_defaults, backbone, dropout=0.0, remat=False):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.BACKBONE = backbone
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.BBX_GRADIENT_PROP = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.LOSS.AUX_LOSS_WEIGHTING = True
    cfg.MODEL.DROPOUT = dropout
    cfg.MODEL.NUM_QUERIES = 8
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.MODEL.DEVIS.NUM_FRAMES = T
    cfg.TEST.NUM_OUT = 4
    cfg.SOLVER.STEPS = [1]
    cfg.TPU.SWIN_GRADIENT_CHECKPOINT = remat
    cfg.TPU.TRANSFORMER_GRADIENT_CHECKPOINT = remat
    cfg.freeze()
    return cfg


def _clip():
    rs = np.random.RandomState(1)
    images = np.zeros((T, H, W, 3), np.float32)
    images[:, :56, :80] = rs.randn(T, 56, 80, 3)
    pad = np.ones((T, H, W), bool)
    pad[:, :56, :80] = False
    return images, pad


def test_devis_swin_eval_matches_jax(tiny_swin_name):
    """A tiny DeVIS (1 + 2 layers, width 128, T 2) on the tiny Swin, both
    checkpoint flags on (inert in eval): every output to 1e-3 of max|ref|."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    jmodel = jax_build(num_classes=41, cfg=devis_cfg(jax_cfg, tiny_swin_name, remat=True),
                       impl="xla")
    tmodel = build_model(41, devis_cfg(get_cfg_defaults, tiny_swin_name, remat=True),
                         device="cpu")
    images, pad = _clip()
    variables = _jax_pair(jmodel, tmodel, jnp.asarray(images), jnp.asarray(pad), seed=4)
    jout, jres = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
        variables, jnp.asarray(images), jnp.asarray(pad))
    with torch.no_grad():
        tout, tres = tmodel(torch.from_numpy(images), torch.from_numpy(pad))
    # the mask head's /4 adapter takes the Swin's first stage
    assert tmodel.mask_head.adapter3.weight.shape[1] == TINY["num_channels"][0]
    _close(tout["pred_logits"], jout["pred_logits"], "pred_logits")
    _close(tout["pred_boxes"], jout["pred_boxes"], "pred_boxes")
    for k in ("labels", "query_top_k_indexes", "mask_gather"):
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]), k)
    for k in ("scores", "boxes", "masks"):
        _close(tres[k], jres[k], k)


def coco_cfg(get_cfg_defaults, backbone):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "coco"
    cfg.MODEL.BACKBONE = backbone
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.NUM_QUERIES = 12
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.TEST.NUM_OUT = 5
    cfg.TPU.SWIN_GRADIENT_CHECKPOINT = True
    cfg.freeze()
    return cfg


def test_coco_swin_eval_matches_jax(tiny_swin_name):
    """The image model (Deformable DETR + mask head, 1 + 2 layers) on the
    tiny Swin, two images of one batch: every output to 1e-3 of max|ref|."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    jmodel = jax_build(num_classes=91, cfg=coco_cfg(jax_cfg, tiny_swin_name), impl="xla")
    tmodel = build_model(91, coco_cfg(get_cfg_defaults, tiny_swin_name), device="cpu")
    rs = np.random.RandomState(2)
    images = rs.randn(2, H, W, 3).astype(np.float32)
    pad = np.zeros((2, H, W), bool)
    pad[1, 48:] = True
    pad[1, :, 72:] = True
    images[pad] = 0.0
    variables = _jax_pair(jmodel, tmodel, jnp.asarray(images), jnp.asarray(pad), seed=6)
    jout = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
        variables, jnp.asarray(images), jnp.asarray(pad))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images), torch.from_numpy(pad))
    _close(tout["pred_logits"], jout["pred_logits"], "pred_logits")
    _close(tout["pred_boxes"], jout["pred_boxes"], "pred_boxes")
    jt, tt = jout["top_k"], tout["top_k"]
    for k in ("labels", "query_top_k_indexes"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]), k)
    for k in ("scores", "boxes", "masks"):
        _close(tt[k], jt[k], k)


def test_param_groups_match_the_jax_labels_for_swin(tiny_swin_name):
    """Every Swin parameter falls in the group the JAX package gives it:
    the backbone's, never the frozen ResNet stem's (`layers.1` is not
    `layer1`)."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import PARAM_GROUPS, param_labels
    from devis_torch.models import build_model
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.engine import param_labels as jax_labels
    from devis_tpu.models import build_model as jax_build
    jmodel = jax_build(num_classes=41, cfg=devis_cfg(jax_cfg, tiny_swin_name), impl="xla")
    tmodel = build_model(41, devis_cfg(get_cfg_defaults, tiny_swin_name), device="cpu")
    images, pad = _clip()
    variables = _jax_pair(jmodel, tmodel, jnp.asarray(images), jnp.asarray(pad))
    labels = param_labels(tmodel, devis_cfg(get_cfg_defaults, tiny_swin_name))
    jlabels = jax_labels(variables["params"], devis_cfg(jax_cfg, tiny_swin_name))
    flat = {}
    for path, label in jax.tree_util.tree_flatten_with_path(jlabels)[0]:
        flat["/".join(["params"] + [str(k.key) for k in path])] = \
            np.full((1,), PARAM_GROUPS.index(label), np.float32)
    want = {k: PARAM_GROUPS[int(v[0])] for k, v in from_jax_params(flat).items()
            if not k.endswith("relative_position_index")}
    assert sorted(want) == sorted(labels)
    assert want == labels
    body = "def_detr.backbone.0.body."
    assert labels[body + "layers.1.blocks.0.attn.qkv.weight"] == "backbone"
    assert labels[body + "patch_embed.proj.weight"] == "backbone"
    assert "frozen" not in {v for k, v in labels.items() if k.startswith(body)}
