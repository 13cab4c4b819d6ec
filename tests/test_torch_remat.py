"""Recomputation in the backward pass (`devis_torch.models.layers.recompute`,
TPU.SWIN_GRADIENT_CHECKPOINT, TPU.TRANSFORMER_GRADIENT_CHECKPOINT) on the
CPU: the plain call outside training; one train step of a tiny DeVIS on a
tiny Swin with both flags on against the same step with both off, f32:
bit-identical gradients with dropout off, and with dropout 0.1 and drop path
0.3 drawn from one seeded generator equal gradients and an equal generator
state after (which a bare `torch.utils.checkpoint` breaks); and the step with
both flags against `jax.value_and_grad` of the JAX package's step with its
own recomputation on.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.synthetic import synthetic_clip_batch
from devis_torch.util.weights import from_jax_params

from .test_torch_slice import _flatten
from .test_torch_swin import TINY, _jax_pair, devis_cfg
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, H, W = 2, 64, 96
NUM_CLASSES = 7
NAMES = {0.0: "swin_tiny_remat_p4w4", 0.3: "swin_tiny_remat_dp_p4w4"}


@pytest.fixture(scope="module", autouse=True)
def swin_names():
    """The tiny Swin under two names in both registries: drop path 0 and
    0.3."""
    from devis_torch.models.backbones import swin as P
    from devis_tpu.models.backbones import swin as J
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for rate, name in NAMES.items():
        for reg in (J.SWIN_CONFIGS, P.SWIN_CONFIGS):
            reg[name] = dict(TINY, drop_path_rate=rate)
    yield
    for name in NAMES.values():
        for reg in (J.SWIN_CONFIGS, P.SWIN_CONFIGS):
            reg.pop(name)


def _batch():
    return synthetic_clip_batch(seed=3, num_frames=T, canvas=(H, W), valid_hw=(56, 80),
                                n_instances=2, max_instances=3,
                                num_classes=NUM_CLASSES - 1)


def _model(remat, dropout=0.0, drop_path=0.0, seed=0):
    """`remat`: both flags, or a tuple (Swin blocks, transformer layers)."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    swin, layers = remat if isinstance(remat, tuple) else (remat, remat)
    cfg = devis_cfg(get_cfg_defaults, NAMES[drop_path], dropout=dropout)
    cfg.defrost()
    cfg.TPU.SWIN_GRADIENT_CHECKPOINT = swin
    cfg.TPU.TRANSFORMER_GRADIENT_CHECKPOINT = layers
    cfg.freeze()
    return cfg, build_model(NUM_CLASSES, cfg, device="cpu", seed=seed)


def _step(cfg, model, generator=None):
    """One train step; returns (metrics, gradients by name, parameters after)."""
    from devis_torch.engine import create_train_state, make_train_step
    state = create_train_state(cfg, model, steps_per_epoch=10)
    _, metrics = make_train_step(model, cfg)(state, _batch(), generator)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


class _Calls:
    """Counts the calls of every module of a type (a pre-hook: the recompute
    stops once it has rebuilt the last saved tensor, before the module
    returns)."""

    def __init__(self, model, types):
        self.n = 0
        self.handles = [m.register_forward_pre_hook(self._hook) for m in model.modules()
                        if isinstance(m, types)]

    def _hook(self, *_):
        self.n += 1

    def remove(self):
        for h in self.handles:
            h.remove()


def test_recompute_is_the_plain_call_outside_training(monkeypatch):
    from devis_torch.models import layers
    from devis_torch.models.backbones.swin import SwinBlock

    def no_checkpoint(*a, **k):
        raise AssertionError("checkpointed outside training")
    blk = SwinBlock(16, 2, 4, 2)
    x = torch.randn(2, 8, 8, 16, requires_grad=True)
    want = blk(x)
    monkeypatch.setattr(layers, "checkpoint", no_checkpoint)
    assert torch.equal(layers.recompute(blk.eval(), x), want)
    blk.train()
    with torch.no_grad():
        assert torch.equal(layers.recompute(blk, x), want)
    with torch.inference_mode():
        assert torch.equal(layers.recompute(blk, x), want)
    with pytest.raises(AssertionError, match="checkpointed"):
        layers.recompute(blk, x)


@pytest.mark.parametrize("swin,layers", [(True, False), (False, True), (True, True)])
def test_flags_give_bit_identical_gradients_without_dropout(swin, layers):
    """Each flag alone and both on, against both off, dropout and drop path
    0: every loss, every gradient and every parameter after the update to
    the bit. A flagged encoder or decoder layer or Swin block runs twice
    (its recompute in the backward), as K1-K3 launch twice a layer on the
    card."""
    from devis_torch.models.backbones.swin import SwinBlock
    from devis_torch.models.transformer import DecoderLayer, EncoderLayer
    cfg_off, off = _model(remat=False)
    cfg_on, on = _model(remat=(swin, layers))
    on.load_state_dict(off.state_dict())
    assert on.def_detr.transformer.remat_layers == layers
    assert on.def_detr.backbone[0].body.use_checkpoint == swin
    counts = {}
    for tag, cfg, model in (("off", cfg_off, off), ("on", cfg_on, on)):
        calls = _Calls(model, (EncoderLayer, DecoderLayer, SwinBlock))
        counts[tag] = (calls, _step(cfg, model))
        calls.remove()
    (c_off, (m_off, g_off, p_off)), (c_on, (m_on, g_on, p_on)) = counts["off"], counts["on"]
    n_layers, n_blocks = 1 + 2, sum(TINY["depths"])
    assert c_off.n == n_layers + n_blocks
    assert c_on.n == n_layers * (1 + layers) + n_blocks * (1 + swin)
    assert m_on == m_off
    for name in g_off:
        assert torch.equal(g_on[name], g_off[name]), name
        assert torch.equal(p_on[name], p_off[name]), name


def _bare_recompute(module, *args):
    """`torch.utils.checkpoint` alone: the recompute draws new masks."""
    from torch.utils.checkpoint import checkpoint
    if not (module.training and torch.is_grad_enabled()):
        return module(*args)
    return checkpoint(module, *args, use_reentrant=False)


def test_flags_keep_the_dropout_and_drop_path_draws(monkeypatch):
    """Dropout 0.1 and drop path 0.3 from one seeded generator: both flags on
    give the losses, the gradients and the generator's state after the step
    of both flags off. A bare `torch.utils.checkpoint` in their place draws
    other masks in the recompute and leaves the generator elsewhere."""
    from devis_torch.models import transformer
    from devis_torch.models.backbones import swin
    cfg_off, off = _model(remat=False, dropout=0.1, drop_path=0.3)
    cfg_on, on = _model(remat=True, dropout=0.1, drop_path=0.3)
    on.load_state_dict(off.state_dict())
    bare = copy.deepcopy(on)
    rates = [b.drop_path.p for s in on.def_detr.backbone[0].body.layers for b in s.blocks]
    assert rates[-1] == pytest.approx(0.3)
    gens = {tag: torch.Generator().manual_seed(11) for tag in ("off", "on", "bare")}
    m_off, g_off, _ = _step(cfg_off, off, gens["off"])
    m_on, g_on, _ = _step(cfg_on, on, gens["on"])
    assert m_on == m_off
    for name in g_off:
        assert torch.equal(g_on[name], g_off[name]), name
    assert torch.equal(gens["on"].get_state(), gens["off"].get_state())
    # the masks differ from those of a step without any dropout
    _, g_plain, _ = _step(*_model(remat=False))
    assert any(not torch.equal(g_plain[n], g_off[n]) for n in g_off)

    monkeypatch.setattr(transformer, "recompute", _bare_recompute)
    monkeypatch.setattr(swin, "recompute", _bare_recompute)
    _, g_bare, _ = _step(cfg_on, bare, gens["bare"])
    assert not torch.equal(gens["bare"].get_state(), gens["off"].get_state())
    assert any(not torch.equal(g_bare[n], g_off[n]) for n in g_off)


def _jax_step(variables, jmodel, cfg):
    """The JAX train step's loss and gradient for one clip, deterministic,
    from the public pieces of `devis_tpu.engine.make_train_step`."""
    from devis_tpu.models import matcher_cfg_from
    from devis_tpu.models.criterion import build_weight_dict, clip_criterion, weighted_total
    batch = _batch()
    weight_dict = build_weight_dict(cfg)
    mcfg = matcher_cfg_from(cfg, clip=True)
    frozen = {k: v for k, v in variables.items() if k != "params"}
    images, pad = jnp.asarray(batch["images"][0]), jnp.asarray(batch["pad_mask"][0])
    targets = jax.tree.map(lambda x: jnp.asarray(x[0]), batch["targets"])

    def loss_fn(params):
        out = jmodel.apply({"params": params, **frozen}, images, pad, targets=targets,
                           train=True, deterministic=True)
        losses = clip_criterion(out, targets, NUM_CLASSES - 1, T, mcfg,
                                cfg.MODEL.LOSS.FOCAL_ALPHA, mask_on=True)
        return weighted_total(losses, weight_dict), losses
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])


def test_step_with_both_flags_matches_jax():
    """Both flags on, on both sides (flax `nn.remat` on the JAX side),
    dropout off: every loss to 1e-3, every gradient to 1e-2 of its norm."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    jcfg = devis_cfg(jax_cfg, NAMES[0.0], remat=True)
    jmodel = jax_build(num_classes=NUM_CLASSES, cfg=jcfg, impl="xla")
    cfg, tmodel = _model(remat=True)
    batch = _batch()
    variables = _jax_pair(jmodel, tmodel, jnp.asarray(batch["images"][0]),
                          jnp.asarray(batch["pad_mask"][0]), seed=2)
    (jtotal, jlosses), jgrads = _jax_step(variables, jmodel, jcfg)
    metrics, grads, _ = _step(cfg, tmodel)
    assert metrics["loss"] == pytest.approx(float(jtotal), rel=1e-3)
    for k, v in jlosses.items():
        assert metrics[k] == pytest.approx(float(v), rel=1e-3, abs=1e-5), k
    want = {k: v for k, v in from_jax_params(_flatten({"params": jgrads})).items()
            if not k.endswith("relative_position_index")}
    assert sorted(want) == sorted(grads)
    jnorm = float(np.sqrt(sum(float(g.double().square().sum()) for g in want.values())))
    assert metrics["grad_norm"] == pytest.approx(jnorm, rel=1e-3)
    scale = min(1.0, cfg.SOLVER.GRAD_CLIP_MAX_NORM / jnorm)
    for name, g in grads.items():
        w = want[name] * scale
        assert float((g - w).norm()) <= 1e-2 * float(w.norm()) \
            + 1e-6 * cfg.SOLVER.GRAD_CLIP_MAX_NORM, name
