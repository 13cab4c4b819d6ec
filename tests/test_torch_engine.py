"""The port's training engine against the JAX package on the CPU, f32:
parameter groups, learning rates and schedule; AdamW with the global-norm
clip on identical numpy gradients; the NaN guard; and the slice as a whole:
one train step of a tiny DeVIS (2 + 2 layers, narrow widths, small canvas,
dropout off) against `jax.value_and_grad` of the JAX loss, every loss and
every parameter's gradient, then the parameters after 2 steps.

Weights are numpy draws over the JAX `impl='xla'` twin's parameter tree,
carried over with `from_jax_params` and loaded strictly.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.synthetic import synthetic_clip_batch
from devis_torch.util.weights import from_jax_params

from .test_torch_slice import _flatten, random_variables

T, H, W = 2, 64, 96
NUM_CLASSES = 7               # with the background; the model emits 6 logits
STEPS_PER_EPOCH = 10


def _cfg(get_cfg_defaults):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.BBX_GRADIENT_PROP = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.LOSS.AUX_LOSS_WEIGHTING = True
    cfg.MODEL.DROPOUT = 0.0
    cfg.MODEL.NUM_QUERIES = 8
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 2
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.MODEL.DEVIS.NUM_FRAMES = T
    cfg.SOLVER.STEPS = [1]            # the rate drops after one epoch
    cfg.freeze()
    return cfg


def _batch():
    return synthetic_clip_batch(seed=3, num_frames=T, canvas=(H, W), valid_hw=(56, 80),
                                n_instances=2, max_instances=3,
                                num_classes=NUM_CLASSES - 1)


def _make_pair():
    """(JAX model, its variables, the port's model with the same weights)."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jmodel = jax_build(num_classes=NUM_CLASSES, cfg=_cfg(jax_cfg), impl="xla")
    batch = _batch()
    targets = jax.tree.map(lambda x: jnp.asarray(x[0]), batch["targets"])
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"][0]),
        jnp.asarray(batch["pad_mask"][0]), targets=targets, train=True))
    variables = random_variables(template, seed=0)
    tmodel = build_model(NUM_CLASSES, _cfg(get_cfg_defaults), device="cpu")
    tmodel.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


def _grads_to_port(tree):
    """A JAX gradient (or parameter) tree → tensors by the port's names."""
    return from_jax_params(_flatten({"params": tree}))


# ---------------------------------------------------------------------------
# (d) groups, rates, schedule, optimizer, NaN guard
# ---------------------------------------------------------------------------

def test_param_groups_match_the_jax_labels(pair):
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.engine import param_labels as jax_labels
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import PARAM_GROUPS, param_labels
    _, variables, tmodel = pair
    labels = param_labels(tmodel, _cfg(get_cfg_defaults))
    # the expectations of tests/test_engine.py, under the port's names
    enc0 = "def_detr.transformer.encoder.layers.0.self_attn."
    assert labels[enc0 + "sampling_offsets.weight"] == "linear_proj"
    assert labels[enc0 + "temporal_sampling_offsets.weight"] == "temporal_linear_proj"
    assert labels["def_detr.transformer.reference_points.weight"] == "linear_proj"
    assert labels["mask_head.lay1.regular_conv.weight"] == "mask_head"
    assert labels["bbox_attention.q_linear.weight"] == "mask_head"
    assert labels["def_detr.backbone.0.body.layer2.0.conv1.weight"] == "backbone"
    assert labels["def_detr.backbone.0.body.conv1.weight"] == "frozen"
    assert labels["def_detr.backbone.0.body.layer1.0.conv1.weight"] == "frozen"
    assert labels["def_detr.query_embed.weight"] == "base"
    assert set(collections.Counter(labels.values())) == set(PARAM_GROUPS)
    # and every parameter lands in the group the JAX package gives it
    jlabels = jax_labels(variables["params"], _cfg(jax_cfg))
    flat = {}
    for path, label in jax.tree_util.tree_flatten_with_path(jlabels)[0]:
        flat["/".join(["params"] + [str(k.key) for k in path])] = \
            np.full((1,), PARAM_GROUPS.index(label), np.float32)
    # `from_jax_params` as a pure name mapping (q/k/v pack into one tensor;
    # its first element is q's label, and all three share a group)
    want = {k: PARAM_GROUPS[int(v[0])] for k, v in from_jax_params(flat).items()}
    assert sorted(want) == sorted(labels)
    for name, label in labels.items():
        assert want[name] == label, name


def test_group_lrs_and_frozen_keywords():
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import _param_group, group_base_lrs, match_name_keywords
    cfg = get_cfg_defaults()
    lrs = group_base_lrs(cfg)
    assert lrs["base"] == pytest.approx(2e-4)
    assert lrs["backbone"] == pytest.approx(2e-5)
    assert lrs["linear_proj"] == pytest.approx(2e-5)
    assert lrs["temporal_linear_proj"] == pytest.approx(2e-5)
    assert lrs["mask_head"] == pytest.approx(2e-4)
    assert match_name_keywords("def_detr.backbone.0.body.layer2.0.conv1.weight",
                               ["backbone.0"])
    assert not match_name_keywords("def_detr.bbox_embed.0.layers.0.weight", ["backbone.0"])
    cfg.SOLVER.FROZEN_PARAMS = ["query_embed"]
    assert _param_group("def_detr.query_embed.weight", cfg) == "frozen"


@pytest.mark.parametrize("step,want", [(0, 1.0), (19, 1.0), (20, 0.1), (40, 0.01)])
def test_multistep_schedule(step, want):
    from devis_tpu.engine import multistep_schedule as jax_schedule
    from devis_torch.engine import multistep_schedule
    sched = multistep_schedule(1.0, milestones=[2, 4], gamma=0.1, steps_per_epoch=10)
    assert sched(step) == pytest.approx(want)
    assert sched(step) == pytest.approx(float(jax_schedule(1.0, [2, 4], 0.1, 10)(step)))
    assert multistep_schedule(0.5, [], 0.1, 10)(1000) == 0.5


def test_optimizer_matches_optax_on_identical_gradients(pair):
    """Three AdamW steps on the same numpy gradients through both
    optimizers: the clip scales by the norm over ALL gradients, the frozen
    group's too; frozen parameters do not move; the schedule drops the rate
    at the third step's boundary."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.engine import create_train_state as jax_state
    from devis_tpu.engine import param_labels as jax_labels
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import create_train_state, global_norm, param_labels
    from devis_torch.models import build_model
    _, variables, tmodel = pair
    cfg = _cfg(get_cfg_defaults)
    model = build_model(NUM_CLASSES, cfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    labels = param_labels(model, cfg)
    jlabels = jax_labels(variables["params"], _cfg(jax_cfg))
    jstate = jax_state(_cfg(jax_cfg), variables, steps_per_epoch=2)
    jax_apply = jax.jit(lambda state, grads: state.apply_gradients(grads))
    tstate = create_train_state(cfg, model, steps_per_epoch=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(5)
    for step in range(3):
        # spread over magnitudes, the frozen group's the largest; the norm is
        # far above the clip's 0.1
        grads = jax.tree.map(
            lambda p, label: (rs.randn(*p.shape) * 10.0 ** rs.uniform(-4, 0)
                              * (300.0 if label == "frozen" else 1.0)).astype(np.float32),
            variables["params"], jlabels)
        jstate = jax_apply(jstate, jax.tree.map(jnp.asarray, grads))
        tgrads = _grads_to_port(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        norm = float(global_norm(model.parameters()))
        want_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                for g in jax.tree.leaves(grads)))
        assert norm == pytest.approx(want_norm, rel=1e-5)
        trained_only = np.sqrt(sum(float(tgrads[n].double().square().sum())
                                   for n in tgrads if labels[n] != "frozen"))
        assert trained_only < 0.5 * norm        # the frozen group counts
        tstate.apply_gradients()
    assert tstate.step == 3
    want = _grads_to_port(jstate.params)
    after = model.state_dict()
    moved = 0
    for name in want:
        delta_t = (after[name] - before[name]).numpy()
        delta_j = (want[name] - before[name]).numpy()
        if labels[name] == "frozen":
            assert not delta_t.any() and not delta_j.any(), name
            continue
        moved += 1
        # f32 moments on both sides: updates agree to 1e-3 of their size,
        # plus one rounding a step of the f32 parameter they are added to
        ulp = 3 * 2.0 ** -23 * float(before[name].abs().max())
        assert np.abs(delta_t - delta_j).max() <= 1e-3 * np.abs(delta_j).max() + ulp, name
    assert moved > 100


def test_nan_guard_skips_the_update(pair):
    """A non-finite loss leaves parameters and step as they were, reports
    finite = 0, and `train_one_epoch` raises."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import create_train_state, make_train_step, train_one_epoch
    from devis_torch.models import build_model
    _, _, tmodel = pair
    cfg = _cfg(get_cfg_defaults)
    model = build_model(NUM_CLASSES, cfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    state = create_train_state(cfg, model, STEPS_PER_EPOCH)
    step = make_train_step(model, cfg)
    batch = _batch()
    batch["images"][0, 0, 0, 0, 0] = np.nan
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = step(state, batch)
    assert float(metrics["finite"]) == 0.0 and state.step == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(FloatingPointError, match="not finite"):
        train_one_epoch(step, state, [batch], epoch=3)


# ---------------------------------------------------------------------------
# (e) the slice
# ---------------------------------------------------------------------------

def _jax_loss_fn(jmodel, variables, batch):
    """The JAX train step's loss for one clip with dropout off, from the
    same public pieces as `devis_tpu.engine.make_train_step`."""
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import matcher_cfg_from
    from devis_tpu.models.criterion import (build_weight_dict, clip_criterion,
                                            weighted_total)
    cfg = _cfg(jax_cfg)
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
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_train_step_matches_jax(pair):
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.engine import create_train_state as jax_state
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import (create_train_state, global_norm, make_train_step,
                                    param_labels)
    jmodel, variables, tmodel = pair
    cfg = _cfg(get_cfg_defaults)
    batch = _batch()
    grad_fn = _jax_loss_fn(jmodel, variables, batch)
    jstate = jax_state(_cfg(jax_cfg), variables, STEPS_PER_EPOCH)
    tstate = create_train_state(cfg, tmodel, STEPS_PER_EPOCH)
    step = make_train_step(tmodel, cfg)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}

    (jtotal, jlosses), jgrads = grad_fn(jstate.params)
    tstate, metrics = step(tstate, batch)

    # every loss, f32 on both sides: 1e-3 of its value
    assert set(jlosses) | {"loss", "grad_norm", "finite"} == set(metrics)
    assert float(metrics["finite"]) == 1.0
    assert float(metrics["loss"]) == pytest.approx(float(jtotal), rel=1e-3)
    for k, v in jlosses.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-3, abs=1e-5), k

    # every parameter's gradient (the step clipped them in place; compare
    # with the JAX gradient clipped by its own norm), frozen ones included.
    # f32 on both sides through 50 convolutions and group norms over a
    # handful of pixels: each tensor agrees to 1e-2 of its L2 norm (5e-3 seen
    # in the last backbone block, 2e-3 elsewhere), and no element is off by
    # more than 5e-3 of the model's largest gradient (a ReLU kink or a
    # max-pool tie may send one element's gradient another way)
    want = _grads_to_port(jgrads)
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(names) == sorted(want)
    jnorm = float(np.sqrt(sum(float(g.double().square().sum()) for g in want.values())))
    assert float(metrics["grad_norm"]) == pytest.approx(jnorm, rel=1e-3)
    assert jnorm > cfg.SOLVER.GRAD_CLIP_MAX_NORM
    scale = cfg.SOLVER.GRAD_CLIP_MAX_NORM / jnorm
    top = max(float(g.abs().max()) for g in want.values()) * scale
    params = dict(tmodel.named_parameters())
    for name in names:
        w = want[name] * scale
        err = params[name].grad - w
        assert float(err.norm()) <= 1e-2 * float(w.norm()) \
            + 1e-6 * cfg.SOLVER.GRAD_CLIP_MAX_NORM, name
        assert float(err.abs().max()) <= 5e-3 * top, name
    assert float(global_norm(tmodel.parameters())) == pytest.approx(
        cfg.SOLVER.GRAD_CLIP_MAX_NORM, rel=1e-4)

    # a second step on both sides, then the parameters. Adam's first steps
    # move each element by about its group's rate whatever its gradient's
    # size, so where a gradient is within rounding of zero the two sides may
    # step differently: over a tensor the mean difference stays below 2 % of
    # the mean movement (at least half a rate), and at most 5 % of its
    # elements (one of a group norm's 32) differ by more than a fifth of a
    # rate. The optimizer itself is held to 1e-3 on identical gradients above.
    jax_apply = jax.jit(lambda state, grads: state.apply_gradients(grads))
    jstate = jax_apply(jstate, jgrads)
    (_, _), jgrads2 = grad_fn(jstate.params)
    jstate = jax_apply(jstate, jgrads2)
    tstate, metrics2 = step(tstate, batch)
    assert tstate.step == 2 and float(metrics2["finite"]) == 1.0
    assert float(metrics2["loss"]) < float(metrics["loss"])
    labels = param_labels(tmodel, cfg)
    jparams = _grads_to_port(jstate.params)
    rates = {"base": 2e-4, "backbone": 2e-5, "linear_proj": 2e-5, "mask_head": 2e-4,
             "temporal_linear_proj": 2e-5}
    for name, p in tmodel.named_parameters():
        moved_t = (p.detach() - start[name]).abs()
        if labels[name] == "frozen":
            assert not moved_t.any(), name
            assert torch.equal(jparams[name], start[name]), name
            continue
        diff = (p.detach() - jparams[name]).abs()
        rate = rates[labels[name]]
        assert float(diff.mean()) <= 0.02 * max(float(moved_t.mean()), 0.5 * rate), name
        assert float((diff > 0.2 * rate).float().mean()) <= 0.05, name
