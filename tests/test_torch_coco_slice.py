"""The PyTorch port's COCO image slice as a whole against the JAX package's
`impl='xla'` twin, at a small size on the CPU, f32: the evaluation loop
(`evaluate_coco`: canvas, forward, device-side mask packing, host
postprocessing) and one image train step (every loss, every parameter's
gradient, the optimizer on identical gradients).

Weights are numpy draws over the JAX parameter tree, carried to the port with
`from_jax_params` and loaded strictly.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devis_torch.util.synthetic import SyntheticImageDataset, synthetic_image_batch
from devis_torch.util.weights import from_jax_params

from .test_torch_coco_modules import NUM_CLASSES, make_pair
from .test_torch_slice import _flatten

H, W = 64, 96
N_SLOTS = 4
STEPS_PER_EPOCH = 10


def _cfg(get_cfg_defaults, mask_on=True):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "coco"
    cfg.MODEL.MASK_ON = mask_on
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.LOSS.AUX_LOSS_WEIGHTING = True
    cfg.MODEL.DROPOUT = 0.0
    cfg.MODEL.NUM_QUERIES = 12
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 2
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.SOLVER.FROZEN_PARAMS = ["class_embed"]
    cfg.SOLVER.STEPS = [1]
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = H, W
    cfg.TEST.NUM_OUT = 5
    cfg.TEST.EVAL_BATCH_SIZE = 2
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def pair():
    return make_pair(_cfg, True, seed=5)


def test_jax_twin_loads_strictly_and_names_match(pair):
    _, variables, tmodel = pair
    state = from_jax_params(_flatten(variables))
    assert sorted(state) == sorted(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert v.shape == state[k].shape, k
    names = set(state)
    assert {"def_detr.transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
            "def_detr.transformer.decoder.layers.1.cross_attn.attention_weights.bias",
            "def_detr.transformer.decoder.layers.0.self_attn.in_proj_weight",
            "bbox_attention.q_linear_2.weight", "mask_head.lay1.offset_conv.weight",
            "mask_head.out_lay.regular_conv.bias", "def_detr.class_embed.1.weight",
            "def_detr.backbone.0.body.layer1.0.bn1.running_var"} <= names


class _Collect:
    def __init__(self):
        self.results = {}

    def update(self, res):
        assert not set(res) & set(self.results)
        self.results.update(res)

    def summarize(self):
        return {"n": len(self.results)}


def _jax_reference(jmodel, variables, dataset, chunks, canvas):
    """The JAX evaluation of `devis_tpu.inference.evaluate_coco`, stage by
    stage, on given chunks: pad to the canvas, forward, upsample + threshold
    (the masks its bit-packing carries), then boxes, labels and masks as its
    `_postprocess` makes them."""
    import cv2
    from devis_tpu.ops.interpolate import resize_bilinear
    Hc, Wc = canvas
    fwd = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))
    out = {}
    for chunk in chunks:
        samples = [dataset[i] for i in chunk]
        images = np.zeros((2, Hc, Wc, 3), np.float32)
        pad = np.ones((2, Hc, Wc), bool)
        for b, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            images[b, :h, :w] = s["image"]
            pad[b, :h, :w] = False
        for b in range(len(samples), 2):
            images[b], pad[b] = images[0], pad[0]
        tk = fwd(variables, jnp.asarray(images), jnp.asarray(pad))["top_k"]
        up = np.asarray(resize_bilinear(tk["masks"][..., None].astype(jnp.float32),
                                        (Hc, Wc))[..., 0])
        for b, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            oh, ow = s["orig_size"]
            bx = np.asarray(tk["boxes"][b])
            cx, cy, bw, bh = bx[:, 0] * ow, bx[:, 1] * oh, bx[:, 2] * ow, bx[:, 3] * oh
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh)
            masks = [cv2.resize((up[b, k, :h, :w] > 0).astype(np.uint8), (ow, oh),
                                interpolation=cv2.INTER_NEAREST) > 0
                     for k in range(up.shape[1])]
            margin = [cv2.resize(np.abs(up[b, k, :h, :w]), (ow, oh),
                                 interpolation=cv2.INTER_NEAREST) for k in range(up.shape[1])]
            out[s["image_id"]] = dict(scores=np.asarray(tk["scores"][b]),
                                      labels=np.asarray(tk["labels"][b]) + 1, boxes=boxes,
                                      masks=masks, margin=margin)
    return out


def test_evaluate_coco_matches_jax(pair):
    """Three images of two sizes in chunks of 2 on one canvas (the tail chunk
    padded with its first image), one resized back to a larger original."""
    from devis_torch.config import get_cfg_defaults
    from devis_torch.inference import evaluate_coco
    jmodel, variables, tmodel = pair
    dataset = SyntheticImageDataset(seed=11, sizes=[(56, 80), (64, 72), (56, 80)],
                                    orig_sizes=[(112, 160), (64, 72), (40, 57)])
    collect = _Collect()
    summary = evaluate_coco(tmodel, dataset, _cfg(get_cfg_defaults), collect, device="cpu",
                            verbose=False)
    assert summary == {"n": 3} and sorted(collect.results) == [1, 2, 3]
    from devis_tpu.inference import make_eval_buckets, pick_canvas
    canvas = pick_canvas(64, 80, make_eval_buckets(H, W))
    assert canvas == (64, 128)                     # canvases are multiples of 64
    want = _jax_reference(jmodel, variables, dataset, [[0, 1], [2]], canvas)
    for image_id, w in want.items():
        g = collect.results[image_id]
        # to 1e-3 of the largest reference value, as the clip slice; two
        # (query, class) pairs whose scores lie closer than that may come out
        # of the two top-k's in either order, so pair the entries up first
        tol = 1e-3 * w["scores"].max()
        assert np.abs(g["scores"] - w["scores"]).max() <= tol
        order = []
        for k in range(5):
            near = [i for i in range(5) if i not in order and g["labels"][i] == w["labels"][k]
                    and abs(g["scores"][i] - w["scores"][k]) <= tol]
            assert near, (image_id, k)
            order.append(min(near, key=lambda i: np.abs(g["boxes"][i] - w["boxes"][k]).max()))
        assert order == sorted(order) or np.diff(w["scores"][np.argsort(order)]).min() > -2 * tol
        g = {"boxes": g["boxes"][order], "masks": [g["masks"][i] for i in order]}
        assert np.abs(g["boxes"] - w["boxes"]).max() <= 1e-3 * np.abs(w["boxes"]).max()
        assert len(g["masks"]) == 5
        for gm, wm, margin in zip(g["masks"], w["masks"], w["margin"]):
            assert gm.shape == wm.shape == tuple(dataset.orig_sizes[image_id - 1])
            assert gm.dtype == bool
            # binary masks agree except where the logit is within 1e-3 of 0
            assert np.all((gm == wm) | (margin < 1e-3 * max(margin.max(), 1.0)))
            assert (gm != wm).mean() < 0.01


def test_evaluate_coco_feeds_a_detector_without_masks():
    from devis_torch.config import get_cfg_defaults
    from devis_torch.inference import evaluate_coco
    from devis_torch.models import build_model
    cfg = _cfg(get_cfg_defaults, mask_on=False)
    model = build_model(NUM_CLASSES, cfg, device="cpu")
    collect = _Collect()
    evaluate_coco(model, SyntheticImageDataset(1, [(56, 80)]), cfg, collect, device="cpu")
    res = collect.results[1]
    assert set(res) == {"scores", "labels", "boxes"} and res["boxes"].shape == (5, 4)
    assert res["labels"].min() >= 1


def _batch():
    return synthetic_image_batch(seed=4, canvas=(H, W), valid_hw=(56, 80), n_instances=2,
                                 max_instances=N_SLOTS, num_classes=NUM_CLASSES - 1,
                                 batch=2)


def _grads_to_port(tree):
    return from_jax_params(_flatten({"params": tree}))


def test_image_train_step_matches_jax(pair):
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.engine import create_train_state as jax_state
    from devis_tpu.models import matcher_cfg_from
    from devis_tpu.models.criterion import (build_weight_dict, image_criterion,
                                            weighted_total)
    from devis_torch.config import get_cfg_defaults
    from devis_torch.engine import (create_train_state, global_norm, make_train_step,
                                    param_labels)
    jmodel, variables, tmodel = pair
    tmodel = copy.deepcopy(tmodel)
    cfg = _cfg(get_cfg_defaults)
    jcfg = _cfg(jax_cfg)
    batch = _batch()
    frozen = {k: v for k, v in variables.items() if k != "params"}
    images, pad = jnp.asarray(batch["images"]), jnp.asarray(batch["pad_mask"])
    targets = jax.tree.map(jnp.asarray, batch["targets"])
    weight_dict = build_weight_dict(jcfg)
    mcfg = matcher_cfg_from(jcfg, clip=False)

    def loss_fn(params):
        out = jmodel.apply({"params": params, **frozen}, images, pad, targets=targets,
                           train=True, deterministic=True)
        losses = image_criterion(out, targets, NUM_CLASSES - 1, mcfg,
                                 jcfg.MODEL.LOSS.FOCAL_ALPHA, mask_on=True)
        return weighted_total(losses, weight_dict), losses

    jstate = jax_state(jcfg, variables, STEPS_PER_EPOCH)
    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params)
    tstate = create_train_state(cfg, tmodel, STEPS_PER_EPOCH)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tstate, metrics = make_train_step(tmodel, cfg)(tstate, batch)

    # every loss, f32 on both sides: 1e-3 of its value
    assert set(jlosses) | {"loss", "grad_norm", "finite"} == set(metrics)
    assert {"loss_mask", "loss_dice_0", "loss_giou_0"} <= set(metrics)
    assert float(metrics["finite"]) == 1.0 and tstate.step == 1
    assert float(metrics["loss"]) == pytest.approx(float(jtotal), rel=1e-3)
    for k, v in jlosses.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-3, abs=1e-5), k

    # every parameter's gradient, clipped by the global norm on both sides,
    # frozen tensors included: each to 1e-2 of its own L2 norm
    want = _grads_to_port(jgrads)
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(names) == sorted(want)
    jnorm = float(np.sqrt(sum(float(g.double().square().sum()) for g in want.values())))
    assert float(metrics["grad_norm"]) == pytest.approx(jnorm, rel=1e-3)
    scale = min(1.0, cfg.SOLVER.GRAD_CLIP_MAX_NORM / jnorm)
    params = dict(tmodel.named_parameters())
    for name in names:
        w = want[name] * scale
        assert float((params[name].grad - w).norm()) <= 1e-2 * float(w.norm()) \
            + 1e-6 * cfg.SOLVER.GRAD_CLIP_MAX_NORM, name
    assert float(global_norm(tmodel.parameters())) == pytest.approx(
        min(jnorm, cfg.SOLVER.GRAD_CLIP_MAX_NORM), rel=1e-4)

    # the parameter groups: class_embed is frozen by the config, and no
    # frozen tensor moved
    labels = param_labels(tmodel, cfg)
    assert labels["def_detr.class_embed.0.weight"] == "frozen"
    assert labels["def_detr.transformer.encoder.layers.0.self_attn.sampling_offsets.bias"] \
        == "linear_proj"
    assert labels["mask_head.lay3.regular_conv.weight"] == "mask_head"
    moved = 0
    for name, p in tmodel.named_parameters():
        same = torch.equal(p.detach(), start[name])
        assert same == (labels[name] == "frozen" or not bool(p.grad.any())), name
        moved += not same
    assert moved > 100

    # the optimizer on identical gradients: the JAX gradients on both sides,
    # from the same start; updates agree to 1e-3 of their size plus a few
    # roundings of the f32 parameter they are added to
    model2 = copy.deepcopy(pair[2])
    state2 = create_train_state(cfg, model2, STEPS_PER_EPOCH)
    for name, p in model2.named_parameters():
        p.grad = want[name].clone()
    state2.apply_gradients()
    jparams = _grads_to_port(jax.jit(lambda s, g: s.apply_gradients(g))(jstate, jgrads).params)
    for name, p in model2.named_parameters():
        delta_t = (p.detach() - start[name]).numpy()
        delta_j = (jparams[name] - start[name]).numpy()
        if labels[name] == "frozen":
            assert not delta_t.any() and not delta_j.any(), name
            continue
        ulp = 3 * 2.0 ** -23 * float(start[name].abs().max())
        assert np.abs(delta_t - delta_j).max() <= 1e-3 * np.abs(delta_j).max() + ulp, name
