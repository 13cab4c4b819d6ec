"""The port's checkpoints (`devis_torch.util.checkpoint`) and resume:

- the weight surgery (`shift_class_neurons`, `prefix_def_detr`,
  `adapt_weights_devis`) gives the JAX package's output, array for array
  (exact), on seeded state dicts at the reference's widths, under every
  combination of its flags; the keys it fills are the port's own
  `state_dict` names;
- `load_torch_checkpoint` + `load_state_into` read a `.pth` the test writes
  (a reference-style {"model": ..., "args": Namespace}) into the model;
- save then restore round-trips the model, AdamW and the step exactly;
- on the CPU, 2 train steps, save, restore into a model built from another
  seed, 1 step: parameters and AdamW state bit-equal to 3 uninterrupted
  steps (dropout on, its generator's state restored).
"""
import argparse
import itertools

import numpy as np
import pytest
import torch

from devis_torch.util import checkpoint as ckpt
from devis_tpu.util import checkpoint as jckpt

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, H, W = 2, 64, 96


def _source_state(rs, lvl=4):
    """A COCO-style checkpoint at the reference's widths (8 heads, 4
    levels, 4 points, 256 channels), without the def_detr prefix."""
    s = {"transformer.level_embed": (4, 256), "query_embed.weight": (300, 512),
         "class_embed.0.weight": (91, 256), "class_embed.0.bias": (91,),
         "backbone.0.body.conv1.weight": (64, 3, 7, 7),
         "input_proj.2.0.weight": (256, 2048, 1, 1), "input_proj.2.0.bias": (256,),
         "bbox_attention.q_linear.weight": (256, 256), "mask_head.lay1.weight": (264, 264, 3, 3)}
    for part, attn in (("encoder", "self_attn"), ("decoder", "cross_attn")):
        base = f"transformer.{part}.layers.0.{attn}"
        s.update({f"{base}.sampling_offsets.weight": (256, 256),
                  f"{base}.sampling_offsets.bias": (256,),
                  f"{base}.attention_weights.weight": (128, 256),
                  f"{base}.attention_weights.bias": (128,),
                  f"{base}.value_proj.weight": (256, 256)})
    return {k: rs.randn(*shape).astype(np.float32) for k, shape in s.items()}


def _model_keys(lvl, T_, w_enc, pt):
    keys = {"def_detr.transformer.level_embed": (lvl, 256),
            "def_detr.query_embed.weight": (60 * T_, 512),
            "def_detr.class_embed.0.weight": (41, 256),
            "def_detr.class_embed.0.bias": (41,),
            "def_detr.backbone.0.body.conv1.weight": (64, 3, 7, 7),
            "def_detr.input_proj.0.0.weight": (256, 2048, 1, 1),
            "def_detr.input_proj.2.0.weight": (256, 2048, 1, 1),
            "bbox_attention.q_linear.weight": (256, 256), "mask_head.lay9.weight": (1, 1)}
    for part, attn, win in (("encoder", "self_attn", w_enc), ("decoder", "cross_attn", T_ - 1)):
        base = f"def_detr.transformer.{part}.layers.0.{attn}"
        keys.update({f"{base}.sampling_offsets.weight": (8 * lvl * 4 * 2, 256),
                     f"{base}.sampling_offsets.bias": (8 * lvl * 4 * 2,),
                     f"{base}.attention_weights.weight": (8 * lvl * 4, 256),
                     f"{base}.attention_weights.bias": (8 * lvl * 4,),
                     f"{base}.temporal_sampling_offsets.weight": (8 * win * lvl * pt * 2, 256),
                     f"{base}.temporal_sampling_offsets.bias": (8 * win * lvl * pt * 2,),
                     f"{base}.temporal_attention_weights.weight": (8 * win * lvl * pt, 256),
                     f"{base}.temporal_attention_weights.bias": (8 * win * lvl * pt,),
                     f"{base}.value_proj.weight": (256, 256)})
    return keys


FLAGS = list(itertools.product([4, 1], [True, False], [True, False], [True, False]))


@pytest.mark.parametrize("lvl,class_logits,query_embds,temporal", FLAGS)
def test_adapt_weights_devis_equals_the_jax_package(lvl, class_logits, query_embds, temporal):
    rs = np.random.RandomState(lvl)
    state = _source_state(rs)
    keys = _model_keys(lvl, T_=6, w_enc=5, pt=4)
    # the class transplant fills a head of 41 rows from the 41 YouTube-VIS ids
    # (40 with focal loss); focal loss is on wherever the head is not transplanted
    kw = dict(lvl_res=lvl, focal_loss=not class_logits, finetune_class_logits=class_logits,
              num_frames=6, finetune_query_embds=query_embds,
              finetune_temporal_modules=temporal, enc_connect_all_frames=True,
              enc_temporal_window=4, enc_n_temporal_points=4, dec_n_temporal_points=4)
    got = ckpt.adapt_weights_devis(dict(state), keys, **kw)
    want = jckpt.adapt_weights_devis(dict(state), keys, **kw)
    assert sorted(got) == sorted(want) and got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert tuple(got[k].shape) == keys[k], k
    assert any("temporal" in k for k in got) == temporal


def test_shift_and_prefix_equal_the_jax_package():
    state = _source_state(np.random.RandomState(0))
    for fn, jfn in ((ckpt.shift_class_neurons, jckpt.shift_class_neurons),
                    (ckpt.prefix_def_detr, jckpt.prefix_def_detr)):
        got, want = fn(dict(state)), jfn(dict(state))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    shifted = ckpt.shift_class_neurons(state)["class_embed.0.weight"]
    np.testing.assert_array_equal(shifted[-1], state["class_embed.0.weight"][0])


def _cfg(dropout=0.1):
    from devis_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.DROPOUT = dropout
    cfg.MODEL.NUM_QUERIES = 8
    cfg.MODEL.HIDDEN_DIM = 64
    cfg.MODEL.DIM_FEEDFORWARD = 128
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 2
    cfg.MODEL.DEVIS.NUM_FRAMES = T
    cfg.SOLVER.STEPS = [1]
    cfg.freeze()
    return cfg


def _batch(seed):
    from devis_torch.util.synthetic import synthetic_clip_batch
    return synthetic_clip_batch(seed=seed, num_frames=T, canvas=(H, W), valid_hw=(56, 80),
                                n_instances=2, max_instances=3, num_classes=6)


def _model(seed):
    from devis_torch.models import build_model
    return build_model(7, _cfg(), device="cpu", seed=seed)


def test_surgery_targets_the_ports_own_names():
    keys = ckpt.model_keys(_model(0))
    for k in ("def_detr.transformer.encoder.layers.0.self_attn.temporal_sampling_offsets.weight",
              "def_detr.transformer.decoder.layers.1.cross_attn.temporal_attention_weights.bias",
              "def_detr.query_embed.weight", "def_detr.class_embed.0.weight",
              "def_detr.transformer.level_embed", "def_detr.input_proj.2.0.weight"):
        assert k in keys, k


def test_reference_pth_loads_through_the_surgery(tmp_path):
    model = _model(0)
    src = {k.replace("def_detr.", "", 1): v.clone() + 1.0
           for k, v in model.state_dict().items() if v.is_floating_point()}
    path = str(tmp_path / "ref.pth")
    torch.save({"model": src, "args": argparse.Namespace(lr=1e-4), "epoch": 3}, path)
    state = ckpt.prefix_def_detr(ckpt.load_torch_checkpoint(path))
    missing, unused = ckpt.load_state_into(model, state)
    assert not unused
    assert all(not model.state_dict()[k].is_floating_point() for k in missing)
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            torch.testing.assert_close(v, src[k.replace("def_detr.", "", 1)], rtol=0, atol=0)
    bad = dict(state)
    bad["def_detr.query_embed.weight"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="query_embed.weight"):
        ckpt.load_state_into(model, bad)


def _steps(state, step, gen, seeds):
    for s in seeds:
        state, metrics = step(state, _batch(s), gen)
        assert float(metrics["finite"]) == 1.0
    return state


def _assert_same_state(a, b):
    for (n, p), (m, q) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert n == m
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(v, sb["state"][i][k], rtol=0, atol=0)
    assert a.step == b.step


def test_save_then_restore_round_trips(tmp_path):
    from devis_torch.engine import create_train_state, make_train_step
    model = _model(1)
    state = create_train_state(_cfg(), model, steps_per_epoch=10)
    gen = torch.Generator().manual_seed(3)
    state = _steps(state, make_train_step(model, _cfg()), gen, [0])
    ckpt.save_checkpoint(str(tmp_path / "c"), state, {"dropout": gen.get_state(), "n": 7})
    other = create_train_state(_cfg(), _model(2), 10, restore_from=str(tmp_path / "c"))
    _assert_same_state(state, other)
    assert other.rng_states["n"] == 7
    assert torch.equal(other.rng_states["dropout"], gen.get_state())


def test_resume_is_exact(tmp_path):
    from devis_torch.engine import create_train_state, make_train_step
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    seeds = [0, 1, 2]
    model = _model(1)
    ref = create_train_state(_cfg(), model, steps_per_epoch=2)
    ref = _steps(ref, make_train_step(model, _cfg()), torch.Generator().manual_seed(3), seeds)

    model = _model(1)
    first = create_train_state(_cfg(), model, steps_per_epoch=2)
    gen = torch.Generator().manual_seed(3)
    first = _steps(first, make_train_step(model, _cfg()), gen, seeds[:2])
    ckpt.save_checkpoint(str(tmp_path / "checkpoint"), first, {"dropout": gen.get_state()})

    model = _model(9)                                  # other weights until restored
    resumed = create_train_state(_cfg(), model, 2, restore_from=str(tmp_path / "checkpoint"))
    gen = torch.Generator()
    gen.set_state(resumed.rng_states["dropout"])
    resumed = _steps(resumed, make_train_step(model, _cfg()), gen, seeds[2:])
    assert resumed.step == 3
    _assert_same_state(resumed, ref)
