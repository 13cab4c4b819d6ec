"""The frozen reference against the port's plain path (the port on the
CPU runs every op's plain version) at a tiny size in float32: the same
seeded weights give the same forward outputs, loss and gradients. This
test imports both; the reference's own modules import nothing of the
port."""
import numpy as np
import pytest
import torch

import weights
from reference import model as RM
from reference import train as RT

torch.backends.cuda.matmul.allow_tf32 = False


def _port(tiny, name):
    from devis_torch.config import get_cfg_defaults
    conf = tiny.load("configs", name)
    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(conf["cfg"])
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.freeze()
    with torch.device("meta"):
        from devis_torch.models import build_model
        model = build_model(conf["num_classes"], cfg, device="meta")
    model = model.to_empty(device="cpu")
    weights.fill(weights.named_tensors(model), conf["init"], 5)
    return conf, cfg, model


def _batch(tiny, conf, cfg, traffic, seed):
    from devis_torch.main import build_train_loader
    from traffic import generate
    ds = generate.Dataset(generate.load(traffic), seed)
    loader = build_train_loader(cfg, ds)
    ds.assign(loader.batch_indices())
    idx = loader.batch_indices()[0]
    a = conf["reference"]
    items = RT.collate([ds[int(i)] for i in idx], a["slots"], a["train_scales"], a["max_size"])
    return loader.make_batch(idx), items


def test_same_names_shapes_and_seeded_tensors(tiny):
    for name in ("devis_r50_yt19",):
        conf, _, port = _port(tiny, name)
        ref = RM.build(conf["reference"], "cpu")
        weights.fill(weights.named_tensors(ref), conf["init"], 5)
        p, r = dict(weights.named_tensors(port)), dict(weights.named_tensors(ref))
        assert sorted(p) == sorted(r)
        for k in p:
            assert torch.equal(p[k], r[k]), k


@pytest.mark.parametrize("name,traffic", [("devis_r50_yt19", "yt19_clips")])
def test_collate_works_out_the_port_s_batch(tiny, name, traffic):
    conf, cfg, _ = _port(tiny, name)
    batch, items = _batch(tiny, conf, cfg, traffic, 3)
    stack = lambda k: np.stack([it[k] for it in items])
    assert np.array_equal(batch["images"], stack("images"))
    assert np.array_equal(batch["pad_mask"], stack("pad"))
    for k in items[0]["targets"]:
        assert np.array_equal(batch["targets"][k], np.stack([it["targets"][k] for it in items])), k


@pytest.mark.parametrize("name,traffic", [("devis_r50_yt19", "yt19_clips")])
def test_loss_and_gradients_match_the_port_in_float32(tiny, name, traffic):
    from devis_torch.engine import make_train_step
    from devis_torch.models.layers import set_dropout_generator
    conf, cfg, port = _port(tiny, name)
    batch, items = _batch(tiny, conf, cfg, traffic, 4)
    a = conf["reference"]
    ref = RM.build(a, "cpu")
    weights.fill(weights.named_tensors(ref), conf["init"], 5)
    port.train()
    ref.train()
    set_dropout_generator(port, torch.Generator().manual_seed(9))
    RM.set_dropout_generator(ref, torch.Generator().manual_seed(9))
    step = make_train_step(port, cfg)
    captured = {}
    state = type("S", (), {})()
    state.apply_gradients = lambda: captured.setdefault("g", {
        n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None}) and 0.0
    _, metrics = step(state, batch, torch.Generator().manual_seed(9))
    loss = RT.batch_loss(ref, items, a, "cpu")
    assert float(loss) == pytest.approx(float(metrics["loss"]), rel=1e-4)
    g_ref = {n: p.grad for n, p in ref.named_parameters() if p.grad is not None}
    assert sorted(g_ref) == sorted(captured["g"])
    total = torch.linalg.vector_norm(torch.stack([g.norm() for g in g_ref.values()]))
    for n, g in g_ref.items():
        err = (captured["g"][n] - g).norm()
        assert err <= 1e-3 * g.norm() + 1e-5 * total, n
