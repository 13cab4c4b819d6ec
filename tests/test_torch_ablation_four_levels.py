"""Tiny DeVIS models of the paper's four-level ablations (6-frame clips)
against the JAX package's `impl='xla'` twin on the CPU, f32, each from its
config file cut to a tiny size (`test_torch_ablations.ablation_cfg`):
ablation 3 with decoder attention that is not instance-aware, ablation 4
with instance-aware attention; both with the plain-conv mask head and the
3-d conv head. Eval outputs to 1e-3 of max|ref|; one train step's losses to
1e-3 and each gradient to 1e-2 of its norm."""
import pytest

from .test_torch_ablations import ablation_pair, check_eval, check_train_step
from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = 6
KEYS = ["3", "4"]


@pytest.mark.parametrize("key,check", [(k, c) for k in KEYS for c in ("eval", "step")])
def test_ablation_matches_jax(key, check):
    pair = ablation_pair(key, T)
    if check == "step":
        check_train_step(pair, key, T)
        return
    model = pair[2]
    t = model.def_detr.transformer
    assert t.variant == "devis"
    assert len(model.def_detr.input_proj) == 4
    assert t.decoder.layers[0].cross_attn.instance_aware == (key == "4")
    check_eval(pair)
