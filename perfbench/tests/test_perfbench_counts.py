"""The FLOP and byte counts against hand arithmetic at small shapes."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH
from counts import msda
from counts.flops import StepFlops
from reference import model as M


def arch(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)["reference"]


def test_pyramid_of_the_canvases():
    assert msda.pyramid(640, 1344) == [(160, 336), (80, 168), (40, 84), (20, 42), (10, 21)]
    assert msda.pyramid(1088, 832) == [(272, 208), (136, 104), (68, 52), (34, 26), (17, 13)]
    assert msda.pyramid(288, 512) == [(72, 128), (36, 64), (18, 32), (9, 16), (5, 8)]


def test_one_attention_call_by_hand():
    # B 1, S 10, Q 2, M 1, D 4, 2 levels of 1 point: 4 taps
    fwd, bwd = msda.attn_calls("x", "K3", "K5", 1, 10, 2, 1, 4, 2, 1, fwd_in=8)
    assert fwd["flops"] == 4 * 4 * 4 * 2 and bwd["flops"] == 4 * 4 * 4 * 4
    assert fwd["bytes"] == 10 * 4 * 2 + 8 + 2 * 4 * 2
    assert bwd["bytes"] == 80 + 4 * 12 + 16 + 80 + 4 * 12
    assert fwd["bound_s"] == max(104 / 3.35e12, 128 / 67e12)
    k9 = msda.attn_calls("x", "K6", "K9", 1, 10, 2, 1, 4, 2, 1, fwd_in=8)[1]
    assert k9["bytes"] == 80 + 4 * 4 * 8 + 16 + 80 + 4 * 4 * 4


def test_calls_of_a_step_match_the_kernel_counts():
    def count(calls):
        out = {}
        for c in calls:
            out[c["op"]] = out.get(c["op"], 0) + 1
        return out
    clip = count(msda.step_calls(arch("devis_r50_yt19"), (640, 1344), 1))
    assert clip == {"K1": 6, "K3": 6, "K5": 12, "K6": 12, "K7": 12}
    assert count(msda.step_calls(arch("devis_r50_yt19"), (640, 1344), 2)) == {
        k: 2 * n for k, n in clip.items()}


def test_clip_encoder_taps_by_hand():
    a = arch("devis_r50_yt19")
    calls = msda.step_calls(a, (640, 1344), 1)
    enc = [c for c in calls if c["name"] == "encoder.0" and c["dir"] == "fwd"][0]
    S = 80 * 168 + 40 * 84 + 20 * 42 + 10 * 21
    taps = 6 * S * 8 * 24 * 4                 # T, Q = S, heads, 6 frames x 4 levels, points
    assert enc["flops"] == taps * 4 * 32 * 2
    assert enc["bytes"] == 6 * S * 256 * 2 * 2 + 6 * S * (4 * 2 * 4 + 8 * 24 * 4 * 3 * 2)


def test_resnet50_forward_flops_are_the_published_count():
    body = M.ResNet50(M.identity)
    counter = FlopCounterMode(display=False)
    with counter:
        body(torch.zeros(1, 3, 224, 224, device="meta"))
    # 4.09 GMACs at 224 x 224 (torchvision's count for ResNet-50, conv + fc;
    # the trunk here has no fc: 2048 x 1000 MACs less)
    assert counter.get_total_flops() == pytest.approx(2 * (4.089e9 - 2048 * 1000), rel=5e-3)


def test_step_flops_add_the_taps_and_grow_with_the_content():
    a = dict(arch("devis_r50_yt19"), enc_layers=1, dec_layers=2, mask_aux_loss=[0])
    sf = StepFlops(a)
    small, big = sf.item((64, 96)), sf.item((128, 192))
    assert big > 3 * small
    assert sf.step([(64, 96), (64, 96)]) == 2 * small
    assert small > msda.step_gather_flops(a, [(64, 96)]) > 0
