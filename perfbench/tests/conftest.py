"""Fixtures of the benchmark's CPU tests: the harness importable by its
top-level names, and `tiny`, which shrinks every cell for the CPU (1 + 2
transformer layers, the loader's scales by a fifth, clips of a hundred
pixels or so) while keeping its code paths. (At a tenth, a canvas two
columns wide at /32 made the CPU's bf16 convolution return NaN.)"""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)


@pytest.fixture
def tiny(monkeypatch):
    import harness
    from traffic import generate

    load, gload = harness.load, generate.load

    def small_load(kind, name):
        d = copy.deepcopy(load(kind, name))
        if kind == "configs":
            model = d["cfg"].setdefault("MODEL", {})
            model.setdefault("TRANSFORMER", {}).update(ENCODER_LAYERS=1, DECODER_LAYERS=2)
            model.setdefault("LOSS", {})["MASK_AUX_LOSS"] = [0]
            d["cfg"].setdefault("INPUT", {})["SCALE_FACTOR_TRAIN"] = 0.2
            d["reference"].update(enc_layers=1, dec_layers=2, mask_aux_loss=[0],
                                  train_scales=[96, 102, 108, 115, 121, 128], max_size=266)
        if kind == "workloads":
            d["trace_steps"], d["gap_steps"] = 2, 1
        return d

    def small_traffic(name):
        d = copy.deepcopy(gload(name))
        d["dataset_items"] = 32
        d.update(source_hw=[72, 128], max_size=240)
        d["block"]["scales"] = [64, 80, 96, 112] * 4
        return d

    monkeypatch.setattr(harness, "load", small_load)
    monkeypatch.setattr(generate, "load", small_traffic)
    return harness


@pytest.fixture
def card():
    """Skips where there is no CUDA card (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
