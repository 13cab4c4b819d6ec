"""The port's tracer (`devis_torch/util/trace.py`) on the CPU: the off path,
parents per thread, self time, the ring's bound, the clock against
torch.profiler's, the span tree of one train step of a tiny clip model,
and the CLI's `--trace`."""
import collections
import json
import os
import threading
import time

import pytest
import torch

from devis_torch.util import trace

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tracing():
    trace.disable()
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r[0]].append(r)
    return out


def test_off_is_one_shared_no_op_without_record_function(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or torch.profiler.record_function)
    trace.disable()
    trace.reset()
    a, b = trace.span("a"), trace.span("b")
    assert a is b and not trace.enabled()
    with a:
        with b:
            pass
    assert calls == [] and trace.records() == [] and trace.totals() == {}


def test_follow_profiler_turns_spans_on_only_while_one_records():
    trace.disable()
    trace.follow_profiler()
    assert not trace.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.follow_profiler()
        assert trace.enabled()
    trace.follow_profiler()
    assert not trace.enabled()
    trace.enable()
    trace.follow_profiler()             # enable() holds without a profiler
    assert trace.enabled()
    trace.disable()


def test_parents_are_kept_per_thread(tracing):
    inside, done = threading.Event(), threading.Event()

    def worker():
        with trace.span("w.outer"):
            inside.set()
            with trace.span("w.inner"):
                done.wait(5)

    with trace.span("m.outer"):
        t = threading.Thread(target=worker, name="worker")
        t.start()
        inside.wait(5)
        with trace.span("m.inner"):      # open while the worker's spans are open
            pass
        done.set()
        t.join()
    got = by_name(trace.records())
    (mi,), (mo,), (wi,), (wo,) = (got[n] for n in ("m.inner", "m.outer", "w.inner", "w.outer"))
    assert mi[1] == "m.outer" and mo[1] is None
    assert wi[1] == "w.outer" and wo[1] is None
    assert mi[2] == mo[2] == threading.get_native_id() and wi[2] == wo[2] != mi[2]
    assert mo[3] <= wo[3] and wo[4] <= mo[4]       # the clock is shared across threads


def test_self_time_is_duration_less_the_children(tracing):
    with trace.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with trace.span("child"):
                time.sleep(0.003)
    got = by_name(trace.records())
    (outer,) = got["outer"]
    children = sum(e - s for _, _, _, s, e in got["child"])
    n, total, own = trace.totals()["outer"]
    assert (n, total) == (1, outer[4] - outer[3])
    assert own == total - children and own >= 2_000_000
    n, total, own = trace.totals()["child"]
    assert n == 2 and own == total == children
    table = trace.table()
    assert table["outer"]["count"] == 1 and table["outer"]["self_ms"] == own_ms(outer, children)


def own_ms(outer, children):
    return (outer[4] - outer[3] - children) / 1e6


def test_the_ring_is_bounded_and_the_totals_keep_counting(tracing, monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=10))
    for i in range(25):
        with trace.span(f"s{i % 3}"):
            pass
    recs = trace.records()
    assert len(recs) == 10 and [r[0] for r in recs] == [f"s{i % 3}" for i in range(15, 25)]
    assert sum(n for n, _, _ in trace.totals().values()) == 25
    before = trace.totals()
    with trace.span("s0"):
        pass
    _, _, _, s, e = trace.records()[-1]
    assert trace.table(before) == {"s0": {"count": 1, "total_ms": (e - s) / 1e6,
                                          "self_ms": (e - s) / 1e6}}


def test_a_span_and_its_profiler_range_share_the_clock(tracing):
    """Each span starts within 50 us of its record_function range (the
    median of nine; every one within a millisecond, whatever else the
    machine runs)."""
    with trace.span("warm"):              # the first record_function call is slow
        pass
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(9):
            with trace.span(f"probe.{i}"):
                torch.ones(64).sum()
    ranges = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("probe.")}
    spans = {r[0]: r for r in trace.records()}
    assert set(ranges) == set(spans) == {f"probe.{i}" for i in range(9)}
    gaps = sorted(abs(ranges[name].start_ns() - r[3]) for name, r in spans.items())
    assert gaps[4] < 50_000 and gaps[-1] < 1_000_000, gaps


def _tiny_cfg():
    from devis_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()     # tests/test_torch_engine.py's `_cfg`, one more decoder layer
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
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 3
    cfg.MODEL.DEVIS.NUM_FRAMES = 2
    cfg.SOLVER.STEPS = [1]
    cfg.freeze()
    return cfg


def _counted_ops():
    from devis_torch.ops import deform_conv as dcn
    from devis_torch.ops import ms_deform_attn_cuda as K
    return [K.msda_temporal_proj, K.msda_tap_window, K.msda_temporal, K.msda_temporal_bwd,
            K.msda_rows, K.msda_rows_bwd, K.msda_proj, K.msda_taps_bwd, K.msda_taps,
            dcn.modulated_deform_conv2d, dcn.deform_conv2d]


def test_one_clip_step_gives_the_span_tree(tracing):
    from devis_torch.engine import create_train_state, make_train_step, train_one_epoch
    from devis_torch.models import build_model
    from devis_torch.util.synthetic import synthetic_clip_batch
    cfg = _tiny_cfg()
    model = build_model(7, cfg, device="cpu")
    state = create_train_state(cfg, model, 10)
    batch = synthetic_clip_batch(seed=3, num_frames=2, canvas=(64, 96), valid_hw=(56, 80),
                                 n_instances=2, max_instances=3, num_classes=6)
    ops = _counted_ops()
    for fn in ops:
        fn.plain_calls = 0
        if hasattr(fn, "launches"):
            fn.launches = 0
    trace.reset()
    train_one_epoch(make_train_step(model, cfg), state, [batch], print_freq=10 ** 9)
    recs = trace.records()
    got = by_name(recs)
    assert len(got["loop.step"]) == 1 and len(got["loop.metrics_read"]) == 1
    assert {r[1] for r in got["loop.step"] + got["loop.metrics_read"]} == {None}
    for phase in ("step.forward", "step.loss", "step.backward", "step.update"):
        assert got[phase] and {r[1] for r in got[phase]} == {"loop.step"}, phase
    lsa = got["matcher.lsa"]
    assert len(lsa) == cfg.MODEL.TRANSFORMER.DECODER_LAYERS      # one a decoder level
    # the levels with a mask loss are matched in the model's forward (their
    # masks are computed for the matched trajectories), the rest by the criterion
    in_forward = 1 + len(cfg.MODEL.LOSS.MASK_AUX_LOSS)
    assert sorted(r[1] for r in lsa) == sorted(
        ["step.forward"] * in_forward + ["step.loss"] * (len(lsa) - in_forward))
    assert [r[1] for r in got["matcher.lsa.wait"]] == ["matcher.lsa"] * len(lsa)
    msda = [r for r in recs if r[0].startswith(("msda.", "dcn."))]
    assert len(msda) == sum(getattr(fn, "launches", 0) + fn.plain_calls for fn in ops) > 0
    assert {r[1] for r in msda} <= {"step.forward", "msda.K1_temporal_proj"} | {
        r[0] for r in msda}
    step = got["loop.step"][0]
    inside = [r for r in recs if r[0].startswith("step.")]
    assert all(step[3] <= r[3] and r[4] <= step[4] for r in inside)
    n, total, own = trace.totals()["loop.step"]
    assert own == total - sum(r[4] - r[3] for r in inside)


def test_the_cli_flag_writes_the_epoch_record_and_the_chrome_trace(tmp_path):
    from devis_torch.main import main
    out = str(tmp_path / "out")
    main(["--config-file", os.path.join(ROOT, "configs", "synthetic_smoke.yaml"), "--trace",
          "MODEL.HIDDEN_DIM", "64", "MODEL.DIM_FEEDFORWARD", "128", "OUTPUT_DIR", out,
          "INPUT.SCALE_FACTOR_TRAIN", "0.25", "TEST.START_EVAL_EPOCH", "2"],
         device="cpu", max_steps=1)
    assert not trace.enabled()                     # the flag ends with the run
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    (rec,) = [r for r in recs if r.get("kind") == "trace_epoch"]
    spans = rec["spans"]
    assert rec["step"] == 0 and spans["loop.step"]["count"] == 1
    assert spans["loader.batch"]["count"] >= 1 and spans["matcher.lsa"]["count"] >= 1
    for s in spans.values():
        assert 0 <= s["self_ms"] <= s["total_ms"] + 1e-9
    events = json.load(open(os.path.join(out, "spans.json")))["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"loop.step", "step.forward", "step.loss", "step.backward", "step.update",
            "matcher.lsa", "loader.batch"} <= names
    threads = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert "TrainLoader" in threads
