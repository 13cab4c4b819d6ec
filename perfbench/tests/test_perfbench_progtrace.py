"""`progtrace.py` and the readers of the program's spans on a hand-built
trace: kernels, copies and runtime calls tied by correlation ids, the
program's spans on three threads (the loop's, autograd's device thread,
the loader's). Times are in milliseconds (x 1e6 ns), so a reader's ms read
as written here."""
import importlib.util
import os
import sys

import pytest
import torch

import progtrace
from conftest import BENCH

if os.path.dirname(BENCH) not in sys.path:       # the program, as the harness finds it
    sys.path.insert(0, os.path.dirname(BENCH))

MS = 1_000_000
MAIN, AUTOGRAD, LOADER = 11, 12, 13

SPANS = [  # (name, parent, thread, start, end) in ms
    ("loop.step", None, MAIN, 0, 1000),
    ("step.forward", "loop.step", MAIN, 10, 300),
    ("msda.K1_temporal_proj", "step.forward", MAIN, 20, 100),
    ("msda.K2_tap_window", "msda.K1_temporal_proj", MAIN, 30, 50),
    ("msda.K6_rows", "step.forward", MAIN, 120, 150),
    ("step.loss", "loop.step", MAIN, 300, 400),
    ("matcher.lsa", "step.loss", MAIN, 310, 390),
    ("matcher.lsa.wait", "matcher.lsa", MAIN, 310, 350),
    ("step.backward", "loop.step", MAIN, 400, 800),
    ("msda.K5_temporal_bwd", None, AUTOGRAD, 450, 600),
    ("step.update", "loop.step", MAIN, 800, 950),
    ("loop.metrics_read", None, MAIN, 1000, 1100),
    ("loader.batch", None, LOADER, 200, 700),
]
# (runtime call, correlation id, start) and the device work it launched
LAUNCHES = [
    ("cudaLaunchKernel", 1, 35, "msda_temporal_proj_win_kernel", 10),   # K2's span inside K1's
    ("cudaLaunchKernel", 2, 60, "msda_temporal_proj_win_kernel", 20),
    ("cudaLaunchKernel", 3, 130, "msda_rows_kernel", 5),
    ("cudaLaunchKernel", 4, 250, "elementwise", 7),       # during loader.batch: still forward
    ("cudaMemcpyAsync", 5, 315, "Memcpy DtoH", 3),
    ("cudaLaunchKernel", 6, 500, "bwd_gather_kernel<k5_bwd>", 40),   # autograd's thread
    ("cudaLaunchKernel", 7, 700, "elementwise", 6),
    ("cudaLaunchKernel", 8, 810, "multi_tensor_apply", 4),
    ("cudaLaunchKernel", 9, 1150, "elementwise", 3),      # outside the step's phases
]
SYNCS = [("cudaStreamSynchronize", 20, 330),              # the LSA's copy
         ("cudaStreamSynchronize", 21, 820),              # bool(ok) in finish
         ("cudaStreamSynchronize", 22, 1050),             # the metrics read
         ("cudaDeviceSynchronize", 23, 1200)]             # the harness's own: not counted


def hand_built():
    acts, calls = [], []
    t_dev = 0
    for name, corr, at, kernel, dur in LAUNCHES:
        calls.append((name, corr, at * MS, at * MS + MS))
        t_dev = max(t_dev, at + 2)
        acts.append((kernel, corr, t_dev * MS, (t_dev + dur) * MS))
        t_dev += dur
    acts.append(("stray", 99, 1300 * MS, 1302 * MS))     # no runtime call found
    calls += [(n, c, at * MS, at * MS + MS) for n, c, at in SYNCS]
    spans = [(n, p, th, s * MS, e * MS) for n, p, th, s, e in SPANS]
    return acts, calls, spans


def test_analyse_attributes_each_activity_once():
    a = progtrace.analyse(*hand_built(), start_ns=0)
    assert a["steps"] == 1
    assert a["device_ns"] == {"step.forward": 42 * MS, "step.loss": 3 * MS,
                              "step.backward": 46 * MS, "step.update": 4 * MS}
    assert a["unattributed_ns"] == 5 * MS and a["unlaunched_ns"] == 2 * MS
    assert sum(a["device_ns"].values()) + a["unattributed_ns"] == a["device_sum_ns"]
    assert a["op_ns"] == {"fwd": 35 * MS, "bwd": 40 * MS}     # K2's kernel counted once
    assert a["syncs"] == {"matcher.lsa.wait": 1, "step.update": 1, "loop.metrics_read": 1}
    assert a["lsa_host_ns"] == 40 * MS and a["lsa_calls"] == 1
    assert (a["loader_batches"], a["loader_ns"]) == (1, 500 * MS)
    assert sum(a["idle_ns"].values()) == sum(a["idle_by_span_ns"].values()) > 0
    assert "loader.batch" not in a["idle_by_span_ns"]


def test_spans_outside_the_profiled_span_are_left_out():
    acts, calls, spans = hand_built()
    late = [(n, p, th, s + 5000 * MS, e + 5000 * MS) for n, p, th, s, e in spans]
    a = progtrace.analyse(acts, calls, spans + late, start_ns=0)
    assert a["steps"] == 1 and a["loader_batches"] == 1
    # without the profiler's start the first step would begin before the first event
    assert progtrace.analyse(acts, calls, spans)["steps"] == 0
    assert progtrace.analyse([], [], spans) == {}


def test_innermost_sweeps_nested_spans():
    spans = [("a", None, 1, 0, 100), ("b", "a", 1, 10, 20), ("c", None, 2, 30, 40),
             ("loader.batch", None, 3, 0, 100)]
    got = progtrace.innermost(spans, [5, 15, 25, 35, 99, 100])
    assert [g[0] if g else None for g in got] == ["a", "b", "a", "c", "a", None]


class _Ev:
    def __init__(self, name, corr, s, e, cuda):
        self._v = (name, corr, s, e, cuda)

    def name(self):
        return self._v[0]

    def correlation_id(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


class _Span:
    """What the readers see of the harness's `devtrace.Span`."""

    def __init__(self, name, events):
        results = type("R", (), {"events": lambda self: events,
                                 "trace_start_ns": lambda self: 0})()
        self.name = name
        self.prof = type("P", (), {"profiler": type("K", (), {"kineto_results": results})()})()


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(mod, ctx, events):
    """Reads `mod` as the harness's `run` does, its spans in its frame."""
    spans = [(_Span("span", events), 8, False), (_Span("gaps", []), 3, True)]  # noqa: F841
    return mod.read(ctx)


EXPECT = {"fwd_device_ms.train": 42.0, "loss_device_ms.train": 3.0,
          "bwd_device_ms.train": 46.0, "update_device_ms.train": 4.0,
          "lsa_host_ms.train": 40.0, "host_syncs.train": 3.0, "loader_busy_ms.train": 500.0,
          "msda_fwd_op_roofline.train": 10.0, "msda_bwd_op_roofline.train": 10.0}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_each_reader_on_the_hand_built_trace(name, monkeypatch):
    from devis_torch.util import trace
    acts, calls, spans = hand_built()
    events = [_Ev(n, c, s, e, True) for n, c, s, e in acts] + [
        _Ev(n, c, s, e, False) for n, c, s, e in calls]
    monkeypatch.setattr(trace, "records", lambda: spans)
    monkeypatch.setattr(progtrace, "_LAST", [None, {}])
    ctx = {"traced_calls": [{"dir": "fwd", "bound_s": 0.0035}, {"dir": "bwd", "bound_s": 0.004}]}
    mod = reader(name)
    assert run(mod, ctx, events) == pytest.approx(EXPECT[name])
    assert mod.read(ctx) is None                # no harness frame: nothing to read


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_each_reader_reads_nothing_without_the_program_s_spans(name, monkeypatch):
    from devis_torch.util import trace
    acts, calls, _ = hand_built()
    events = [_Ev(n, c, s, e, True) for n, c, s, e in acts] + [
        _Ev(n, c, s, e, False) for n, c, s, e in calls]
    monkeypatch.setattr(trace, "records", lambda: [])
    monkeypatch.setattr(progtrace, "_LAST", [None, {}])
    assert run(reader(name), {"traced_calls": []}, events) is None


def test_the_readers_read_nothing_where_the_program_has_no_tracer(monkeypatch):
    import devis_torch.util
    acts, calls, _ = hand_built()
    events = [_Ev(n, c, s, e, True) for n, c, s, e in acts]
    monkeypatch.delattr(devis_torch.util, "trace")
    monkeypatch.setitem(sys.modules, "devis_torch.util.trace", None)
    monkeypatch.setattr(progtrace, "_LAST", [None, {}])
    ctx = {"traced_calls": [{"dir": "fwd", "bound_s": 0.0035}]}
    assert [run(reader(n), ctx, events) for n in sorted(EXPECT)] == [None] * len(EXPECT)
