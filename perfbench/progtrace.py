"""The program's own spans laid over a profiled span of the device trace.

`devis_torch.util.trace` records each span as (name, parent, thread,
start_ns, end_ns) on the clock of torch.profiler's events. `analyse` gives
each device activity (kernel, copy, set) to the spans open when the runtime
call that launched it ran, found by its correlation id, and reads:

  * the device time of each phase of the train step (`step.forward`,
    `step.loss`, `step.backward`, `step.update`: the `step.*` span open at
    the launch, on whichever thread launched it; autograd's device thread
    launches the backward's kernels while the loop's thread waits in
    `step.backward`), and what no phase holds (`unattributed`);
  * the device time of the deformable-attention ops: kernels launched under
    an outermost `msda.*` span, forward (K1, K2, K3, K6, K8) and backward
    (K5, K7, K9), each op's glue included;
  * the runtime calls that block the host, inside the loop's spans
    (`loop.step`, `loop.metrics_read`), each by the innermost span open at
    it (the loader thread's `loader.batch` left out: it launches nothing; a
    profile of CUDA activity alone gives every runtime call one thread id,
    so threads are told apart by time: the loop's thread and autograd's
    device thread never run spans side by side);
  * host time: `matcher.lsa` less its `matcher.lsa.wait`; `loader.batch`;
  * the device's idle gaps by the phase (or loop span) open at their middle.

The harness hands its readers a summary of the profiled span without
correlation ids, so `profiled_span` finds the profiler itself in the
harness's `run` frame (its `spans`); where it, or the program's tracer, is
missing, there is nothing to read and the readers return None.
"""
from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

PHASES = ("step.forward", "step.loss", "step.backward", "step.update")
LOOP = ("loop.step", "loop.metrics_read")
FWD_OPS = ("msda.K1_temporal_proj", "msda.K2_tap_window", "msda.K3_temporal", "msda.K6_rows",
           "msda.K8_proj")
BWD_OPS = ("msda.K5_temporal_bwd", "msda.K7_rows_bwd", "msda.K9_taps_bwd")
# runtime calls that return only once the device has caught up (a copy to
# or from pageable memory is `cudaMemcpyAsync` followed by
# `cudaStreamSynchronize`: one blocking read)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})

# device activities and runtime calls: (name, correlation id, start_ns, end_ns)
Activity = Tuple[str, int, int, int]
Call = Tuple[str, int, int, int]
HOST_ONLY = ("loader.batch",)           # spans of threads that launch nothing
Span = Tuple[str, Optional[str], int, int, int]


class Intervals:
    """Disjoint intervals (start, end, value) for lookups by time."""

    def __init__(self, items: Sequence[Tuple[int, int, object]]):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.items[i][1]:
            return self.items[i][2]
        return None


def outermost(spans: Sequence[Span], names) -> List[Span]:
    """The spans named in `names` that no other of them encloses on the
    same thread."""
    out: List[Span] = []
    for sp in sorted((s for s in spans if s[0] in names), key=lambda s: (s[2], s[3], -s[4])):
        if out and out[-1][2] == sp[2] and sp[3] < out[-1][4]:
            continue
        out.append(sp)
    return out


def innermost(spans: Sequence[Span], times: Sequence[int]) -> List[Optional[Span]]:
    """For each of the ascending `times`, the innermost span open then
    (`HOST_ONLY` spans left out; the rest nest in time), in one sweep."""
    order = sorted((s for s in spans if s[0] not in HOST_ONLY), key=lambda s: (s[3], -s[4]))
    out: List[Optional[Span]] = []
    stack: List[Span] = []
    i = 0
    for t in times:
        while i < len(order) and order[i][3] <= t:
            while stack and stack[-1][4] <= order[i][3]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][4] <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def merged(acts: Sequence[Activity]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for _, _, s, e in sorted(acts, key=lambda a: a[2]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def analyse(acts: Sequence[Activity], calls: Sequence[Call], spans: Sequence[Span],
            start_ns: Optional[int] = None) -> Dict:
    """What a profiled span of steps shows (module docstring). Times in ns
    over the whole span; `steps` the `loop.step` spans inside it. Spans are
    kept where they lie between the profiler's start (`start_ns`, else its
    first event) and its last event."""
    if not acts and not calls:
        return {}
    lo = min([a[2] for a in acts] + [c[2] for c in calls])
    lo = lo if start_ns is None else min(lo, start_ns)
    hi = max([a[3] for a in acts] + [c[3] for c in calls])
    spans = [s for s in spans if lo <= s[3] and s[4] <= hi]
    launch = {c[1]: c for c in calls if c[1]}
    phase = Intervals([(s[3], s[4], s[0]) for s in spans if s[0] in PHASES])
    loop = Intervals([(s[3], s[4], s[0]) for s in spans if s[0] in LOOP])
    ops = Intervals([(s[3], s[4], s[0]) for s in outermost(spans, FWD_OPS + BWD_OPS)])
    device = {p: 0 for p in PHASES}
    unattributed = unlaunched = 0
    op_ns = {"fwd": 0, "bwd": 0}
    for _, corr, s, e in acts:
        c = launch.get(corr)
        if c is None:
            unlaunched += e - s
            unattributed += e - s
            continue
        p = phase.at(c[2])
        if p is None:
            unattributed += e - s
        else:
            device[p] += e - s
        op = ops.at(c[2])
        if op is not None:
            op_ns["fwd" if op in FWD_OPS else "bwd"] += e - s
    syncs: Dict[str, int] = {}
    at = sorted(c[2] for c in calls if c[0] in SYNCS and loop.at(c[2]) is not None)
    for sp in innermost(spans, at):
        syncs[sp[0]] = syncs.get(sp[0], 0) + 1
    busy = merged(acts)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy[:-1], busy[1:])]
    mids = [(e0 + s1) // 2 for e0, s1 in gaps]
    idle: Dict[str, int] = {}
    idle_in: Dict[str, int] = {}
    for (e0, s1), mid, inner in zip(gaps, mids, innermost(spans, mids)):
        key = phase.at(mid) or loop.at(mid) or "(outside the loop's spans)"
        idle[key] = idle.get(key, 0) + s1 - e0
        key = inner[0] if inner is not None else key
        idle_in[key] = idle_in.get(key, 0) + s1 - e0
    dur = lambda name: sum(s[4] - s[3] for s in spans if s[0] == name)  # noqa: E731
    loader = [s for s in spans if s[0] == "loader.batch"]
    return {"steps": sum(1 for s in spans if s[0] == "loop.step"),
            "device_ns": device, "unattributed_ns": unattributed, "unlaunched_ns": unlaunched,
            "device_sum_ns": sum(e - s for _, _, s, e in acts),
            "busy_ns": sum(e - s for s, e in busy), "op_ns": op_ns,
            "syncs": syncs, "idle_ns": idle, "idle_by_span_ns": idle_in,
            "lsa_host_ns": dur("matcher.lsa") - dur("matcher.lsa.wait"),
            "lsa_calls": sum(1 for s in spans if s[0] == "matcher.lsa"),
            "loader_batches": len(loader), "loader_ns": sum(s[4] - s[3] for s in loader)}


# ---------------------------------------------------------------------------
# the harness's profiler and the program's records
# ---------------------------------------------------------------------------

def from_kineto(events) -> Tuple[List[Activity], List[Call]]:
    """Device activities and host runtime calls of a profiler's kineto
    events (a device activity shares its correlation id with the runtime
    call that launched it)."""
    import torch
    acts: List[Activity] = []
    calls: List[Call] = []
    for ev in events:
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                acts.append((ev.name(), int(ev.correlation_id()), s, e))
        elif ev.correlation_id() and ev.name().startswith("cu"):
            calls.append((ev.name(), int(ev.correlation_id()), s, e))
    return acts, calls


def profiled_span(name: str = "span"):
    """The harness's profiler of its span `name` (`devtrace.Span`), from the
    `spans` of the `harness.run` frame that called the reader; None
    elsewhere."""
    f = sys._getframe(1)
    while f is not None:
        spans = f.f_locals.get("spans") if f.f_code.co_name == "run" else None
        if isinstance(spans, list):
            for entry in spans:
                sp = entry[0] if isinstance(entry, tuple) and entry else None
                if getattr(sp, "name", None) == name and getattr(sp, "prof", None) is not None:
                    return sp.prof
        f = f.f_back
    return None


_LAST: List = [None, {}]      # the profiler last read and what it gave


def read_span(name: str = "span") -> Dict:
    """`analyse` of the harness's span `name` and the program's records
    ({} where either is missing), once per profiler; the first read prints
    its summary to standard error."""
    prof = profiled_span(name)
    if prof is None:
        return {}
    if _LAST[0] is not prof:
        try:
            from devis_torch.util import trace
        except ImportError:
            out = {}
        else:
            res = prof.profiler.kineto_results
            start = getattr(res, "trace_start_ns", None)
            acts, calls = from_kineto(res.events())
            out = analyse(acts, calls, trace.records(), start() if start is not None else None)
            if out.get("steps"):
                print("progtrace " + summary(out), file=sys.stderr, flush=True)
        _LAST[:] = [prof, out]
    return _LAST[1]


def summary(a: Dict) -> str:
    """One JSON object: `analyse`'s numbers a step, times in ms."""
    n = a["steps"]
    ms = lambda v: v / 1e6 / n  # noqa: E731
    by = lambda d: {k: ms(v) for k, v in sorted(d.items(), key=lambda x: -x[1])}  # noqa: E731
    return json.dumps({
        "steps": n, "device_ms": by(a["device_ns"]), "unattributed_ms": ms(a["unattributed_ns"]),
        "unlaunched_ms": ms(a["unlaunched_ns"]), "device_sum_ms": ms(a["device_sum_ns"]),
        "busy_ms": ms(a["busy_ns"]), "op_ms": by(a["op_ns"]), "idle_ms": by(a["idle_ns"]),
        "idle_by_span_ms": by(a["idle_by_span_ns"]),
        "syncs": {k: v / n for k, v in sorted(a["syncs"].items(), key=lambda x: -x[1])},
        "lsa_calls": a["lsa_calls"] / n, "lsa_host_ms": ms(a["lsa_host_ns"]),
        "loader_batches": a["loader_batches"], "loader_ms": a["loader_ns"] / 1e6})


def per_step(a: Dict, ns: int) -> Optional[float]:
    """ns over the span's steps, in ms; None without steps."""
    return ns / 1e6 / a["steps"] if a.get("steps") else None
