"""Spans of the port's own work, on the profiler's clock.

    from devis_torch.util import trace
    with trace.span("step.forward"):
        ...

Off by default: `span` then tests one module flag and returns one shared
no-op context; nothing is allocated or recorded. `enable()` / `disable()`
switch spans on and off; `follow_profiler()`, which the epoch loop calls
once a step, turns them on while a `torch.profiler` records and off after
it (unless `enable()` turned them on), so a profile of the loop carries the
program's spans with nothing else switched.

On, a span pushes itself on its thread's stack (parents hold on the
loader's thread and on autograd's device thread alike), opens
`torch.profiler.record_function(name)`, so a running profiler shows the
same range, and on exit appends `(name, parent, thread, start_ns, end_ns)`
to a ring of the last `RING` records and adds to the totals `{name: (count,
total_ns, self_ns)}`, which keep counting past the ring. Self time is the
span's duration less its children's on the same thread. `thread` is the
OS thread id (`threading.get_native_id()`), the id a Chrome trace of the
profiler gives its threads.

The clock is `time.time_ns()`, Unix-epoch nanoseconds: torch.profiler
converts its events' timestamps (`start_ns()` of the kineto events, `ts` of
its Chrome trace) to the same clock, so a span's interval lays directly
over the device trace, the runtime calls that launched each kernel
included.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

RING = 200_000

Record = Tuple[str, Optional[str], int, int, int]

_on = False              # spans record (the one flag the off path tests)
_explicit = False        # turned on by enable(), not by a running profiler
_local = threading.local()
_lock = threading.Lock()
_ring: "collections.deque[Record]" = collections.deque(maxlen=RING)
_totals: Dict[str, List[int]] = {}
_thread_names: Dict[int, str] = {}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "stack", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _thread_names[threading.get_native_id()] = threading.current_thread().name
        self.stack = stack
        self.child_ns = 0
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = time.time_ns()            # the range's own timestamps follow closely
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(*exc)
        stack = self.stack
        stack.pop()
        parent = stack[-1] if stack else None
        dur = t1 - self.t0
        if parent is not None:
            parent.child_ns += dur
        with _lock:
            _ring.append((self.name, parent.name if parent is not None else None,
                          threading.get_native_id(), self.t0, t1))
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
        return False


def span(name: str):
    """A context that records `name` while spans are on (module docstring)."""
    if not _on:
        return _NOOP
    return _Span(name)


def enable() -> None:
    global _on, _explicit
    _on = _explicit = True


def disable() -> None:
    global _on, _explicit
    _on = _explicit = False


def enabled() -> bool:
    return _on


def follow_profiler() -> None:
    """Spans on while a torch.profiler records, off once none does; a no-op
    after `enable()`."""
    global _on
    if not _explicit:
        _on = bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


def records() -> List[Record]:
    """The ring's records, oldest first."""
    with _lock:
        return list(_ring)


def totals() -> Dict[str, Tuple[int, int, int]]:
    """{name: (count, total_ns, self_ns)} over every span since `reset()`."""
    with _lock:
        return {k: tuple(v) for k, v in _totals.items()}


def table(before: Optional[Dict[str, Tuple[int, int, int]]] = None) -> Dict[str, Dict]:
    """{name: {count, total_ms, self_ms}} of the spans closed since the
    `totals()` taken as `before` (all of them where None)."""
    before = before or {}
    out = {}
    for name, (n, tot, own) in totals().items():
        n0, tot0, own0 = before.get(name, (0, 0, 0))
        if n > n0:
            out[name] = {"count": n - n0, "total_ms": (tot - tot0) / 1e6,
                         "self_ms": (own - own0) / 1e6}
    return out


def reset() -> None:
    with _lock:
        _ring.clear()
        _totals.clear()


def export_chrome(path: str) -> None:
    """The ring's records as a Chrome trace: complete events, `ts` and
    `dur` in microseconds of the Unix epoch, one track a thread."""
    recs = records()
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": n}}
              for tid, n in sorted(_thread_names.items())]
    events += [{"name": name, "cat": "devis_torch", "ph": "X", "pid": pid, "tid": tid,
                "ts": s / 1e3, "dur": (e - s) / 1e3, "args": {"parent": parent}}
               for name, parent, tid, s, e in recs]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
