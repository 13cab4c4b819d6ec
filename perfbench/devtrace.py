"""Reading a torch.profiler trace of a bounded span of steps.

`Span` starts the profiler at a step boundary and stops it at a later one,
after a synchronisation, and reads from the trace: every device activity's
interval (kernels, copies, sets) by name, the union of those intervals
(busy seconds), the host annotations and operations that name an idle gap,
and the span's wall time on the host clock. Recording the host's
operations slows a host-bound step, so the busy share is read from a span
of CUDA activity alone and the host's operations only name the gaps.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

# device-time groups of the breakdown: a group's name → substrings of its
# kernels' lower-case names; the rest as cuDNN convolutions, matmuls or other
KERNEL_GROUPS = {"K1 msda_temporal_proj": ("msda_temporal_proj_win_kernel",),
                 "K2 msda_tap_window": ("msda_tap_window_kernel",),
                 "K3 msda_temporal": ("msda_temporal_kernel",),
                 "K5 msda_temporal_bwd": ("k5_bwd",),
                 "K6 msda_rows": ("msda_rows_kernel",),
                 "K7 msda_rows_bwd": ("k7_bwd",),
                 "K8 msda_proj": ("msda_proj_kernel",),
                 "K9 msda_taps_bwd": ("k9_bwd",),
                 "K4 / K10 dcn_layer": ("dcn_layer_",)}
_CONV = ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad")
_MM = ("gemm", "cutlass", "matmul", "nvjet")


def group_of(name: str) -> str:
    low = name.lower()
    for g, keys in KERNEL_GROUPS.items():
        if any(k in low for k in keys):
            return g
    if any(k in low for k in _CONV):
        return "convolutions (cuDNN)"
    if any(k in low for k in _MM):
        return "matmuls"
    return "other"


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


class Span:
    """The profiler over the steps between `start()` and `stop()`: CUDA
    activity, and the host's operations where `cpu` (or no card)."""

    def __init__(self, device, name: str, cpu: bool):
        from torch.profiler import ProfilerActivity, profile
        self.name = name
        self.cuda = torch.device(device).type == "cuda"
        acts = ([ProfilerActivity.CPU] if cpu or not self.cuda else []) + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self) -> Dict:
        """kernels [(name, start_ns, end_ns)], busy_s, window_s, host
        [(name, start_ns, end_ns)] of annotations and CPU operations."""
        dev, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                host.append((ev.name(), s, e))
            elif not ev.is_user_annotation():      # kernels, copies, sets; not spans
                dev.append((ev.name(), s, e))
        dev.sort(key=lambda x: x[1])
        merged: List[Tuple[int, int]] = []
        for _, s, e in dev:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        busy = sum(e - s for s, e in merged) / 1e9
        return dict(kernels=dev, merged=merged, busy_s=busy, window_s=self.t1 - self.t0,
                    host=host)


def device_ops(tr: Dict, top: int = 10) -> List[List]:
    """The groups that took most device time: [[group, seconds], ...]."""
    sums: Dict[str, float] = {}
    for name, s, e in tr["kernels"]:
        g = group_of(name)
        sums[g] = sums.get(g, 0.0) + (e - s) / 1e9
    return [[g, v] for g, v in sorted(sums.items(), key=lambda x: -x[1])[:top]]


def idle_gaps(tr: Dict, top: int = 10) -> List[List]:
    """The longest gaps between device activity, each named by the
    innermost host span open at its middle (the harness's own
    `bench.*` annotation, then the operation inside it, if any)."""
    m = tr["merged"]
    gaps = sorted(((m[i + 1][0] - m[i][1], m[i][1], m[i + 1][0]) for i in range(len(m) - 1)),
                  reverse=True)[:top]
    host = tr["host"]
    out = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        open_ = [h for h in host if h[1] <= mid < h[2]]
        bench = [h for h in open_ if h[0].startswith("bench.")]
        ops = sorted((h for h in open_ if not h[0].startswith(("bench.", "ProfilerStep"))),
                     key=lambda h: h[1])
        name = bench[-1][0] if bench else "train_one_epoch (metrics read, logging)"
        if ops:
            name += " > " + ops[-1][0]
        out.append([name, length / 1e9])
    return out
