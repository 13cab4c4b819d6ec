"""Metrics logging and profiling hooks (port of
`devis_tpu/util/logging_utils.py`).

A JSONL metrics stream any dashboard can tail (`MetricsWriter`), an optional
visdom sink behind `VISDOM_ON` (the reference's live plots,
`src/util/visdom_vis.py:34-191`), the card's memory counters
(`device_memory_stats`, from `torch.cuda.memory_stats`) and a scoped
`torch.profiler` trace (`ProfilerSession`).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class MetricsWriter:
    """Append-only JSONL stream: one record a call with its step, the wall
    time, tags and scalars."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a")

    def write(self, step: int, scalars: Dict[str, float], **tags):
        rec = {"step": int(step), "time": time.time(), **tags,
               **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class VisdomSink:
    """Optional live line plots (reference visdom_vis.py LineVis). A no-op
    where the visdom client is not installed; the client is imported here,
    lazily."""

    def __init__(self, server: str, port: int, env: str = "main"):
        try:
            import visdom
        except ImportError:
            self.vis = None
        else:
            self.vis = visdom.Visdom(server=server, port=port, env=env,
                                     raise_exceptions=False)
        self._wins: Dict[str, str] = {}

    def plot(self, window: str, step: int, scalars: Dict[str, float]):
        if self.vis is None:
            return
        names = sorted(scalars)
        win = self._wins.get(window)
        self._wins[window] = self.vis.line(
            Y=np.asarray([[scalars[k] for k in names]]), X=np.asarray([step]), win=win,
            update="append" if win else None, opts={"title": window, "legend": names})


def build_metrics(cfg) -> MetricsWriter:
    return MetricsWriter(cfg.OUTPUT_DIR)


def build_visdom(cfg) -> Optional[VisdomSink]:
    if not cfg.VISDOM_ON:
        return None
    return VisdomSink(cfg.VISDOM_SERVER, cfg.VISDOM_PORT)


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in use and its peak, GiB (the reference prints
    `torch.cuda.max_memory_allocated`, engine.py:224); {} on the CPU."""
    device = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (device is not None and device.type != "cuda"):
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use_gib": stats.get("allocated_bytes.all.current", 0) / 2 ** 30,
            "peak_bytes_gib": stats.get("allocated_bytes.all.peak", 0) / 2 ** 30}


class ProfilerSession:
    """Scoped `torch.profiler` trace of host and card activity, written as
    a Chrome trace into `log_dir`: `with ProfilerSession(dir, enabled): ...`."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
            self.prof = None
        return False
