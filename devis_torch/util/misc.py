"""Small tensor helpers, the device rule of the port's entry points, and the
metric logger of the training loop."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Without a GPU the caller must ask for the CPU explicitly; there
    is no silent fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1 - x).clamp(min=eps)
    return torch.log(x1 / x2)


class SmoothedValue:
    """A series of values with its windowed median and average and its
    global average."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Console metric logger with ETA."""

    def __init__(self, print_freq: int = 10, delimiter: str = "  ",
                 debug: bool = False):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq
        self.debug = debug

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        """Sums each meter's count and total over the ranks of a process
        group (reference misc.py:199-210), so that `global_avg` is the
        average over every rank's updates; nothing to do in one process."""
        from ..parallel.mesh import comm_device, is_distributed
        if not is_distributed():
            return
        names = sorted(self.meters)
        t = torch.tensor([[self.meters[k].count, self.meters[k].total] for k in names],
                         dtype=torch.float64, device=comm_device())
        torch.distributed.all_reduce(t)
        for k, (count, total) in zip(names, t.tolist()):
            self.meters[k].count = int(count)
            self.meters[k].total = total

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, header: str = ""):
        """Yield the items, printing the meters every `print_freq` items; in
        debug mode stop after two."""
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}", flush=True)
            end = time.time()
            if self.debug and i >= 1:
                break
        total_time = datetime.timedelta(seconds=int(time.time() - start))
        print(f"{header} Total time: {total_time}", flush=True)
