"""One clip-inference pipeline across a whole evaluation (port of
`devis_tpu/tracking/pipeline.py`).

`inference_vis` enqueues every (video, clip) up front, in the order the
tracker consumes them, and the tracker takes results in that order with
`next()`. Clip 0 of video j + 1 is prepared and dispatched while video j's
last clips are still fetched, so the device does not wait at a video
boundary.

Stages, each on its own thread(s), first in first out:
  prepare   load, resize and pad a clip on the host (`n_loaders` workers)
  dispatch  upload and enqueue the forward (one worker, so the device runs
            clips in the order they are consumed). `VISInferFn.dispatch`
            enters `torch.inference_mode` itself (the mode is per thread),
            and its launches add to the kernels' counters from this thread.
  fetch     wait for the clip's CUDA event (recorded on the dispatch
            thread's stream), copy the outputs back and adapt them

A plain callable `infer_fn(video, clip_idx)` without those stages runs as a
single background stage with the same interface.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Deque, Tuple


class ClipPipeline:
    def __init__(self, infer_fn: Callable, prep_depth: int = 4,
                 disp_depth: int = 2, n_loaders: int = 2):
        self.infer_fn = infer_fn
        self.staged = all(hasattr(infer_fn, a) for a in ("prepare", "dispatch", "fetch"))
        self.prep_depth = prep_depth
        self.disp_depth = disp_depth
        self._load_pool = ThreadPoolExecutor(max_workers=n_loaders)
        self._disp_pool = ThreadPoolExecutor(max_workers=1)
        self._fetch_pool = ThreadPoolExecutor(max_workers=1)
        self._work: Deque[Tuple[object, int]] = deque()
        self._preps: Deque[Future] = deque()
        self._disps: Deque[Future] = deque()
        self._fetches: Deque[Future] = deque()
        self._closed = False

    # -- producer side ------------------------------------------------------
    def add_video(self, video) -> None:
        """Enqueue every clip of `video`; results come back via `next()` in
        exactly this order."""
        assert not self._closed
        for clip_idx in range(len(video)):
            self._work.append((video, clip_idx))
        self._pump()

    # -- plumbing ------------------------------------------------------------
    def _pump(self) -> None:
        """Keep every stage's queue filled to its depth (FIFO)."""
        if not self.staged:
            # single stage: the whole infer_fn on the fetch thread, one clip
            # in flight ahead of the consumer
            while self._work and len(self._fetches) < 2:
                video, i = self._work.popleft()
                self._fetches.append(
                    self._fetch_pool.submit(self.infer_fn, video, i))
            return
        while self._work and (len(self._preps) + len(self._disps)
                              + len(self._fetches)) < self.prep_depth:
            video, i = self._work.popleft()
            self._preps.append(
                self._load_pool.submit(self.infer_fn.prepare, video, i))
        while self._preps and (len(self._disps)
                               + len(self._fetches)) < self.disp_depth + 1:
            fut = self._preps.popleft()
            self._disps.append(self._disp_pool.submit(
                lambda f=fut: self.infer_fn.dispatch(f.result())))
        while self._disps and len(self._fetches) < 2:
            fut = self._disps.popleft()
            self._fetches.append(self._fetch_pool.submit(
                lambda f=fut: self.infer_fn.fetch(f.result())))

    # -- consumer side -------------------------------------------------------
    def next(self):
        """Blocking: the next clip's results, in enqueue order."""
        self._pump()
        fut = self._fetches.popleft()
        self._pump()
        res = fut.result()
        self._pump()
        return res

    def close(self) -> None:
        self._closed = True
        self._work.clear()
        self._load_pool.shutdown(wait=False)
        self._disp_pool.shutdown(wait=False)
        self._fetch_pool.shutdown(wait=False)
