"""Cross-request micro-batching queue (BASELINE.json config #5).

Port of ``avd_tpu/serve/batching.py``.  The reference serves one request
at a time (1 worker × 1 thread, gunicorn_conf.py:4-5); concurrent clients
queue at the socket.  Here, concurrent requests' full host-prep windows —
same frame count, same device — are stacked into one
``video_features.run_prep_windows`` call, so each flow kernel launch
serves every request in the batch.

Enable with ``AVD_BATCH_WINDOW_MS > 0``: a request's first window waits up
to that long for co-batchable windows from other requests before launch;
follow-up windows of an already-streaming clip keep the pipeline full, so
the added latency is at most one batch window per request.

The batcher is process-wide (``active_batcher()``); the app hands it to
``pipeline.analyze_path``, whose streaming video path submits every window
to it.  Every job names its device, pinned with its index, and the device
is part of the queue key: a worker thread runs each batch on that device,
whatever the current device of the thread that submitted it or built the
batcher.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.config import get_config

# The stacked-window counts that serving warm-up runs once each
# (serve/master._warmup).
_BUCKETS = (1, 2, 4, 8)


class _Job:
    def __init__(self, windows: tuple):
        self.windows = windows  # the (w320, w32) host-prep window pair
        self.future: concurrent.futures.Future = concurrent.futures.Future()


class WindowBatcher:
    """Groups feature windows by shape and device and runs them stacked."""

    def __init__(self, window_ms: float, max_batch: int = 8):
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self._lock = threading.Condition()
        self._queues: Dict[tuple, List[_Job]] = {}
        self._threads: Dict[tuple, threading.Thread] = {}
        self.batches_formed = 0
        self.jobs_in = 0
        self.fused_jobs = 0  # jobs that shared a device call
        self._closed = False

    def submit_prep(self, w320: np.ndarray, w32: np.ndarray,
                    device) -> concurrent.futures.Future:
        """A ([N,320,320], [N,32,32]) host-prep window pair → a future of
        its ham ‖ fmean ‖ fvar float32 host vector."""
        key = ("prep", w320.shape[0], device_mod.pinned(device))
        job = _Job((w320, w32))
        with self._lock:
            self.jobs_in += 1
            self._queues.setdefault(key, []).append(job)
            if key not in self._threads:
                t = threading.Thread(target=self._worker, args=(key,),
                                     daemon=True, name=f"avd-batch-{key}")
                self._threads[key] = t
                t.start()
            self._lock.notify_all()
        return job.future

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def _max_batch_for(self, key) -> int:
        """Fuse only full-chunk windows: serving warm-up (master._warmup)
        runs the full chunk's m ladder, so only those stacked shapes are
        known to fit and to have met the card before a live request.  Tail
        windows dispatch singly."""
        from avd_tpu_torch.ops import video_features
        if key[1] != video_features._DEFAULT_CHUNK + 1:
            return 1
        return self.max_batch

    # ------------------------------------------------------------------
    _IDLE_EXIT_S = 30.0  # idle workers retire; submit_prep respawns them

    def _worker(self, key: tuple) -> None:
        while True:
            with self._lock:
                idle_deadline = time.monotonic() + self._IDLE_EXIT_S
                while not self._queues.get(key) and not self._closed:
                    if time.monotonic() >= idle_deadline:
                        # retire instead of polling forever — keys are per
                        # window length and device, so a long-lived worker
                        # would otherwise keep one waking thread per key
                        # ever seen.  Deregistering under the lock makes
                        # the race with submit_prep safe: either it sees us
                        # gone and respawns, or we see its job.
                        self._threads.pop(key, None)
                        self._queues.pop(key, None)
                        return
                    self._lock.wait(timeout=1.0)
                if self._closed and not self._queues.get(key):
                    self._threads.pop(key, None)
                    return
                deadline = time.monotonic() + self.window_s
                maxb = self._max_batch_for(key)
                while (len(self._queues[key]) < maxb
                       and time.monotonic() < deadline):
                    self._lock.wait(timeout=max(
                        0.001, deadline - time.monotonic()))
                jobs = self._queues[key][:maxb]
                self._queues[key] = self._queues[key][len(jobs):]
            if jobs:
                self._run(key, jobs)

    def _run(self, key, jobs: List[_Job]) -> None:
        """One device call for ``jobs``, one fetch, then each job's future
        resolved with host arrays.  Exactly m windows are stacked, with no
        padding to a bucket: PyTorch runs eagerly and builds nothing per
        shape, so a padded window would only add its flow to the call."""
        from avd_tpu_torch.ops import video_features

        dev = key[-1]
        m = len(jobs)
        try:
            res = video_features.run_prep_windows(
                np.stack([j.windows[0] for j in jobs]),
                np.stack([j.windows[1] for j in jobs]), dev)
            res = res.cpu().numpy()  # [m, 3(n-1)]
            outs = [res[i] for i in range(m)]
            self.batches_formed += 1
            if m > 1:
                self.fused_jobs += m
            for job, out in zip(jobs, outs):
                job.future.set_result(out)
        except Exception as e:  # each waiting request gets the error
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(e)


_ACTIVE: Optional[WindowBatcher] = None
_ACTIVE_LOCK = threading.Lock()


def active_batcher() -> Optional[WindowBatcher]:
    """Process-wide batcher, constructed on first use when enabled."""
    global _ACTIVE
    cfg = get_config()
    if cfg.batch_window_ms <= 0:
        return None
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            _ACTIVE = WindowBatcher(cfg.batch_window_ms)
        return _ACTIVE


def reset_active() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.close()
        _ACTIVE = None
