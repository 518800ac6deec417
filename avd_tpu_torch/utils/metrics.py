"""Process metrics and per-request stage timing.

The port's copy of ``avd_tpu/utils/metrics.py``:

* process-wide counters (requests, frames analyzed, analyzed-frames/sec);
* a per-request stage timer (probe / analyzers / fusion / forensic)
  attached to the response under ``profile`` when AVD_PROFILE=1 —
  mirroring how DEBUG=1 attaches tracebacks in the reference
  (api.py:126-127).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict


class Counters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = defaultdict(float)
        self._started = time.time()

    def inc(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._values[name] += amount

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._values)
        uptime = max(1e-9, time.time() - self._started)
        out["uptime_s"] = round(uptime, 3)
        if "frames_analyzed" in out:
            out["frames_per_sec_lifetime"] = round(
                out["frames_analyzed"] / uptime, 3)
        return out


COUNTERS = Counters()


class StageTimer:
    """Accumulates wall-time per named stage for one request."""

    def __init__(self) -> None:
        self._stages: Dict[str, float] = {}

    class _Span:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer = timer
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer._stages[self.name] = self.timer._stages.get(
                self.name, 0.0) + (time.perf_counter() - self.t0)
            return False

    def stage(self, name: str) -> "StageTimer._Span":
        return StageTimer._Span(self, name)

    def report(self) -> Dict[str, float]:
        return {k: round(v * 1000.0, 2) for k, v in self._stages.items()}
