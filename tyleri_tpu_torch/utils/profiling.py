"""Profiling & metrics: frame-time ring and FPS / Mtris counters (copy of
``tyleri_tpu/utils/profiling.py`` without its JAX profiler hooks; the
port's profiler is ``testing/profile_frame.py``).

The reference has no observability at all (SURVEY §5) — these counters are
required by the BASELINE metric (FPS + Mtris/s) and the validation-mode
equivalent of the debug messenger for performance messages.
"""

from __future__ import annotations

import time

import numpy as np


class FrameProfiler:
    def __init__(self, window: int = 120):
        self.window = window
        self._times: list[float] = []
        self._tri_counts: list[int] = []

    def frame(self, triangle_count: int = 0) -> None:
        """Mark a frame boundary (call once per presented frame)."""
        self._times.append(time.perf_counter())
        self._tri_counts.append(triangle_count)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._tri_counts.pop(0)

    @property
    def frame_count(self) -> int:
        return len(self._times)

    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    def frame_time_ms(self) -> float:
        f = self.fps()
        return 1000.0 / f if f > 0 else 0.0

    def mtris_per_s(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        tris = sum(self._tri_counts[1:])
        return tris / dt / 1e6 if dt > 0 else 0.0

    def percentile_ms(self, q: float) -> float:
        if len(self._times) < 3:
            return 0.0
        deltas = np.diff(np.asarray(self._times))
        return float(np.percentile(deltas, q) * 1000.0)

    def summary(self) -> dict:
        return {
            "fps": round(self.fps(), 2),
            "frame_ms": round(self.frame_time_ms(), 3),
            "p99_ms": round(self.percentile_ms(99), 3),
            "mtris_per_s": round(self.mtris_per_s(), 3),
        }

