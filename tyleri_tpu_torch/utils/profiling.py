"""Profiling & metrics: frame-time ring, FPS / Mtris counters, and
torch.profiler trace hooks (the port's copy of
``tyleri_tpu/utils/profiling.py``, whose hooks wrap ``jax.profiler``).

The reference has no observability at all (SURVEY §5) — these counters are
required by the BASELINE metric (FPS + Mtris/s) and the validation-mode
equivalent of the debug messenger for performance messages.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


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



@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a block: CPU activity, and CUDA activity
    where a card is present (CUPTI records every kernel of the context, the
    ones launched through ctypes from the nvcc-built library included).  A
    Chrome/TensorBoard trace (``*.pt.trace.json``) lands in ``log_dir`` when
    the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named range visible in profiler traces (``record_function``)."""
    return torch.profiler.record_function(name)
