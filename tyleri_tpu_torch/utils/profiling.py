"""Profiling & metrics: frame-time ring, FPS / Mtris counters, the frame
loop's span and counter recorder, and torch.profiler trace hooks (the
port's copy of ``tyleri_tpu/utils/profiling.py``, whose hooks wrap
``jax.profiler``).

The reference has no observability at all (SURVEY §5) — these counters are
required by the BASELINE metric (FPS + Mtris/s) and the validation-mode
equivalent of the debug messenger for performance messages.

The recorder: the frame loop opens ``span(name)`` at each layer boundary
and calls ``count(name)`` where work happens.  Both do nothing unless a
``tracing()`` block is open; inside one, each span is kept in memory (name,
``perf_counter_ns`` start and end, parent, frame id) and each counter per
frame id.  While a torch.profiler also runs, each span opens a
``ty::<name>`` range as well, so the profile shows the frame loop's layers
on the host timeline, on the clock of its device timeline.  The range is a
plain record-function scope (an operator-like ``cpu_op`` event), not a
user annotation: the profiler draws each user annotation a second time on
the device timeline around the kernels launched directly inside it, and
only the innermost one gets that, so a span opened inside a caller's
``record_function`` would take the caller's device range away.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

RANGE = "ty::"


class FrameProfiler:
    """FPS and Mtris/s over the last ``window`` presented frames: the
    window marks a frame when its image reaches the present target."""

    def __init__(self, window: int = 120):
        self.window = window
        self._times = collections.deque(maxlen=window + 1)
        self._tri_counts = collections.deque(maxlen=window + 1)

    def frame(self, triangle_count: int = 0) -> None:
        """Mark a frame boundary (call once per presented frame)."""
        self._times.append(time.perf_counter())
        self._tri_counts.append(triangle_count)

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
        tris = sum(self._tri_counts) - self._tri_counts[0]
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


@dataclasses.dataclass
class Span:
    """One recorded span: times by ``time.perf_counter_ns``; ``parent`` and
    ``profile`` index ``Records.spans`` and ``Records.profiles`` (-1: none);
    ``frame`` is the frame id its ``frame`` (or ``present``) span carries."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame: Optional[int]
    profile: int


class Records:
    """What one ``tracing()`` block recorded.

    ``spans``: every span in the order it opened.  ``counters``: {frame id:
    {name: n}} (None: counted outside any frame).  ``profiles``: one entry
    per run of spans opened while a torch.profiler ran, {"clock_offset_ns":
    the profiler's clock less ``perf_counter_ns``}: the profiler stamps
    events in nanoseconds of the wall clock, so a span's ``start_ns +
    clock_offset_ns`` is its place on the device timeline."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict = {}
        self.profiles: list[dict] = []
        self._stack: list[int] = []
        self._profiled = False


class _Span:
    __slots__ = ("_rec", "_name", "_frame", "_i", "_range")

    def __init__(self, rec: Records, name: str, frame):
        self._rec, self._name, self._frame = rec, name, frame
        self._range = None

    def __enter__(self):
        rec = self._rec
        parent = rec._stack[-1] if rec._stack else -1
        frame = self._frame
        if frame is None and parent >= 0:
            frame = rec.spans[parent].frame
        profile = -1
        if _autograd_profiler._is_profiler_enabled:
            if not rec._profiled:
                rec._profiled = True
                rec.profiles.append(dict(
                    clock_offset_ns=time.time_ns() - time.perf_counter_ns()))
            profile = len(rec.profiles) - 1
            self._range = torch._C._profiler._RecordFunctionFast(
                RANGE + self._name)
            self._range.__enter__()
        else:
            rec._profiled = False
        self._i = len(rec.spans)
        rec.spans.append(Span(self._name, time.perf_counter_ns(), 0, parent,
                              frame, profile))
        rec._stack.append(self._i)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self._rec
        rec.spans[self._i].end_ns = end
        rec._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_NOOP = contextlib.nullcontext()
_records: Optional[Records] = None   # the open tracing() block's


def span(name: str, frame: Optional[int] = None):
    """A context manager around one layer of the frame loop.  ``frame``
    gives the span a frame id; other spans take their parent's.  Without
    an open ``tracing()`` block it is one shared no-op context."""
    rec = _records
    if rec is None:
        return _NOOP
    return _Span(rec, name, frame)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span's frame
    (only inside a ``tracing()`` block)."""
    rec = _records
    if rec is None:
        return
    frame = rec.spans[rec._stack[-1]].frame if rec._stack else None
    per_frame = rec.counters.setdefault(frame, {})
    per_frame[name] = per_frame.get(name, 0) + n


def recording() -> bool:
    """Whether a ``tracing()`` block is open (for a count whose test costs
    work of its own)."""
    return _records is not None


@contextlib.contextmanager
def tracing():
    """Record spans and counters while the block runs; yields the
    ``Records``, complete when the block ends.  Blocks do not nest."""
    global _records
    if _records is not None:
        raise RuntimeError("a tracing() block is already open")
    rec = Records()
    _records = rec
    try:
        yield rec
    finally:
        _records = None


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
