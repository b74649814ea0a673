"""The traced run's records: host time of each stage (a timer and a
``stage::<name>`` profiler range around the program attribute each stage
file names), and ``torch.profiler`` slices of a few frames each, reduced in
memory to device time by kernel and by stage, the union of device
intervals and the idle gaps.  No trace file is written."""

from __future__ import annotations

import bisect
import collections
import functools
import importlib
import time

import torch

RANGE = "stage::"


def _owner(stage: dict):
    obj = importlib.import_module(stage["module"])
    *path, attr = stage["attr"].split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, attr


class StageTimers:
    """Wraps every stage while active.  ``host`` sums each stage's host
    seconds over the frames counted (``counting``); while ``capturing``
    holds a profiled slice's index, ``hooks[stage]`` are called as
    hook(slice, args, kwargs, out)."""

    def __init__(self, stages: list):
        self.stages = stages
        self.host = collections.defaultdict(float)
        self.counting = True
        self.capturing = None
        self.hooks = collections.defaultdict(list)
        self._saved = []

    def _timed(self, name, fn):
        record = torch.profiler.record_function

        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            with record(RANGE + name):
                out = fn(*args, **kwargs)
            if self.counting:
                self.host[name] += time.perf_counter() - t0
            if self.capturing is not None:
                for hook in self.hooks[name]:
                    hook(self.capturing, args, kwargs, out)
            return out
        return call

    def __enter__(self):
        for st in self.stages:
            owner, attr = _owner(st)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(
                owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(st["name"], fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def _device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _annotation(evt) -> bool:
    """A profiler range as the device timeline shows it (the span of its
    kernels), not a device operation."""
    return (evt.name.startswith(RANGE)
            or getattr(evt, "is_user_annotation", False))


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged, starts, s, e) -> float:
    """How much of [s, e] the merged intervals cover."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < e:
        total += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
        i += 1
    return total


def reduce_slice(prof, frames: int) -> dict:
    """One profiled slice: {"frames", "span_s", "busy_s", "ops": {device op
    name: [seconds of each event, in time order]}, "stage_device_s":
    {stage: s}, "stage_source", "gaps": the ten longest idle gaps, each
    (seconds, stage the host was in)}.
    Times in the profiler's microseconds become seconds."""
    events = prof.events()
    dev = [e for e in events if _device(e) and not _annotation(e)]
    marks = [e for e in events if _device(e) and e.name.startswith(RANGE)]
    host = [e for e in events if not _device(e)]
    ranges = [e for e in host if e.name.startswith(RANGE)]
    span0 = min(e.time_range.start for e in events)
    span1 = max(e.time_range.end for e in events)
    ops = collections.defaultdict(list)
    for e in sorted(dev, key=lambda e: e.time_range.start):
        ops[e.name].append((e.time_range.end - e.time_range.start) * 1e-6)
    merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    starts = [s for s, _ in merged]
    busy = sum(e - s for s, e in merged)

    # device time under each stage: the device's busy time inside the
    # stage's range on the device timeline, where the profiler draws one;
    # else the kernels whose launching host event lies inside the range's
    # host interval
    stage_dev = collections.defaultdict(float)
    if marks:
        source = "device_range"
        for m in marks:
            stage_dev[m.name[len(RANGE):]] += _covered(
                merged, starts, m.time_range.start, m.time_range.end) * 1e-6
    else:
        source = "launch_interval"
        launches = [e for e in host if e.kernels]
        for r in ranges:
            s, t = r.time_range.start, r.time_range.end
            stage_dev[r.name[len(RANGE):]] += sum(
                k.duration for e in launches
                if s <= e.time_range.start <= t for k in e.kernels) * 1e-6

    # the longest idle gaps on the device, named by the stage range the
    # host was in when each began (the innermost, latest-started one)
    edges = [span0] + [x for iv in merged for x in iv] + [span1]
    longest = sorted(((e - s, s) for s, e in zip(edges[0::2], edges[1::2])
                      if e > s), reverse=True)[:10]
    gaps = []
    for length, s in longest:
        inside = [r for r in ranges
                  if r.time_range.start <= s < r.time_range.end]
        name = (max(inside, key=lambda r: r.time_range.start).name
                if inside else "host:outside_stages")
        gaps.append((length * 1e-6, name))
    return dict(frames=frames, span_s=(span1 - span0) * 1e-6,
                busy_s=busy * 1e-6, ops=dict(ops),
                stage_device_s=dict(stage_dev), stage_source=source,
                gaps=gaps)


def merge(slices: list) -> dict:
    """The slices of one run together."""
    ops = collections.defaultdict(list)
    stage = collections.defaultdict(float)
    for sl in slices:
        for k, v in sl["ops"].items():
            ops[k].extend(v)
        for k, v in sl["stage_device_s"].items():
            stage[k] += v
    return dict(
        frames=sum(s["frames"] for s in slices),
        span_s=sum(s["span_s"] for s in slices),
        busy_s=sum(s["busy_s"] for s in slices),
        ops=dict(ops), stage_device_s=dict(stage),
        stage_source=sorted({s["stage_source"] for s in slices}),
        gaps=sorted((g for s in slices for g in s["gaps"]), reverse=True),
        last_of=[{k: v[-1] for k, v in s["ops"].items()} for s in slices])


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each [name, seconds]."""
    ops = sorted(((sum(v), k) for k, v in trace["ops"].items()),
                 reverse=True)[:10]
    return {"device_ops": [[k, s] for s, k in ops],
            "idle_gaps": [[n, s] for s, n in trace["gaps"][:10]]}


def op_seconds(trace: dict, fragment: str) -> float:
    """Device seconds of the operations whose name holds ``fragment``."""
    return sum(sum(v) for k, v in trace["ops"].items() if fragment in k)
