"""The program's own spans and counters in a traced run (``--trace 1``):
``tyleri_tpu_torch.utils.profiling.tracing()`` open from the loading of
one reader, ``metrics/frame.host_ms.py`` (before the set-up's profiled
frames and the window), to its ``after`` hook, once the window has been
flushed; the other readers of spans and counters read ``rec["spans"]``.

``reduce`` gives, over the window's unprofiled frames (the frames the
stage timers' host metrics count), the host seconds a frame of each span
name, the counters, and the share of presented frames whose fence had not
passed when the window came to present them; and, from each profiled
slice's ``ty::`` ranges, the device's idle time by the innermost span the
host was in (``idle_by_span``) and the idle time outside every
``ty::frame`` range.  A summary (host and self ms a frame of each span, the
counters, ``idle_by_span``) is printed to standard error.

A program without the recorder records nothing: every reader then returns
None and nothing raises."""

from __future__ import annotations

import collections
import json
import sys
import weakref

from benchmark import tracing

RANGE = "ty::"
OUTSIDE = "host:outside_spans"

_open = {"block": None, "records": None, "stop": None, "profiles": []}


def _close():
    """Close the recording block and restore ``torch.profiler.profile.stop``;
    returns (records or None, the profiles that stopped while it was open,
    oldest first)."""
    import torch

    block, records = _open["block"], _open["records"]
    if _open["stop"] is not None:
        torch.profiler.profile.stop = _open["stop"]
    profiles = [p for p in (r() for r in _open["profiles"]) if p is not None]
    _open.update(block=None, records=None, stop=None, profiles=[])
    if block is not None:
        block.__exit__(None, None, None)
    return records, profiles


def start() -> None:
    """Open the program's recorder for the rest of the run; a block left
    open by an earlier run in this process is dropped."""
    _close()
    try:
        from tyleri_tpu_torch.utils import profiling
    except ImportError:
        return
    if not hasattr(profiling, "tracing"):
        return
    import torch

    block = profiling.tracing()
    _open["records"] = block.__enter__()
    _open["block"] = block
    stop = torch.profiler.profile.stop

    def kept_stop(self):
        stop(self)
        _open["profiles"].append(weakref.ref(self))

    _open["stop"] = stop
    torch.profiler.profile.stop = kept_stop


# the harness's reader hooks: no stage capture, the reduction after the
# window
CAPTURE = ()


def capture(store, slice_, args, kwargs, out):
    pass


def after(store, rec):
    """Close the recorder and reduce its records into ``rec["spans"]``
    (once a run)."""
    if "spans" in rec:
        return
    records, profiles = _close()
    if records is None:
        rec["spans"] = None
        return
    # the window's slices are the last profiles; the set-up's comes first
    slices = len(rec.get("trace", {}).get("last_of", []))
    rec["spans"] = out = reduce(records, profiles[len(profiles) - slices:])
    n = max(out["frames"], 1)
    print("benchmark: spans " + json.dumps(dict(
        frames=out["frames"],
        host_ms={k: v * 1e3 / n for k, v in out["host_s"].items()},
        self_ms={k: v * 1e3 / n for k, v in out["self_s"].items()},
        counters=out["counters"], presented=out["presented"],
        fence_pending=out["fence_pending"],
        idle_by_span=out["idle_by_span"])), file=sys.stderr)


def reduce(records, profiles) -> dict:
    """{"frames": unprofiled frames, "host_s": {span name: host seconds over
    them}, "self_s": the same less what each span's child spans cover,
    "counters": {name: n over the whole block}, "presented",
    "fence_pending": frames presented in them and how many of those had a
    pending fence, "idle_by_span": {span name: device idle ms a profiled
    frame}, "idle_outside_frame_s", "profiled_span_s"}."""
    spans = records.spans
    root = []
    for i, s in enumerate(spans):
        root.append(i if s.parent < 0 else root[s.parent])
    frames = {i for i, s in enumerate(spans)
              if s.name == "frame" and s.parent < 0 and s.profile < 0}
    host = collections.defaultdict(float)
    own = collections.defaultdict(float)
    presented = set()
    for i, s in enumerate(spans):
        if root[i] in frames:
            d = (s.end_ns - s.start_ns) * 1e-9
            host[s.name] += d
            own[s.name] += d
            if s.parent >= 0:
                own[spans[s.parent].name] -= d
            if s.name == "present":
                presented.add(s.frame)
    counters = collections.Counter()
    for per_frame in records.counters.values():
        counters.update(per_frame)
    pending = sum(1 for f in presented
                  if records.counters.get(f, {}).get("present.fence_pending"))
    idle = collections.defaultdict(float)
    outside = span_s = 0.0
    profiled_frames = 0
    for prof in profiles:
        sl = idle_by_span(prof.events())
        for k, v in sl["idle_s"].items():
            idle[k] += v
        outside += sl["outside_frame_s"]
        span_s += sl["span_s"]
        profiled_frames += sl["frames"]
    return dict(
        frames=len(frames), host_s=dict(host), self_s=dict(own),
        counters=dict(counters),
        presented=len(presented), fence_pending=pending,
        idle_by_span={k: v * 1e3 / profiled_frames for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])} if profiled_frames else {},
        idle_outside_frame_s=outside if profiled_frames else None,
        profiled_span_s=span_s)


def _innermost(ranges, lo, hi):
    """[start, end, name] segments covering [lo, hi], each named by the
    innermost of the nested ``ranges`` (start, end, name) open over it, or
    OUTSIDE."""
    segs, stack, t = [], [], lo

    def emit(end, name):
        nonlocal t
        if end > t:
            segs.append((t, end, name))
            t = end

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            emit(end, nm)
        emit(s, stack[-1][1] if stack else OUTSIDE)
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        emit(end, nm)
    emit(hi, OUTSIDE)
    return segs


def _overlap(a, b) -> list:
    """Pieces of the sorted disjoint intervals ``a`` that lie inside the
    sorted disjoint intervals ``b``, with b's third field: [(s, e, tag)]."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            lo, hi = max(s, b[k][0]), min(e, b[k][1])
            if hi > lo:
                out.append((lo, hi, b[k][2] if len(b[k]) > 2 else None))
            k += 1
    return out


def idle_by_span(events) -> dict:
    """One profiled slice's events: the device's idle time (no kernel or
    copy running, over the slice's span as ``tracing.reduce_slice`` takes
    it) by the innermost ``ty::`` range the host was in, in seconds; the
    idle time outside every ``ty::frame`` range; the span; the frames."""
    dev = [e for e in events if tracing._device(e)
           and not tracing._annotation(e) and not e.name.startswith(RANGE)]
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(RANGE):])
              for e in events
              if not tracing._device(e) and e.name.startswith(RANGE)]
    frames = sorted((s, e) for s, e, n in ranges if n == "frame")
    if not events or not frames:
        return dict(idle_s={}, outside_frame_s=0.0, span_s=0.0, frames=0)
    span0 = min(e.time_range.start for e in events)
    span1 = max(e.time_range.end for e in events)
    busy = tracing._union([(e.time_range.start, e.time_range.end)
                           for e in dev])
    edges = [span0] + [x for iv in busy for x in iv] + [span1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    by_name = collections.defaultdict(float)
    for s, e, name in _overlap(idle, _innermost(ranges, span0, span1)):
        by_name[name] += (e - s) * 1e-6
    in_frames = sum(e - s for s, e, _ in _overlap(
        idle, [list(iv) for iv in tracing._union(frames)]))
    return dict(idle_s=dict(by_name),
                outside_frame_s=(sum(e - s for s, e in idle) - in_frames)
                * 1e-6,
                span_s=(span1 - span0) * 1e-6, frames=len(frames))


def per_frame_ms(rec, name):
    """Host ms a frame in the span ``name`` over the window's unprofiled
    frames; None without records or without such a span."""
    sp = rec.get("spans")
    if not sp or not sp["frames"] or name not in sp["host_s"]:
        return None
    return sp["host_s"][name] / sp["frames"] * 1e3
