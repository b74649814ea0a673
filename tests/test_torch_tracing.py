"""The frame loop's span and counter recorder (``utils/profiling.py``) on
the CPU: the span tree of a config-5 frame, nothing recorded or ranged
with tracing off, the ``ty::`` ranges on the profiler's clock, the spans
against timers wrapped around the functions they open in, the plan-change
counter against the plan compared after every ``render()``, and
``FrameProfiler`` marking presented frames.

This file imports no JAX."""

import collections
import functools
import gc
import glob
import json
import statistics
import time

import pytest
import torch

import tyleri_tpu_torch as tt
from tyleri_tpu_torch.rendering import forward, passes
from tyleri_tpu_torch.utils import profiling
from tyleri_tpu_torch.utils.profiling import trace, tracing

RES = (160, 96)


def sponza_window():
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config5_sponza(dev, RES, grid_n=24)
    win = tt.RenderWindow(dev, resolution=RES, present_mode="immediate")
    return rig, win


def render(win, rig, times):
    for t in times:
        rig.fill(win.get_render_scene(), t)
        win.render()


def children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def owner(spans, i):
    """The root span above span i, and the outermost ``present`` span on
    the way (or None)."""
    present = None
    while True:
        if spans[i].name == "present":
            present = i
        if spans[i].parent < 0:
            return i, present
        i = spans[i].parent


def test_span_tree_of_a_config5_frame():
    """Every frame is one ``frame`` span holding its record, its enqueue
    and, from the fourth frame on, the present of the frame recorded three
    frames before, which carries that frame's id; the flush presents the
    last three."""
    rig, win = sponza_window()
    n, depth = 5, win.get_swapchain_images()
    with tracing() as records:
        render(win, rig, [1.0] * n)
        win.flush()
    spans = records.spans
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["frame"] * n + ["flush"]
    presents = []
    for k, f in enumerate(roots[:n]):
        assert spans[f].frame == k
        kids = children(spans, f)
        names = [spans[i].name for i in kids]
        assert names == ["record", "present.enqueue"] + (
            ["present"] if k >= depth else [])
        rec = kids[0]
        rnames = [spans[i].name for i in children(spans, rec)]
        assert rnames[0] == "plan" and rnames[-1] == "shade"
        assert {"setup", "bin", "raster"} <= set(rnames)
        for i, s in enumerate(spans):
            root, present = owner(spans, i)
            if root == f:
                # the frame's own spans carry its id; a present and its
                # children the recycled frame's
                assert s.frame == (k if present is None else k - depth), s
        presents += [spans[i].frame for i in kids[2:]]
    flush = roots[n]
    assert spans[flush].frame is None
    presents += [spans[i].frame for i in children(spans, flush)]
    assert presents == list(range(n))
    for p in (i for i, s in enumerate(spans) if s.name == "present"):
        assert [spans[i].name for i in children(spans, p)] == [
            "present.fence_wait", "present.target", "present.feedback"]
        assert all(spans[i].frame == spans[p].frame
                   for i in children(spans, p))
    assert set(records.counters) <= set(range(n))
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert all(s.profile == -1 for s in spans)


def test_ui_pass_spans_hold_its_read():
    """A frame with a UI overlay records ``ui`` first in ``record``, with
    the plain loop's one synchronizing read, ``ui.read``, inside.  The
    read exists on the CPU path only: on CUDA tensors the exact rasterizer
    is one kernel launch that reads nothing to the host (counted in
    ``_build.launches``; tests/test_torch_raster_exact_cuda.py)."""
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config1_triangle(dev, (64, 64))
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    win = tt.RenderWindow(dev, resolution=(64, 64), present_mode="immediate")
    quad = [((4, 4), (0, 0), (0, 1, 0, 1)), ((28, 4), (1, 0), (0, 1, 0, 1)),
            ((28, 16), (1, 1), (0, 1, 0, 1)), ((4, 16), (0, 1), (0, 1, 0, 1))]
    with tracing() as records:
        scene = win.get_render_scene()
        rig.fill(scene, 0.0)
        scene.add_ui([(quad, [0, 1, 2, 0, 2, 3], white)])
        win.render()
    spans = records.spans
    (rec,) = [i for i, s in enumerate(spans) if s.name == "record"]
    kids = children(spans, rec)
    assert [spans[i].name for i in kids[:2]] == ["plan", "ui"]
    assert [spans[i].name for i in children(spans, kids[1])] == ["ui.read"]


def test_bin_spill_opens_once_a_bin_triangles_call():
    """``bin.spill``, which ``binning.spill_host_ms`` reads, opens once
    inside each ``bin`` span, on the emit's path (the plain emit here; the
    kernel's launch on the card, tests/test_torch_binning_emit_cuda.py)."""
    from tyleri_tpu_torch.ops import binning
    from tyleri_tpu_torch.ops import setup as S

    g = torch.Generator().manual_seed(3)
    T = 400
    clip = torch.ones((T, 3, 4))
    clip[..., :2] = (torch.rand((T, 1, 2), generator=g) * 2.4 - 1.2
                     + torch.rand((T, 3, 2), generator=g) * 0.4 - 0.2)
    clip[..., 2] = 0.5
    su = S.setup_triangles(clip, torch.rand((T, 3, 2), generator=g),
                           torch.zeros(T, dtype=torch.int32),
                           torch.ones(T, dtype=torch.bool),
                           [0, 0, 128, 64, 0, 1], [0, 0, 128, 64], tile_w=8,
                           tile_h=8, grid_w=16, grid_h=8)
    with tracing() as records:
        for _ in range(2):
            binning.bin_triangles(su, grid_w=16, grid_h=8, entry_cap=1 << 14,
                                  spill_cap=1 << 12)
    spans = records.spans
    bins = [i for i, s in enumerate(spans) if s.name == "bin"]
    spills = [i for i, s in enumerate(spans) if s.name == "bin.spill"]
    assert len(bins) == 2
    assert [spans[i].parent for i in spills] == bins


def counting(real):
    """A stand-in for a profiler range class that counts its entries."""

    class Counting:
        entered = 0

        def __init__(self, *args):
            self._inner = real(*args)

        def __enter__(self):
            Counting.entered += 1
            return self._inner.__enter__()

        def __exit__(self, *exc):
            return self._inner.__exit__(*exc)

    return Counting


def test_tracing_off_records_nothing_and_enters_no_range(monkeypatch):
    """Without a ``tracing()`` block a span is one shared no-op and no
    profiler range opens (neither ``torch.profiler.record_function`` nor
    the record-function scope the recorder uses), a profiler running or
    not; inside one, ranges open only while a profiler runs."""
    user = counting(torch.profiler.record_function)
    fast = counting(torch._C._profiler._RecordFunctionFast)
    monkeypatch.setattr(torch.profiler, "record_function", user)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    rig, win = sponza_window()
    assert not profiling.recording()
    assert profiling.span("frame") is profiling.span("bin", frame=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        render(win, rig, [1.0, 1.0])
    render(win, rig, [1.0])
    assert user.entered == fast.entered == 0
    with tracing() as records:
        render(win, rig, [1.0])
    assert records.spans and user.entered == fast.entered == 0
    with tracing() as records:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            render(win, rig, [1.0])
    assert fast.entered == len(records.spans) > 0 and user.entered == 0
    with tracing() as records:
        pass
    assert not records.spans and not records.counters


def test_ranges_share_one_offset_with_spans(tmp_path):
    """Inside ``trace``, each ``ty::`` range starts at its span's start
    plus one offset, within 100 us, and that offset is the one the recorder
    noted for the profile."""
    rig, win = sponza_window()
    render(win, rig, [1.0] * 2)
    with tracing() as records, trace(str(tmp_path)):
        render(win, rig, [1.0] * 2)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"].startswith(profiling.RANGE):
            ranges.setdefault(e["name"][len(profiling.RANGE):], []).append(
                base + e["ts"] * 1e3)
    assert len(records.profiles) == 1
    offsets = []
    for name in {s.name for s in records.spans}:
        starts = [s.start_ns for s in records.spans if s.name == name]
        assert len(ranges[name]) == len(starts), name
        offsets += [r - s for r, s in zip(sorted(ranges[name]), starts)]
    assert max(offsets) - min(offsets) < 100e3, (min(offsets), max(offsets))
    noted = records.profiles[0]["clock_offset_ns"]
    assert abs(statistics.median(offsets) - noted) < 100e3


def test_span_host_times_agree_with_outside_timers(monkeypatch):
    """``plan``, ``bin`` and ``shade`` time what a timer wrapped around
    build_frame_inputs, bin_triangles and shade_visibility, where the frame
    loop looks them up, times, frame by frame: within 10 % or 0.5 ms on the
    median frame (the collector paused, so that no collection lands
    between the two clocks)."""
    rig, win = sponza_window()
    render(win, rig, [1.0] * 2)
    host = collections.defaultdict(float)

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host[name] += time.perf_counter() - t0
            return out
        return call

    pairs = {"plan": "build_frame_inputs", "bin": "bin_triangles",
             "shade": "shade_visibility"}
    rf = forward.ForwardRenderingFunction
    monkeypatch.setattr(rf, "build_frame_inputs", timed(
        "build_frame_inputs", rf.build_frame_inputs))
    for attr in ("bin_triangles", "shade_visibility"):
        monkeypatch.setattr(passes, attr, timed(attr, getattr(passes, attr)))
    diffs = {name: [] for name in pairs}
    gc.disable()
    try:
        with tracing() as records:
            for _ in range(5):
                first = len(records.spans)
                before = {k: host[k] for k in pairs.values()}
                render(win, rig, [1.0])
                for name, fn in pairs.items():
                    spans = sum(s.end_ns - s.start_ns
                                for s in records.spans[first:]
                                if s.name == name) * 1e-9
                    timers = host[fn] - before[fn]
                    assert timers > 0, fn
                    diffs[name].append((abs(spans - timers),
                                        max(0.1 * timers, 0.5e-3)))
    finally:
        gc.enable()
    for name, d in diffs.items():
        diff, allowed = sorted(d)[len(d) // 2]
        assert diff <= allowed, (name, d)


def test_plan_changes_counter_matches_the_plan_after_each_render():
    """The ``plan.changes`` counter, counted where the rendering function
    replaces its plan, equals the number of frames after whose
    ``render()`` the plan differs from the one before, over a small
    config-5 walk from a cold start, while its capacities converge."""
    rig, win = sponza_window()
    rf = win.rendering_function
    changes, plan = 0, rf.plan
    with tracing() as records:
        for k in range(40):
            rig.fill(win.get_render_scene(), 2.0 * k)
            win.render()
            changes += rf.plan != plan
            plan = rf.plan
    counted = sum(c.get("plan.changes", 0)
                  for c in records.counters.values())
    assert changes > 1
    assert counted == changes


def test_frame_profiler_marks_presented_frames():
    """``FrameProfiler`` marks a frame when its image reaches the present
    target, with that frame's triangle count: nothing while the first
    frames are in flight, every frame once flushed."""
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rigs = [tt.scenes.config2_cube(dev, (48, 32)),
            tt.scenes.config1_triangle(dev, (48, 32))]
    presented = []
    win = tt.RenderWindow(dev, resolution=(48, 32),
                          present_mode="immediate",
                          present_target=presented.append)
    depth = win.get_swapchain_images()
    counts = []
    for k in range(depth):
        rig = rigs[k % 2]
        rig.fill(win.get_render_scene(), 0.1 * k)
        counts.append(rig.triangle_count)
        win.render()
    assert win.profiler.frame_count == 0
    for k in range(depth, depth + 2):
        rig = rigs[k % 2]
        rig.fill(win.get_render_scene(), 0.1 * k)
        counts.append(rig.triangle_count)
        win.render()
    assert win.profiler.frame_count == 2
    win.flush()
    prof = win.profiler
    assert prof.frame_count == len(presented) == depth + 2
    assert list(prof._tri_counts) == counts
    dt = prof._times[-1] - prof._times[0]
    assert prof.mtris_per_s() == pytest.approx(
        sum(counts[1:]) / dt / 1e6)
    assert set(prof.summary()) == {"fps", "frame_ms", "p99_ms",
                                   "mtris_per_s"}
    small = profiling.FrameProfiler(window=2)
    for c in (1, 2, 3, 4):
        small.frame(c)
    assert small.frame_count == 3 and list(small._tri_counts) == [2, 3, 4]
