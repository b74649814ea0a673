"""The readers of the program's spans and counters (``spans.py`` and the
metrics that use it) on hand-made records and events, and against a
program without the recorder."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import spans, spec

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _span(name, start, end, parent=-1, frame=None, profile=-1):
    return types.SimpleNamespace(name=name, start_ns=int(start * 1e6),
                                 end_ns=int(end * 1e6), parent=parent,
                                 frame=frame, profile=profile)


def _records():
    """Three frames (ms): 0 and 1 unprofiled, 2 profiled.  Frame 1 presents
    frame 0, whose fence was pending; frame 2 presents frame 1."""
    s = [
        _span("frame", 0, 10, frame=0),                        # 0
        _span("record", 0, 8, 0, 0),                           # 1
        _span("bin", 1, 6, 1, 0),                              # 2
        _span("bin.spill", 2, 5, 2, 0),                        # 3
        _span("frame", 12, 24, frame=1),                       # 4
        _span("record", 12, 18, 4, 1),                         # 5
        _span("bin", 13, 16, 5, 1),                            # 6
        _span("bin.spill", 13, 14, 6, 1),                      # 7
        _span("present", 18, 23, 4, 0),                        # 8
        _span("present.fence_wait", 18, 22, 8, 0),             # 9
        _span("frame", 30, 60, frame=2, profile=0),            # 10
        _span("present", 50, 55, 10, 1, profile=0),            # 11
        _span("present.fence_wait", 50, 51, 11, 1, profile=0),  # 12
        _span("flush", 70, 80),                                # 13
        _span("present", 70, 75, 13, 2),                       # 14
    ]
    counters = {0: {"present.fence_pending": 1},
                2: {"plan.changes": 2}}
    return types.SimpleNamespace(spans=s, counters=counters, profiles=[])


class _Evt:
    def __init__(self, name, start, end, device=CPU):
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = device


def _slice():
    """A profiled slice (us): frames 0-40 and 50-90 with a bin range in
    each, kernels 5-15, 30-45 and 60-70, the slice's edges 0 and 100; and
    the frame and bin ranges as the device timeline draws them."""
    return [
        _Evt("ty::frame", 0, 40), _Evt("ty::bin", 10, 30),
        _Evt("ty::frame", 50, 90), _Evt("ty::bin", 55, 80),
        _Evt("ty::frame", 0, 40, CUDA), _Evt("ty::bin", 10, 30, CUDA),
        _Evt("k", 5, 15, CUDA), _Evt("k", 30, 45, CUDA),
        _Evt("k", 60, 70, CUDA), _Evt("aten::sort", 95, 100),
    ]


def test_reduce_counts_the_unprofiled_frames():
    out = spans.reduce(_records(), [])
    assert out["frames"] == 2
    assert out["host_s"]["frame"] == pytest.approx(22e-3)
    assert out["host_s"]["bin.spill"] == pytest.approx(4e-3)
    assert out["host_s"]["present.fence_wait"] == pytest.approx(4e-3)
    assert "flush" not in out["host_s"]
    # frame 0 was presented in an unprofiled frame, its fence pending
    assert (out["presented"], out["fence_pending"]) == (1, 1)
    assert out["counters"] == {"present.fence_pending": 1,
                               "plan.changes": 2}
    assert out["idle_by_span"] == {}
    assert out["idle_outside_frame_s"] is None


def test_idle_by_innermost_span():
    """Idle 0-5, 15-30, 45-60 and 70-100 us: 0-5 in frame, 15-30 in bin,
    45-50 outside, 50-55 frame, 55-60 bin, 70-80 bin, 80-90 frame, 90-100
    outside."""
    sl = spans.idle_by_span(_slice())
    assert sl["span_s"] == pytest.approx(100e-6)
    assert sl["frames"] == 2
    got = {k: v * 1e6 for k, v in sl["idle_s"].items()}
    assert got == {"frame": pytest.approx(5 + 5 + 10),
                   "bin": pytest.approx(15 + 5 + 10),
                   spans.OUTSIDE: pytest.approx(5 + 10)}
    assert sl["outside_frame_s"] * 1e6 == pytest.approx(15)
    assert spans.idle_by_span([_Evt("k", 0, 5, CUDA)])["frames"] == 0


def _read(name, rec):
    return spec.metric_module(name).read(rec)


def test_readers_on_a_hand_made_record():
    prof = types.SimpleNamespace(events=_slice)
    rec = {"spans": spans.reduce(_records(), [prof])}
    assert _read("frame.host_ms", rec) == pytest.approx(11.0)
    assert _read("present.fence_wait_ms", rec) == pytest.approx(2.0)
    assert _read("present.fence_pending_pct", rec) == pytest.approx(100.0)
    assert _read("binning.spill_host_ms", rec) == pytest.approx(2.0)
    assert _read("ui.read_ms", rec) is None
    assert _read("device.idle_outside_frame_pct", rec) == pytest.approx(
        15.0)
    assert rec["spans"]["idle_by_span"]["frame"] == pytest.approx(
        20e-6 * 1e3 / 2)
    spans._close()


NEW = ("frame.host_ms", "present.fence_wait_ms",
       "present.fence_pending_pct", "binning.spill_host_ms", "ui.read_ms",
       "device.idle_outside_frame_pct")
OPENER = "frame.host_ms"


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    """On a program whose profiling module has no ``tracing`` every new
    reader loads, the hooks of the one that has them run and it reads
    None; nothing raises."""
    from tyleri_tpu_torch.utils import profiling

    spans._close()
    stop = torch.profiler.profile.stop
    monkeypatch.delattr(profiling, "tracing")
    opener = spec.metric_module(OPENER)
    mod = spec.metric_module(name)
    assert torch.profiler.profile.stop is stop
    assert opener.CAPTURE == ()
    rec = {"trace": {"last_of": []}}
    opener.after([], rec)
    assert rec["spans"] is None
    assert mod.read(rec) is None


def test_one_reader_opens_the_recorder():
    """Of the new readers only ``frame.host_ms`` opens the recording block
    and has the harness's hooks; its ``after`` closes the block and puts
    the profiler's stop back; the profiles kept are the slices, the
    set-up's left out."""
    from tyleri_tpu_torch.utils import profiling

    spans._close()
    stop = torch.profiler.profile.stop
    for name in NEW:
        if name != OPENER:
            mod = spec.metric_module(name)
            assert not profiling.recording()
            assert not hasattr(mod, "after") and not hasattr(mod, "capture")
    spec.metric_module(OPENER)
    assert profiling.recording()
    assert torch.profiler.profile.stop is not stop
    profs = []
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            with profiling.span("frame", frame=0):
                torch.ones(4).sum()
        profs.append(p)
    rec = {"trace": {"last_of": [{}, {}]}}
    spans.after([], rec)
    assert not profiling.recording()
    assert torch.profiler.profile.stop is stop
    assert rec["spans"]["frames"] == 0            # every frame profiled
    assert rec["spans"]["counters"] == {}
    assert rec["spans"]["profiled_span_s"] == pytest.approx(sum(
        spans.idle_by_span(p.events())["span_s"] for p in profs[1:]))
    spans.after([], rec)                          # once a run
