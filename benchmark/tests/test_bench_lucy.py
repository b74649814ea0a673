"""The statue cell's own files: the readers of binning's counters
(``binning.live_tris``, which opens the program's recorder in its cell,
and ``binning.entries``) on hand-made records, on a program that records
spans but counts nothing of binning, and on a program without the recorder;
the scene the same for every seed; and on the card, the control failing the
cell's limits at the cell's size."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare, harness, reference, scene, spans, spec

CELL = "lucy-28m-1080p.orbit"
READERS = ("binning.live_tris", "binning.entries")
OPENER = "binning.live_tris"
SEED = 2**31 + 5151


def _rec(counters):
    return {"spans": {"counters": counters}}


def test_readers_divide_the_totals_by_the_reports():
    rec = _rec({"bin.reported": 4, "bin.live": 400, "bin.entries": 530,
                "plan.changes": 1})
    live, entries = (spec.metric_module(n).read(rec) for n in READERS)
    spans._close()
    assert live == pytest.approx(100.0)
    assert entries == pytest.approx(132.5)


@pytest.mark.parametrize("rec", [{"spans": None}, _rec({}),
                                 _rec({"plan.changes": 2}),
                                 _rec({"bin.reported": 0})])
def test_a_program_that_counts_no_binning_reads_nothing(rec):
    for name in READERS:
        assert spec.metric_module(name).read(rec) is None
    spans._close()


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    """On a program whose profiling module has no ``tracing`` both readers
    load, the opener's hooks run, and each reads None; nothing raises."""
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


def test_the_opener_records_the_window_counters():
    """Loading ``binning.live_tris`` opens the recording block; counts made
    in it reach ``rec["spans"]`` once its ``after`` closes the block, and
    ``binning.entries`` has no hooks of its own."""
    from tyleri_tpu_torch.utils import profiling

    spans._close()
    entries = spec.metric_module("binning.entries")
    assert not profiling.recording()
    assert not hasattr(entries, "after") and not hasattr(entries, "capture")
    opener = spec.metric_module(OPENER)
    assert profiling.recording()
    for frame in range(3):
        with profiling.span("present", frame=frame):
            profiling.count("bin.reported")
            profiling.count("bin.live", 10 + frame)
            profiling.count("bin.entries", 20)
    rec = {"trace": {"last_of": []}}
    opener.after([], rec)
    assert not profiling.recording()
    assert opener.read(rec) == pytest.approx(11.0)
    assert entries.read(rec) == pytest.approx(20.0)


def test_the_statue_is_the_same_for_every_seed():
    cfg = spec.cell(CELL).config
    params = dict(cfg["params"], cells=[24, 60, 18], texture=64)
    gen = scene.generator(cfg["generator"])
    a, b = (gen.build(params, s) for s in (SEED, SEED + 1))
    for x, y in ((a.meshes[0].positions, b.meshes[0].positions),
                 (a.meshes[0].uvs, b.meshes[0].uvs),
                 (a.meshes[0].indices, b.meshes[0].indices),
                 (a.textures[0], b.textures[0]),
                 (a.frame(3.0).view, b.frame(3.0).view)):
        assert np.array_equal(x, y)
    assert a.triangle_count == 2 * 2 * (24 * 60 + 60 * 18 + 18 * 24)
    # one revolution of the orbit is 240 poses of the traffic's step
    trf = spec.cell(CELL).traffic["time"]
    th = cfg["params"]["camera"]["orbit_rate"] * trf["step"] * 240
    assert th == pytest.approx(2 * np.pi)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(cuda_device):
    cell = spec.cell(CELL)
    sc = scene.generator(cell.config["generator"]).build(
        cell.config["params"], SEED)
    clock = harness.Clock(cell.traffic["time"], SEED)
    clock.first = 0  # the window's frame times, from the seed's start
    view = sc.frame(clock(17))
    want = reference.render(sc, view, cell.config, cuda_device)
    low = reference.render(sc, view, cell.config, cuda_device,
                           precision="bf16")
    n = compare.numbers(low, want)
    limits = cell.limits["limits"]
    assert any(n[k] > limits[k] for k in limits), (n, limits)
