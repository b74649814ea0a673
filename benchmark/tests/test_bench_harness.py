"""The harness on the CPU at small sizes: the result line, the metric
arithmetic, finding every piece by name, the generators, the imports."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness, scene, spec, stats, tracing
from benchmark.tests.conftest import ROOT, tiny_copy

SEED = 2**31 + 1234


def _measure(root, cell, trace, seconds=2.0):
    return harness.measure(spec.cell(cell, root), SEED, seconds, trace,
                           device_type="cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tmp_path, peel2_at_tiny, trace):
    out = _measure(tiny_copy(tmp_path), "sponza-1m-1080p.walk", bool(trace))
    res = out["result"]
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert list(res) == want + ["checks"]
    json.dumps(res)
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["attempted"] > 0
    cell = spec.cell("sponza-1m-1080p.walk", ROOT)
    named = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= named
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert set(res["metrics"]) == named
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(res["checks"]) == {"mismatch", "block_mismatch"}
    assert res["correct"], res["checks"]


def test_added_files_add_a_cell(tmp_path, peel2_at_tiny):
    """A configuration, a traffic mix, a metric, limits and a workload
    entry, all new files or entries, make a new cell that runs."""
    root = tiny_copy(tmp_path)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "sponza-1m-1080p.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "terrain-small"
    cfg["params"]["extent"] = 10.0
    with open(os.path.join(b, "configs", "terrain-small.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "still.json")) as f:
        trf = json.load(f)
    trf["time"] = {"start_uniform": [3.0, 4.0], "step": 0.05}
    with open(os.path.join(b, "traffic", "drift.json"), "w") as f:
        json.dump(trf, f)
    with open(os.path.join(b, "metrics", "frames.count.py"), "w") as f:
        f.write("def read(rec):\n    return rec['frames']\n")
    with open(os.path.join(b, "limits", "terrain-small.drift.json"),
              "w") as f:
        json.dump({"limits": {"mismatch": 0.01, "block_mismatch": 0.5}}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "terrain-small", "source": "x",
                             "file": "benchmark/configs/terrain-small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "terrain-small.drift",
                               "config": "terrain-small", "traffic": "drift",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "frames.count", "unit": "count",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["terrain-small.drift"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = _measure(root, "terrain-small.drift", False)["result"]
    assert res["metrics"]["frames.count"]["value"] == res["attempted"]
    assert res["correct"], res["checks"]


def test_percentile_matches_numpy():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100, 1001):
        v = rng.exponential(size=n).tolist()
        for q in (50, 95, 99):
            assert stats.percentile(v, q) == pytest.approx(
                np.percentile(v, q), rel=1e-12)
    assert stats.percentile([], 95) is None


def _read(name, rec):
    return spec.metric_module(name).read(rec)


def test_end_to_end_arithmetic():
    present = [0.0, 0.010, 0.020, 0.050, 0.060]
    rec = dict(window_s=0.1, frames=5, intervals_s=list(np.diff(present)),
               latencies_s=[0.03, 0.03, 0.04, 0.1, 0.03], setup_s=12.5)
    assert _read("frame_ms", rec) == pytest.approx(20.0)
    # every interval counts: the one 30 ms stall sets the tail
    assert _read("frame_ms_p95", rec) == pytest.approx(
        np.percentile([10, 10, 30, 10], 95))
    assert _read("latency_ms_p95", rec) == pytest.approx(
        np.percentile([30, 30, 40, 100, 30], 95))
    assert _read("setup_s", rec) == 12.5


def test_idle_is_the_union_of_device_intervals():
    # overlapping and nested intervals count once
    merged = tracing._union([(0, 4), (2, 6), (3, 5), (10, 12), (12, 13)])
    assert merged == [[0, 6], [10, 13]]
    rec = {"trace": {"span_s": 20.0, "busy_s": 9.0}}
    assert _read("device.idle_pct", rec) == pytest.approx(55.0)


class _Evt:
    def __init__(self, name, start, end, cuda, kernels=()):
        import torch

        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.kernels = list(kernels)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        return []


def test_reduce_slice_on_synthetic_events():
    """Device 0-40 and 30-50 and 80-90 us in a 0-100 us span: busy 60 us,
    two idle gaps named by the stage the host was in; the stage's device
    time from the kernels launched inside its range."""
    k = type("K", (), {})
    kern = k()
    kern.duration = 40.0
    evs = [_Evt("stage::bin_triangles", 0, 60, False),
           _Evt("cudaLaunchKernel", 5, 6, False, [kern]),
           _Evt("stage::shade_visibility", 60, 100, False),
           _Evt("visibility_kernel", 0, 40, True),
           _Evt("visibility_kernel", 30, 50, True),
           _Evt("Memcpy DtoH", 80, 90, True)]
    sl = tracing.reduce_slice(_Prof(evs), frames=2)
    assert sl["span_s"] == pytest.approx(100e-6)
    assert sl["busy_s"] == pytest.approx(60e-6)
    assert sl["stage_device_s"] == {"bin_triangles": pytest.approx(40e-6),
                                    "shade_visibility": 0.0}
    assert sorted(sl["gaps"]) == [
        (pytest.approx(10e-6), "stage::shade_visibility"),
        (pytest.approx(30e-6), "stage::bin_triangles")]
    tr = tracing.merge([sl])
    assert tracing.op_seconds(tr, "visibility_kernel") == pytest.approx(
        60e-6)
    assert tr["last_of"][0]["visibility_kernel"] == pytest.approx(20e-6)
    bd = tracing.breakdown(tr)
    assert bd["device_ops"][0] == ["visibility_kernel", pytest.approx(60e-6)]
    assert len(bd["idle_gaps"]) == 2


def test_stage_device_time_from_device_ranges():
    """Where the device timeline carries the stage ranges, a stage's device
    time is the busy time inside them; the ranges are no device work."""
    evs = [_Evt("stage::bin_triangles", 0, 60, False),
           _Evt("stage::bin_triangles", 0, 45, True),
           _Evt("stage::shade_visibility", 80, 95, True),
           _Evt("k_a", 0, 40, True), _Evt("k_b", 30, 50, True),
           _Evt("Memcpy DtoH", 80, 90, True)]
    sl = tracing.reduce_slice(_Prof(evs), frames=1)
    assert sl["stage_source"] == "device_range"
    assert sl["busy_s"] == pytest.approx(60e-6)
    assert set(sl["ops"]) == {"k_a", "k_b", "Memcpy DtoH"}
    assert sl["stage_device_s"] == {"bin_triangles": pytest.approx(45e-6),
                                    "shade_visibility": pytest.approx(10e-6)}


@pytest.mark.parametrize("config", ["sponza-1m-1080p", "instances-100-1080p"])
def test_generators_deterministic_per_seed(config):
    cfg = spec._load_json(os.path.join(ROOT, "benchmark", "configs",
                                       f"{config}.json"))
    cfg["params"].update({k: v for k, v in (("grid_n", 40),)
                          if k in cfg["params"]})
    gen = scene.generator(cfg["generator"])
    a, b, c = (gen.build(cfg["params"], s) for s in (SEED, SEED, SEED + 1))

    def arrays(sc, t):
        v = sc.frame(t)
        return ([m.positions for m in sc.meshes] + [v.view]
                + [d.model for d in v.draws] + sc.textures)

    for t in (0.0, 1.7):
        assert all(np.array_equal(x, y) for x, y in zip(arrays(a, t),
                                                         arrays(b, t)))
        # the heightfields are the configuration's for every seed; the
        # instances' offsets and spins are the seed's
        same = all(np.array_equal(x, y)
                   for x, y in zip(arrays(a, t), arrays(c, t)))
        assert same == (config == "sponza-1m-1080p")
    assert a.triangle_count == b.triangle_count == c.triangle_count


def test_overlay_and_clock_deterministic_per_seed():
    trf = spec._load_json(os.path.join(ROOT, "benchmark", "traffic",
                                       "walk-hud256.json"))
    ov = trf["overlay"]
    gen = scene.generator(ov["generator"])
    a, b, c = (gen.build(ov["params"], s) for s in (SEED, SEED, SEED + 1))
    assert a.triangle_count == 256
    for (va, ia, ta), (vb, ib, tb) in zip(a.elements, b.elements):
        assert np.array_equal(va, vb) and np.array_equal(ia, ib) and ta == tb
    assert not np.array_equal(a.elements[1][0], c.elements[1][0])
    clocks = [harness.Clock(trf["time"], s) for s in (SEED, SEED, SEED + 1)]
    ks = range(0, 500, 7)
    # the warm-up's frames are the same for every seed
    assert len({tuple(c(k) for k in ks) for c in clocks}) == 1
    for c in clocks:
        c.first = 300
    ks = range(300, 800, 7)
    assert [clocks[0](k) for k in ks] == [clocks[1](k) for k in ks]
    assert [clocks[0](k) for k in ks] != [clocks[2](k) for k in ks]
    # one revolution of 240 poses from any start: the same set of poses
    step = trf["time"]["step"]
    poses = [{round(c(k) / step) % 240 for k in range(300, 540)}
             for c in clocks]
    assert poses[0] == poses[2] == set(range(240))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                      recursive=True)
    assert files
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)


def test_reference_takes_nothing_of_the_program():
    """The reference, the comparison, the scene data and the yardstick
    import nothing of tyleri_tpu_torch."""
    b = os.path.join(ROOT, "benchmark")
    files = [os.path.join(b, n) for n in ("reference.py", "compare.py",
                                          "scene.py", "math3d.py",
                                          "roofline.py", "stats.py")]
    files += glob.glob(os.path.join(b, "scenes", "*.py"))
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "tyleri_tpu_torch" not in tops, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tyleri_tpu_torch_x", sys)
    assert "tyleri_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "sponza-1m-1080p.still", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_every_cell_finds_its_files():
    bench = spec._load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert set(cell.limits["limits"]) == {"mismatch", "block_mismatch"}
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(spec.metric_module(m["name"]), "read")
    for st in spec.stages():
        owner, attr = tracing._owner(st)
        assert callable(getattr(owner, attr)), st


def test_frozen_scenes_keep_the_renderers_geometry():
    """The benchmark's copies make the geometry of the renderer's own
    BASELINE scenes (the heightfields whatever the seed; the instances'
    meshes and textures)."""
    from tyleri_tpu_torch.models import primitives

    cfg = spec.cell("sponza-1m-1080p.walk").config
    params = dict(cfg["params"], grid_n=48)
    sc = scene.generator(cfg["generator"]).build(params, SEED)
    for li, m in enumerate(sc.meshes):
        v, i = primitives.displaced_grid(48, extent=params["extent"],
                                         seed=li)
        v[:, 1] += (li - 1) * params["spacing"]
        assert np.array_equal(m.positions, v[:, :3])
        assert np.array_equal(m.uvs, v[:, 3:])
        assert np.array_equal(m.indices, i)
    cfg = spec.cell("instances-100-1080p.spin").config
    sc = scene.generator(cfg["generator"]).build(cfg["params"], SEED)
    for m, (v, i) in zip(sc.meshes, (primitives.cube(0.5),
                                     primitives.uv_sphere(8, 12, 0.3))):
        assert np.array_equal(np.concatenate([m.positions, m.uvs], 1), v)
        assert np.array_equal(m.indices, i)
    assert np.array_equal(sc.textures[1], primitives.gradient_texture(32))
    assert sc.triangle_count == cfg["triangles"]
