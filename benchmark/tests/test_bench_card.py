"""On the card: a traced run of a whole cell reads every per-layer metric
within its range, and the control fails each cell's limits at the cell's
own size.  ``python -m pytest --confcutdir=benchmark -m cuda
benchmark/tests`` on a machine with a CUDA card."""

from __future__ import annotations

import pytest

from benchmark import compare, harness, reference, scene, spec

SEED = 2**31 + 4242


@pytest.mark.cuda
def test_traced_still_cell_reads_its_layers(cuda_device):
    cell = spec.cell("sponza-1m-1080p.still")
    res = harness.measure(cell, SEED, 20.0, True)["result"]
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["k3_roofline"] <= 105
    assert 0 < m["k1k2_roofline"] <= 105
    assert 0 <= m["device.idle_pct"] < 100
    assert m["plan.changes"] == 0
    assert res["device"]["busy_s"] > 0
    assert len(res["breakdown"]["device_ops"]) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["sponza-1m-1080p.walk",
                                       "instances-100-1080p.spin",
                                       "sponza-1m-1080p.walk-hud256",
                                       "sponza-1m-1080p.still"])
def test_control_fails_at_the_cells_size(cuda_device, cell_name):
    cell = spec.cell(cell_name)
    sc = scene.generator(cell.config["generator"]).build(
        cell.config["params"], SEED)
    ov = cell.traffic["overlay"]
    overlay = (scene.generator(ov["generator"]).build(ov["params"], SEED)
               if ov else None)
    clock = harness.Clock(cell.traffic["time"], SEED)
    clock.first = 0  # the window's frame times, from the seed's start
    view = sc.frame(clock(17))
    want = reference.render(sc, view, cell.config, cuda_device, overlay)
    low = reference.render(sc, view, cell.config, cuda_device, overlay,
                           precision="bf16")
    n = compare.numbers(low, want)
    limits = cell.limits["limits"]
    assert any(n[k] > limits[k] for k in limits), (n, limits)
