"""The benchmark's own tests: ``python -m pytest --confcutdir=benchmark
benchmark/tests`` from the repository root (``--confcutdir`` keeps the
repository's conftest, which imports JAX, out).  Tests that need a CUDA
card carry the ``cuda`` marker and skip without one."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "cuda: needs a CUDA card")
    # the CPU runs are small: few threads a worker keep workers apart
    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


# small sizes for the CPU: the configurations at a 160x96 target, the
# heightfields at 40 x 40
TINY = {"resolution": [160, 96], "grid_n": 40}


def tiny_copy(dst, *, peel2_max_tris=None):
    """A checkout's benchmark files in ``dst`` with every configuration cut
    to TINY and every warm-up and trace shortened: what a data file added
    there changes, no code here sees."""
    dst = str(dst)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub, edit in (("configs", _tiny_config), ("traffic", _short_traffic)):
        d = os.path.join(dst, "benchmark", sub)
        for name in os.listdir(d):
            path = os.path.join(d, name)
            with open(path) as f:
                data = json.load(f)
            edit(data)
            with open(path, "w") as f:
                json.dump(data, f)
    return dst


def _tiny_config(c):
    for k, v in TINY.items():
        if k in c["params"]:
            c["params"][k] = v


def _short_traffic(t):
    short = {"min_frames": 4, "stable_frames": 2, "max_frames": 12}
    if "mesh_only" in t["warmup"]:
        short["mesh_only"] = {"min_frames": 2, "stable_frames": 1,
                              "max_frames": 4}
    t["warmup"] = short
    t["trace"] = {"slices": 1, "frames": 2}
    if t.get("overlay"):
        # the overlay at a quarter of its size, as on a quarter-size screen
        t["overlay"]["params"]["scale_factor"] = 0.25
    t["check"] = {"frames": 2}


@pytest.fixture
def peel2_at_tiny(monkeypatch):
    """The blend policy's triangle bound at the instances' 9,000 triangles,
    below the tiny heightfields' 9,126: the layers each configuration
    states (two and one), at the tiny sizes."""
    from tyleri_tpu_torch.rendering import forward

    monkeypatch.setattr(forward, "BLEND_PARITY_PEEL2_MAX_TRIS", 9000)
