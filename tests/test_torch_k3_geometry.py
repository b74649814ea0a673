"""K3's launch geometry (``ops/raster_cuda.py::k3_launch``) on the CPU: for
every tile shape the plans use, the kernel's threads and their pixel slots
cover each pixel of the tile exactly once, within the card's thread
limits; the pixels a thread match the kernel source's constant.  Nothing
here asks whether a card exists."""

import os
import re
import subprocess
import sys

import pytest

from tyleri_tpu_torch.ops import raster_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("tile", [(8, 8), (16, 16), (64, 16), (16, 32),
                                  (8, 4), (4, 4)])
def test_every_pixel_has_one_thread_slot(tile):
    tile_w, tile_h = tile
    g = raster_cuda.k3_launch(tile_w, tile_h)
    assert g.ppt == raster_cuda.K3_PPT
    assert g.threads * g.ppt == tile_w * tile_h
    # whole warps up to the CTA limit, or one power-of-two partial warp
    assert 1 <= g.threads <= 1024
    if g.threads >= 32:
        assert g.threads % 32 == 0
    else:
        assert g.threads & (g.threads - 1) == 0
    seen = {}
    for thread in range(g.threads):
        columns = set()
        for slot in range(g.ppt):
            x, y = g.pixel(thread, slot)
            assert 0 <= x < tile_w and 0 <= y < tile_h
            assert (x, y) not in seen, (x, y, seen.get((x, y)))
            seen[(x, y)] = (thread, slot)
            columns.add(x)
        assert len(columns) == 1   # one column a thread: c * x once
    assert len(seen) == tile_w * tile_h


@pytest.mark.parametrize("tile,threads", [
    ((16, 16), 128), ((8, 8), 32), ((64, 16), 512), ((16, 32), 256),
    ((64, 32), 1024), ((48, 4), 96), ((8, 4), 16)])
def test_threads_a_tile(tile, threads):
    assert raster_cuda.k3_launch(*tile).threads == threads


@pytest.mark.parametrize("tile", [
    (16, 1),     # fewer rows than pixels a thread
    (64, 64),    # 2048 threads
    (4, 6),      # 12 threads: a partial warp not a power of two
    (12, 8),     # 48 threads: one and a half warps
])
def test_shapes_the_kernel_cannot_take(tile):
    with pytest.raises(ValueError):
        raster_cuda.k3_launch(*tile)


def test_pixels_a_thread_match_the_kernel_source():
    with open(os.path.join(ROOT, "tyleri_tpu_torch", "csrc",
                           "visibility.cu")) as f:
        src = f.read()
    m = re.search(r"^constexpr int PPT = (\d+);", src, re.M)
    assert m, "PPT not found in csrc/visibility.cu"
    assert raster_cuda.K3_PPT == int(m[1])


def test_importing_the_wrappers_touches_no_card():
    code = ("import torch\n"
            "from tyleri_tpu_torch import _build\n"
            "from tyleri_tpu_torch.ops import raster_cuda, setup_cuda\n"
            "raster_cuda.k3_launch(16, 16)\n"
            "print(torch.cuda.is_initialized(), _build._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True)
    assert out.stdout.split() == ["False", "True"]
