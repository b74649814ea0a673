"""The P3 probe kernel's launch geometry (``tools/exp_visibility.py::
p3_launch``) on the CPU: at every tile height the tool uses, the kernel's
threads and their pixel slots cover each pixel of the 128 x tile_h tile
exactly once, a thread's pixels lie in one column, the CTA fits the card's
1,024 threads, and the rule matches the kernel source's.  Nothing here asks
whether a card exists."""

import os
import re

import pytest

from tyleri_tpu_torch.tools import exp_visibility as V

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tyleri_tpu_torch", "csrc",
                      "probes_visibility.cu")


@pytest.mark.parametrize("tile_h,threads,ppt", [
    (8, 512, 2), (16, 1024, 2), (32, 1024, 4), (64, 1024, 8)])
def test_every_pixel_has_one_thread_slot(tile_h, threads, ppt):
    g = V.p3_launch(tile_h)
    assert (g.tile_h, g.threads, g.ppt) == (tile_h, threads, ppt)
    assert g.threads <= 1024 and g.threads % 32 == 0
    seen = {}
    for thread in range(g.threads):
        columns = set()
        for slot in range(g.ppt):
            x, y = g.pixel(thread, slot)
            assert 0 <= x < V.TILE_W and 0 <= y < tile_h
            assert (x, y) not in seen, (x, y, seen.get((x, y)))
            seen[(x, y)] = (thread, slot)
            columns.add(x)
        assert len(columns) == 1   # one column a thread: c * x once
    assert len(seen) == V.TILE_W * tile_h


@pytest.mark.parametrize("tile_h", [
    0, -16,
    3,      # not a multiple of its 2 pixels a thread
    24,     # 3 pixels a thread: no such instance
    128,    # 16 pixels a thread: no such instance
])
def test_tile_heights_the_kernel_cannot_take(tile_h):
    with pytest.raises(ValueError):
        V.p3_launch(tile_h)


def test_geometry_rule_matches_the_kernel_source():
    with open(SOURCE) as f:
        src = f.read()
    consts = {name: int(value) for name, value in re.findall(
        r"^constexpr int (MIN_PPT|MAX_THREADS) = (\d+);", src, re.M)}
    assert consts == {"MIN_PPT": V.P3_MIN_PPT,
                      "MAX_THREADS": V.P3_MAX_THREADS}
    # the instances' pixels a thread: the first argument of each X(...)
    block = src[src.index("#define TY_VARIANTS(X)"):]
    block = block[:block.index("\n\n")]
    ppts = {int(m) for m in re.findall(r"X\((\d+),", block)}
    assert ppts == set(V.P3_PPTS)
    # the C entry point's check, with the source's constants
    for tile_h in (8, 16, 32, 64):
        g = V.p3_launch(tile_h)
        assert g.ppt == max(consts["MIN_PPT"], -(-V.TILE_W * tile_h
                                                 // consts["MAX_THREADS"]))
        assert g.threads * g.ppt == V.TILE_W * tile_h


def test_every_tile_height_of_the_tool_has_a_geometry():
    heights = {kw.get("tile_h", 16) for kw in V.VARIANTS.values()
               if kw["kind"] != "prod"}
    assert heights == {8, 16, 32, 64}
    for tile_h in heights:
        assert V.p3_launch(tile_h).ppt in V.P3_PPTS
