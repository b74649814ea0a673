"""K3: per-tile visibility resolve (counterpart of
``tyleri_tpu/ops/raster_pallas.py``).

``rasterize_visibility`` runs the CUDA kernel ``csrc/visibility.cu`` on CUDA
tensors and its plain version ``rasterize_visibility_stream_reference``
(ops/visibility.py) on CPU tensors.  Each tile streams its whole segment
(no per-tile capacity, so no tile overflow), front to back with the early
exit, then the broad list.  The maps come out at [fb_h, fb_w]; pixels past
the framebuffer are masked inside the kernel.

The kernel's launch geometry comes from ``k3_launch``: one CTA a tile,
each thread ``K3_PPT`` pixels of one column of it (the source's ``PPT``),
the tiles launched longest segment first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tyleri_tpu_torch.pipeline.state import DepthState
from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries
from tyleri_tpu_torch.ops.visibility import (
    VisibilityBuffer,
    depth_flags,
    rasterize_visibility_reference,
    rasterize_visibility_stream_reference,
)

__all__ = ["rasterize_visibility", "rasterize_visibility_reference",
           "rasterize_visibility_stream_reference", "K3_NAMES", "K3_PPT",
           "K3Launch", "k3_launch"]

# pixels a thread of every variant (csrc/visibility.cu: PPT)
K3_PPT = 2
# K3's variants by their kernel names in _build.launches
K3_NAMES = {"base": "rasterize_visibility",
            "peel2": "rasterize_visibility_peel2",
            "counts": "rasterize_visibility_counts"}


class K3Launch(NamedTuple):
    """K3's CTA for one tile: ``threads`` threads, each holding ``ppt``
    pixels of one column, rows g, g + G, ... of the tile (G = tile_h /
    ppt row groups)."""

    tile_w: int
    tile_h: int
    threads: int
    ppt: int

    def pixel(self, thread: int, slot: int) -> tuple[int, int]:
        """(x, y) within the tile of a thread's pixel ``slot``."""
        groups = self.threads // self.tile_w
        return thread % self.tile_w, thread // self.tile_w + slot * groups


def k3_launch(tile_w: int, tile_h: int) -> K3Launch:
    """K3's launch geometry on tile_w x tile_h tiles.  The threads are whole
    warps, at most 1024, or one partial warp of a power-of-two size (an 8x4
    tile is 16 threads)."""
    ppt = K3_PPT
    threads = tile_w * tile_h // ppt
    if (tile_w <= 0 or tile_h <= 0 or tile_h % ppt or threads > 1024
            or (threads % 32 if threads >= 32 else threads & (threads - 1))):
        raise ValueError(
            f"tile {tile_w}x{tile_h}: K3 gives each thread {ppt} "
            f"rows of one column, so tile_h must be a multiple of {ppt} and "
            f"the {threads} threads whole warps (at most 1024) or one "
            "power-of-two partial warp")
    return K3Launch(tile_w, tile_h, threads, ppt)


def rasterize_visibility(binned: BinnedEntries, init_depth, scissor, *,
                         fb_w: int, fb_h: int, tile_w: int, tile_h: int,
                         grid_w: int, grid_h: int, depth_state: DepthState,
                         chunk: int = 64, peel2: bool = False,
                         counts: bool = False):
    """Resolve visibility for every tile.  ``chunk`` is the number of entry
    rows the kernel stages in shared memory at a time (two chunks in
    flight); ``binned.entry_channels`` must be 16-byte aligned on the card.

    Returns the VisibilityBuffer; with ``peel2`` (vis, layer-2 vis), the
    depth-record holder before each pixel's winner (owner -1 where there is
    none or it cannot be named); with ``counts`` (vis, nvis i32 [grid_h,
    grid_w]), the narrow entries each tile resolved before its early exit.
    """
    if peel2 and counts:
        raise ValueError("peel2 does not compose with counts")
    dev = binned.entry_channels.device
    if dev.type == "cpu":
        return rasterize_visibility_stream_reference(
            binned, init_depth, scissor, fb_w=fb_w, fb_h=fb_h, tile_w=tile_w,
            tile_h=tile_h, grid_w=grid_w, grid_h=grid_h,
            depth_state=depth_state, chunk=chunk, peel2=peel2, counts=counts)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_visibility: unsupported device {dev}")
    le, d16 = depth_flags(depth_state)
    kernel = K3_NAMES["peel2" if peel2 else "counts" if counts else "base"]
    geometry = k3_launch(tile_w, tile_h)
    if not 0 < chunk <= 256:
        raise ValueError(f"chunk {chunk} outside (0, 256]")
    E = binned.entry_channels.shape[0]
    B = binned.broad_channels.shape[0]
    ntiles = grid_w * grid_h
    depth0 = init_depth.to(torch.float32).contiguous()
    _build.check_args(kernel, dev, (
        ("entry_channels", binned.entry_channels, torch.float32,
         (E, S.NUM_CHANNELS)),
        ("tile_start", binned.tile_start, torch.int32, (ntiles + 1,)),
        ("broad_channels", binned.broad_channels, torch.float32,
         (B, S.NUM_CHANNELS)),
        ("broad_tiles", binned.broad_tiles, torch.int32, (B, 4)),
        ("num_broad", binned.num_broad, torch.int32, ()),
        ("init_depth", depth0, torch.float32, (fb_h, fb_w))))
    if (grid_w * tile_w < fb_w or grid_h * tile_h < fb_h
            or (grid_w - 1) * tile_w >= fb_w or (grid_h - 1) * tile_h >= fb_h):
        raise ValueError("tile grid does not cover the framebuffer exactly")
    if binned.entry_channels.data_ptr() % 16:
        raise ValueError("rasterize_visibility: entry_channels must be 16-byte "
                         "aligned (the kernel copies its rows 16 B at a time)")

    def empty(dtype):
        return torch.empty((fb_h, fb_w), dtype=dtype, device=dev)

    def maps():
        return VisibilityBuffer(
            owner=empty(torch.int32), depth=empty(torch.float32),
            order=empty(torch.float32), uw=empty(torch.float32),
            vw=empty(torch.float32), iw=empty(torch.float32),
            tex=empty(torch.int32))

    vis = maps()
    vis2 = maps() if peel2 else None
    nvis = (torch.empty((grid_h, grid_w), dtype=torch.int32, device=dev)
            if counts else None)
    tile_order = torch.empty((ntiles,), dtype=torch.int32, device=dev)
    _build.launcher(kernel, "ty_rasterize_visibility", dev, (
        binned.tile_start.data_ptr(), binned.entry_channels.data_ptr(),
        binned.broad_channels.data_ptr(), binned.broad_tiles.data_ptr(),
        binned.num_broad.data_ptr(), B, depth0.data_ptr(),
        fb_w, fb_h, tile_w, tile_h, grid_w, grid_h,
        *S.scissor_ints(scissor),
        E, chunk,
        int(le), int(d16), geometry.threads, geometry.ppt,
        *(t.data_ptr() for t in vis),
        *((t.data_ptr() for t in vis2) if peel2 else (None,) * 7),
        nvis.data_ptr() if counts else None, tile_order.data_ptr()))()
    if peel2:
        return vis, vis2
    if counts:
        return vis, nvis
    return vis
