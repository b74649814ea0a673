"""K3: per-tile visibility resolve (counterpart of
``tyleri_tpu/ops/raster_pallas.py``, base variant).

``rasterize_visibility`` runs the CUDA kernel ``csrc/visibility.cu`` on CUDA
tensors and the plain version ``rasterize_visibility_reference``
(ops/visibility.py) on CPU tensors.  Each tile streams its whole segment (no
per-tile capacity, so no tile overflow), front to back with the exact early
exit, then the broad list.  The maps come out at [fb_h, fb_w]; pixels past
the framebuffer are masked inside the kernel.
"""

from __future__ import annotations

import torch

from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries
from tyleri_tpu_torch.ops.visibility import (
    VisibilityBuffer,
    check_depth_state,
    rasterize_visibility_reference,
)

__all__ = ["rasterize_visibility", "rasterize_visibility_reference",
           "launches", "reset_launches"]

# kernel launches since the last reset (main-path accounting)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def rasterize_visibility(binned: BinnedEntries, init_depth, scissor, *,
                         fb_w: int, fb_h: int, tile_w: int, tile_h: int,
                         grid_w: int, grid_h: int, depth_state: DepthState,
                         chunk: int = 64) -> VisibilityBuffer:
    """Resolve visibility for every tile.  ``chunk`` is the number of entry
    rows the kernel stages in shared memory at a time."""
    dev = binned.entry_channels.device
    if dev.type == "cpu":
        return rasterize_visibility_reference(
            binned, init_depth, scissor, fb_w=fb_w, fb_h=fb_h, tile_w=tile_w,
            tile_h=tile_h, grid_w=grid_w, grid_h=grid_h,
            depth_state=depth_state)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_visibility: unsupported device {dev}")
    check_depth_state(depth_state)
    P = tile_w * tile_h
    if P % 32 or P > 1024:
        raise ValueError(f"tile {tile_w}x{tile_h}: one thread per pixel "
                         "needs a multiple of 32 threads, at most 1024")
    if not 0 < chunk <= 256:
        raise ValueError(f"chunk {chunk} outside (0, 256]")
    E = binned.entry_channels.shape[0]
    B = binned.broad_channels.shape[0]
    ntiles = grid_w * grid_h
    depth0 = init_depth.to(torch.float32).contiguous()
    for name, t, dt, shape in (
            ("entry_channels", binned.entry_channels, torch.float32,
             (E, S.NUM_CHANNELS)),
            ("tile_start", binned.tile_start, torch.int32, (ntiles + 1,)),
            ("broad_channels", binned.broad_channels, torch.float32,
             (B, S.NUM_CHANNELS)),
            ("broad_tiles", binned.broad_tiles, torch.int32, (B, 4)),
            ("num_broad", binned.num_broad, torch.int32, ()),
            ("init_depth", depth0, torch.float32, (fb_h, fb_w))):
        if (t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(
                f"rasterize_visibility: {name} must be a contiguous {dt} "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)}")
    if (grid_w * tile_w < fb_w or grid_h * tile_h < fb_h
            or (grid_w - 1) * tile_w >= fb_w or (grid_h - 1) * tile_h >= fb_h):
        raise ValueError("tile grid does not cover the framebuffer exactly")

    def empty(dtype):
        return torch.empty((fb_h, fb_w), dtype=dtype, device=dev)

    owner, tex = empty(torch.int32), empty(torch.int32)
    z, order, uw, vw, iw = (empty(torch.float32) for _ in range(5))
    lib = _build.load()
    global launches
    launches += 1
    err = lib.ty_rasterize_visibility(
        binned.tile_start.data_ptr(), binned.entry_channels.data_ptr(),
        binned.broad_channels.data_ptr(), binned.broad_tiles.data_ptr(),
        binned.num_broad.data_ptr(), B, depth0.data_ptr(),
        fb_w, fb_h, tile_w, tile_h, grid_w, grid_h,
        *S.scissor_ints(scissor),
        E, chunk,
        int(depth_state.compare_op == CompareOp.LESS_OR_EQUAL),
        int(depth_state.format == DepthFormat.D16_UNORM),
        owner.data_ptr(), z.data_ptr(), order.data_ptr(), uw.data_ptr(),
        vw.data_ptr(), iw.data_ptr(), tex.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rasterize_visibility")
    return VisibilityBuffer(owner=owner, depth=z, order=order, uw=uw, vw=vw,
                            iw=iw, tex=tex)
