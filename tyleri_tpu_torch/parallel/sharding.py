"""Multi-device frame rendering over a (draws, tiles) mesh (counterpart of
``tyleri_tpu/parallel/sharding.py``).

Sort-first plus sort-last: every rank renders the draws of its ``draws``
coordinate (the round-robin mask draw % n == i) into the framebuffer band
of its ``tiles`` coordinate, then the ranks of a band composite by depth
with ``torch.distributed.all_reduce`` over the ``draws`` sub-group: MIN,
MAX and SUM reductions whose traffic a rank is twice the band's bytes or
so, whatever the length of the draws axis (the resolve is associative, so
nothing is gathered).  Every rank builds the same inputs; the frame it
returns is its band.

The composite resolves depth ties lexicographically on (depth, global draw
order) through the frame's order map, so draws that went to different
ranks resolve as the single-device submission order would.  In exact mode
the order map holds no mesh draw (-1), and equal-depth ties fall to the
lowest draws index.

Every collective runs on the caller's current CUDA stream (or on the CPU),
in the order every rank issues it: sub-groups are made once, and every
rank must render the same frames with the same plan.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tyleri_tpu_torch.parallel.mesh import AXIS_DRAWS, AXIS_TILES
from tyleri_tpu_torch.pipeline.state import CompareOp
from tyleri_tpu_torch.rendering.forward import FramePlan, frame_body
from tyleri_tpu_torch.rendering.function import Frame


def _band_plan(plan: FramePlan, n_tiles: int) -> FramePlan:
    """The plan of one band: ``band_h = ceil(fb_h / n_tiles)``.  A height
    that the bands do not divide is padded: every rank renders a whole band
    and ``gather_frame`` crops the rows past ``fb_h`` (fewer than
    ``n_tiles``, clear, since the scissors end at ``fb_h``)."""
    band_h = -(-plan.raster.fb_h // n_tiles)
    return dataclasses.replace(
        plan, raster=dataclasses.replace(plan.raster, fb_h=band_h))


def derive_draw_groups(cameras, n_draw_shards: int):
    """Each camera's draws as the reference's ParallelGroup spreads them
    over ``n_draw_shards`` threads (Camera::get_and_order_meshes, ref:
    src/render_objects/camera.rs:32-39), checked against the draw % n mask
    that the frame applies; returns, per camera, one list of draw indices a
    shard.  Raises RuntimeError if the two ever drift apart."""
    out = []
    for cam in cameras:
        pg = cam.get_and_order_meshes(n_draw_shards)
        per_shard = []
        for g in range(n_draw_shards):
            items = pg.get_group_by_thread(g) or []
            expect = cam.mesh_renderers[g::n_draw_shards]
            # a real exception, not an assert: it must survive python -O
            if [id(m) for m in items] != [id(m) for m in expect]:
                raise RuntimeError(
                    "ParallelGroup round-robin drifted from the draw % n "
                    "sharding mask")
            per_shard.append(list(range(g, len(cam.mesh_renderers),
                                        n_draw_shards)))
        out.append(per_shard)
    return out


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def render_frame_sharded(plan: FramePlan, mesh_state, ui_state, mesh,
                         *inputs) -> Frame:
    """This rank's band of the frame.  ``inputs`` are ``frame_body``'s,
    from ``ForwardRenderingFunction.build_frame_inputs``, the same on every
    rank.  Returns a Frame of the band (color [band_h, W, 4], depth, order)
    composited over the ``draws`` axis, with the overflow and crossing
    counters summed over the whole mesh and a demand of 0: the capacity
    fits do not engage on a mesh, as in the JAX package."""
    nd, nt = mesh.shape
    di, ti = mesh.get_coordinate()
    bplan = _band_plan(plan, nt)
    frame = frame_body(bplan, mesh_state, *inputs, ui_state=ui_state,
                       band_y0=ti * bplan.raster.fb_h, draw_mod=(nd, di))
    draws = mesh.get_group(AXIS_DRAWS)

    # min depth wins; depth >= 0, so its f32 bits order as i32 and MIN over
    # them is the exact f32 minimum
    zbits = frame.depth.view(torch.int32)
    zmin = _all_reduce(zbits.clone(), dist.ReduceOp.MIN, draws)
    at_min = zbits == zmin
    # equal depths follow the compare op on the global draw order: LESS
    # keeps the earliest draw (MIN), LESS_OR_EQUAL lets the latest
    # overwrite (MAX), as a single device's submission order does (ref:
    # src/pipeline/common_pipeline.rs:107-116)
    if mesh_state.depth.compare_op == CompareOp.LESS:
        okey = torch.where(at_min, frame.order, torch.inf)
        owin = _all_reduce(okey.clone(), dist.ReduceOp.MIN, draws)
    else:
        okey = torch.where(at_min, frame.order, -torch.inf)
        owin = _all_reduce(okey.clone(), dist.ReduceOp.MAX, draws)
    win = at_min & (okey == owin)
    # equal (depth, order) keys, e.g. the clear that every rank shares, go
    # to the lowest draws index
    owner = _all_reduce(
        torch.where(win, di, nd).to(torch.int32), dist.ReduceOp.MIN, draws)
    mine = win & (owner == di)
    color = _all_reduce(torch.where(mine[..., None], frame.color, 0.0),
                        dist.ReduceOp.SUM, draws)
    stats = torch.stack([frame.bin_overflow, frame.tile_overflow,
                         frame.clip_overflow, frame.clip_crossings])
    stats = stats.to(torch.int32)
    for axis in (AXIS_DRAWS, AXIS_TILES):   # summed over the whole mesh
        stats = _all_reduce(stats, dist.ReduceOp.SUM, mesh.get_group(axis))
    # a demand of 0 is no demand: the window's fits ignore it
    zero = torch.zeros_like(stats[0])
    return Frame(color=color, depth=zmin.view(torch.float32),
                 bin_overflow=stats[0], tile_overflow=stats[1], order=owin,
                 clip_overflow=stats[2], clip_crossings=stats[3],
                 bin_demand=zero, entry_demand=zero,
                 spill_demand=zero.new_zeros((0,)))


def gather_rows(band: torch.Tensor, mesh, fb_h: int) -> torch.Tensor:
    """The whole image from every rank's band of rows: an all_gather over
    the ``tiles`` axis, the bands in tile order, cropped to ``fb_h``."""
    tiles = mesh.get_group(AXIS_TILES)
    band = band.contiguous()
    parts = [torch.empty_like(band) for _ in range(mesh.shape[1])]
    dist.all_gather(parts, band, group=tiles)
    # all_gather lists the bands by group rank; the mesh row says which
    # global rank holds which band
    group_ranks = dist.get_process_group_ranks(tiles)
    di = mesh.get_coordinate()[0]
    row = mesh.mesh[di].tolist()
    return torch.cat([parts[group_ranks.index(r)] for r in row])[:fb_h]


def gather_frame(frame: Frame, mesh, fb_h: int) -> Frame:
    """A band frame's color, depth and order maps gathered into the whole
    frame's, on every rank (for tests and checks; the window gathers only
    its presented image)."""
    return frame._replace(color=gather_rows(frame.color, mesh, fb_h),
                          depth=gather_rows(frame.depth, mesh, fb_h),
                          order=gather_rows(frame.order, mesh, fb_h))
