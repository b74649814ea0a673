"""P3: K3's resolve by tile shape, chunk size and ablation, and on a table
packed five entries a row (counterpart of ``tools/exp_visibility.py``:
``_variant_kernel`` and ``_packed_kernel``).

The harness builds sponza's frame at 1920x1080 (``config5_sponza``) through
``build_frame_inputs``, ``transform_corner_table``, ``near_clip_triangles``
and ``setup_triangles``, and bins it with ``bin_triangles`` once per tile
height at tile_w = 128, growing the spill and broad capacities until
nothing is dropped.  Each variant resolves that table (or empty segments,
or ``seg`` entries a tile) against a depth of 1.0:

* ``variant_reference`` / ``run_variant``: every tile's segment in chunks
  of ``chunk`` entries from the chunk-aligned base below its start, each
  chunk at ``min(base + k * chunk, E - chunk)`` (so an entry may be
  resolved twice, as in the TPU kernel); an entry counts where ``start <=
  idx < end``.  ``lex``: the production compare; ``exit``: the early exit
  on the first live entry's CH_ZMIN against the tile's max depth (``lag2``:
  the max from two chunks back); ``strip_attrs``: only depth and owner
  move; ``hoist_loads``: every entry reads chunk row 0's coefficients;
  ``e2_stored``: e2 as the plane in channels 6..8, which the harness
  refills (``refill_e2``).  The depth is padded with -inf.
* ``packed_reference`` / ``run_packed``: the production resolve on
  ``pack5``'s table, windows of 26 rows (130 entries) from the row of
  ``start // 5``, clamped at the table's end.  The TPU kernel's shared
  resolve reads a name it never defines (``e2_stored``, ROADMAP R8) and
  raises when traced; the port derives e2, as production does.

Three TPU knobs change nothing computed, and their names run the kernel of
the setting they leave: ``dynroll`` (coefficients by a VMEM sublane slice
instead of SMEM scalar loads) runs the plain loads; ``zmax`` and
``zmaxdma`` (the tile max carried, and DMA gated on an always-true flag)
run without an exit, where nvcc drops the unread max; ``exitw`` and
``exitw2`` (the exit as a while loop) run the exit.  ``unroll`` is kept:
the kernel unrolls its entry loop by it.  The ``prod`` rows run the port's
K3 (``ops/raster_cuda.py``) at its own 16x16 tiles and 64-row chunks
(``prodc32``: 32), the visit count from its counter.

Kernel: ``csrc/probes_visibility.cu`` ``variant_kernel``, bit-equal to the
plain versions, on K3's design: a thread holds ``ppt`` pixels of one column
(``p3_launch`` gives the CTA's threads and ``ppt`` by tile height), the
tiles launch longest segment first.  Each call also returns the live
entries each tile resolved (``nres``), which the bound counts; each record
gives their max and mean over the tiles.

    python3 -m tyleri_tpu_torch.tools.exp_visibility [--device cpu]
        [--grid-n N] [--resolution WxH] [variant ...]
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.tools import _common

TILE_W = 128
PACK = 5
ROWS_PER_WIN = 26
ENT_PER_WIN = PACK * ROWS_PER_WIN
PACK_LANES = 128
ENTRY_BYTES = 4 * S.NUM_CHANNELS
MAPS = 7
# f32 operations per (entry, pixel) pair, counted from the kernel's source:
# three planes (4 each), e2 derived (2), the clamp (2) and the D16 rounding
# (3) make 19; six coverage compares, z == zc and the depth compare make 8,
# and the lex compare 2 more (K3's 29).  A stored e2 plane costs 2 more.
# Stripped and hoisted variants do the same per pair: they change what the
# winner stores and where the coefficients are read.
OPS_BASE, OPS_LEX, OPS_E2_STORED = 27, 2, 2

launches = {"visibility_variant": 0, "visibility_packed": 0}

# the kernel's geometry (csrc/probes_visibility.cu: MIN_PPT, MAX_THREADS and
# the PPTs of its instances)
P3_MIN_PPT = 2
P3_MAX_THREADS = 1024
P3_PPTS = (2, 4, 8)


class P3Launch(NamedTuple):
    """The P3 kernel's CTA for one 128 x tile_h tile: ``threads`` threads,
    each holding ``ppt`` pixels of one column, rows g, g + G, ... of the
    tile (G = threads / 128 row groups)."""

    tile_h: int
    threads: int
    ppt: int

    def pixel(self, thread: int, slot: int) -> tuple[int, int]:
        """(x, y) within the tile of a thread's pixel ``slot``."""
        groups = self.threads // TILE_W
        return thread % TILE_W, thread // TILE_W + slot * groups


def p3_launch(tile_h: int) -> P3Launch:
    """The P3 kernel's geometry at 128 x tile_h tiles: the fewest pixels a
    thread, at least ``P3_MIN_PPT``, that fit the tile in
    ``P3_MAX_THREADS`` threads (tile_h 8: 512 threads; 16: 1024; 32 and 64:
    1024 threads of 4 and 8 pixels)."""
    ppt = max(P3_MIN_PPT, -(-TILE_W * tile_h // P3_MAX_THREADS))
    if tile_h <= 0 or tile_h % ppt or ppt not in P3_PPTS:
        raise ValueError(
            f"tile_h {tile_h}: the P3 kernel gives each thread {ppt} rows "
            f"of one column, so tile_h must be a positive multiple of it "
            f"and {ppt} one of the compiled {P3_PPTS}")
    return P3Launch(tile_h, TILE_W * tile_h // ppt, ppt)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def grid_of(fb_w: int, fb_h: int, tile_h: int) -> tuple[int, int]:
    return -(-fb_w // TILE_W), -(-fb_h // tile_h)


def refill_e2(table: torch.Tensor) -> torch.Tensor:
    """The table with channels 6..8 holding e2 as a stored plane: a2 =
    -(a0 + a1), b2 = -(b0 + b1), c2 = 2A - c0 - c1 (the TPU harness's
    refill)."""
    t = table.clone()
    t[:, 6] = -(table[:, 0] + table[:, 3])
    t[:, 7] = -(table[:, 1] + table[:, 4])
    t[:, 8] = table[:, 6] - table[:, 2] - table[:, 5]
    return t


def pack5(entry_channels: torch.Tensor) -> torch.Tensor:
    """[E, 24] -> [ceil(E / 5) + 26, 128]: five entries a row (lanes
    0..119), zero rows and lanes after them (the window clamp's slack)."""
    E = entry_channels.shape[0]
    ep = -(-E // PACK)
    t = torch.nn.functional.pad(entry_channels, (0, 0, 0, ep * PACK - E))
    t = t.reshape(ep, PACK * S.NUM_CHANNELS)
    t = torch.nn.functional.pad(t, (0, PACK_LANES - PACK * S.NUM_CHANNELS))
    return torch.nn.functional.pad(t, (0, 0, 0, ROWS_PER_WIN))


# (entry, pixel) pairs a batch of tiles of the plain version holds
_PAIRS_PER_BATCH = 1 << 23


def _fold_chunk(st, ch, rows, live, xf, yf, in_sc, *, lex, strip, e2_stored):
    """Entries ch [B, L, 24] with ids rows [B, L] (``live`` [B, L]),
    resolved in order against the pixels [B, P] of B tiles and folded into
    their state: the TPU kernel's resolve_entry, op for op, entry after
    entry.  The fold is a reduction: an entry passes where its key (z, then
    the order under ``lex``) is at least as good as the pixel's, so the
    last entry with the best key wins; where the order stays at -1
    (``strip_attrs``) or is not compared, the first entry that lowers the
    depth passes, and the last of its depth that the compare lets through
    wins.  Returns the new state."""
    zbuf, owner, obuf, uwb, vwb, iwb, texb = st
    xf3, yf3 = xf[:, None, :], yf[:, None, :]

    def c(row):
        return ch[:, :, row:row + 1]

    def plane(row):
        return (c(row) * xf3 + c(row + 1) * yf3) + c(row + 2)

    meta = c(S.CH_META).to(torch.int32)
    tl = meta >> S.META_TEX_BITS
    e0 = plane(S.CH_E0)
    e1 = plane(S.CH_E1)
    e2 = plane(S.CH_TWOA) if e2_stored else (c(S.CH_TWOA) - e0) - e1
    cov = (((e0 > 0) | ((e0 == 0) & ((tl & 1) > 0)))
           & ((e1 > 0) | ((e1 == 0) & ((tl & 2) > 0)))
           & ((e2 > 0) | ((e2 == 0) & ((tl & 4) > 0))))
    z = plane(S.CH_Z)
    zc = torch.clamp(z, 0.0, 1.0)
    zq = torch.round(zc * 65535.0) * S.INV_D16
    frag = cov & (z == zc) & in_sc[:, None, :] & live[:, :, None]
    order = c(S.CH_ORDER)
    L = ch.shape[1]
    pos = torch.arange(L, device=ch.device)[None, :, None]
    inf = torch.tensor(float("inf"), device=ch.device)
    zmin = torch.minimum(zbuf, torch.where(frag, zq, inf).amin(dim=1))
    at_z = frag & (zq == zmin[:, None, :])
    if lex and not strip:
        omax = torch.where(at_z, order, -inf).amax(dim=1)
        omax = torch.where(zbuf == zmin, torch.maximum(omax, obuf), omax)
        win = torch.where(at_z & (order == omax[:, None, :]), pos,
                          -1).amax(dim=1)
    else:
        passes_tie = at_z & (order >= obuf[:, None, :]) if lex else at_z
        last = torch.where(passes_tie, pos, -1).amax(dim=1)
        first = torch.where(at_z, pos, L).amin(dim=1)
        win = torch.where(last >= 0, last, torch.where(
            (zmin < zbuf) & (first < L), first, -1))
    has = win >= 0
    w = torch.clamp(win, min=0)
    zbuf = torch.where(has, torch.gather(zq, 1, w[:, None, :])[:, 0], zbuf)
    owner = torch.where(has, torch.gather(rows, 1, w).to(torch.int32), owner)
    if not strip:
        cw = torch.gather(ch, 1, w[:, :, None].expand(-1, -1, ch.shape[2]))

        def plane_w(row):
            return ((cw[..., row] * xf + cw[..., row + 1] * yf)
                    + cw[..., row + 2])

        obuf = torch.where(has, cw[..., S.CH_ORDER], obuf)
        uwb = torch.where(has, plane_w(S.CH_UW), uwb)
        vwb = torch.where(has, plane_w(S.CH_VW), vwb)
        iwb = torch.where(has, plane_w(S.CH_INVW), iwb)
        texb = torch.where(
            has, cw[..., S.CH_META].to(torch.int32) & S.META_TEX_MASK, texb)
    return zbuf, owner, obuf, uwb, vwb, iwb, texb


def _stream(ent, tile_start, depth0, scissor, *, tile_h, grid_w, grid_h,
            align, span, lex, exit, lag2, strip, hoist, e2_stored):
    """The TPU kernels' chunk loop over ``ent`` [cap, 24] for every tile at
    once: chunk k of a tile starts at min(base + k * span, cap - span),
    base = start - start % align.  Returns (7 maps [grid_h * tile_h,
    grid_w * 128], nres i32 [ntiles])."""
    dev = ent.device
    cap = ent.shape[0]
    ntiles, P = grid_w * grid_h, TILE_W * tile_h
    fb_h, fb_w = depth0.shape
    pad_h, pad_w = grid_h * tile_h, grid_w * TILE_W
    scx, scy, scw, sch = S.scissor_ints(scissor)
    ts = tile_start.long()
    start_all, end_all = ts[:-1], ts[1:]
    base_all = start_all - start_all % align
    nch_all = torch.where(end_all > start_all,
                          -(-(end_all - base_all) // span), 0)
    # tiles by descending chunk count: those still streaming form a prefix
    nch, perm = torch.sort(nch_all, descending=True, stable=True)
    start, end, base = start_all[perm], end_all[perm], base_all[perm]
    lx = torch.arange(P, device=dev) % TILE_W
    ly = torch.arange(P, device=dev) // TILE_W
    x = (perm % grid_w * TILE_W)[:, None] + lx
    y = (perm // grid_w * tile_h)[:, None] + ly
    xf = x.to(torch.float32) + 0.5
    yf = y.to(torch.float32) + 0.5
    in_sc = (x >= scx) & (x < scx + scw) & (y >= scy) & (y < scy + sch)
    depth = torch.full((pad_h, pad_w), -float("inf"), device=dev)
    depth[:fb_h, :fb_w] = depth0.to(torch.float32)
    z0 = depth[y, x]
    st = (z0, torch.full_like(z0, -1, dtype=torch.int32),
          torch.full_like(z0, -1.0), torch.zeros_like(z0),
          torch.zeros_like(z0), torch.ones_like(z0),
          torch.zeros_like(z0, dtype=torch.int32))
    thresh = z0.amax(dim=1)      # the exit's threshold; lag2: the next one
    thresh1 = thresh.clone()
    alive = torch.ones((ntiles,), dtype=torch.bool, device=dev)
    nres = torch.zeros((ntiles,), dtype=torch.int64, device=dev)
    n_at = (nch[None, :] > torch.arange(int(nch.max()) if ntiles else 0,
                                        device=dev)[:, None]).sum(1).tolist()
    for k, n in enumerate(n_at):
        s = torch.clamp(base[:n] + k * span, max=cap - span)
        idx0 = torch.clamp(start[:n] - s, min=0)
        proceed = alive[:n].clone()
        if exit:
            zmin0 = ent[s + idx0, S.CH_ZMIN] * S.INV_D16
            proceed &= zmin0 <= thresh[:n]
        nh = torch.where(proceed, torch.clamp(end[:n] - s, 0, span), 0)
        nres[:n] += torch.clamp(nh - idx0, min=0)
        lo = int(torch.where(nh > 0, idx0, span).min())
        hi = int(nh.max())
        batch = max(1, _PAIRS_PER_BATCH // max(1, (hi - lo) * P))
        for b0 in range(0, n if hi > lo else 0, batch):
            b1 = min(b0 + batch, n)
            rows = s[b0:b1, None] + torch.arange(lo, hi, device=dev)
            live = ((rows >= start[b0:b1, None]) & (rows < end[b0:b1, None])
                    & proceed[b0:b1, None])
            ch = (ent[s[b0:b1]][:, None, :].expand(-1, hi - lo, -1) if hoist
                  else ent[rows])
            view = _fold_chunk(tuple(f[b0:b1] for f in st), ch, rows, live,
                               xf[b0:b1], yf[b0:b1], in_sc[b0:b1], lex=lex,
                               strip=strip, e2_stored=e2_stored)
            for f, v in zip(st, view):
                f[b0:b1] = v
        if exit:
            zmax = st[0][:n].amax(dim=1)
            if lag2:
                new1 = torch.where(proceed, zmax, thresh1[:n])
                thresh[:n] = thresh1[:n]
                thresh1[:n] = new1
            else:
                thresh[:n] = torch.where(proceed, zmax, thresh[:n])
            alive[:n] = proceed

    inv = torch.argsort(perm)

    def image(t):
        t = t[inv].reshape(grid_h, grid_w, tile_h, TILE_W)
        return t.permute(0, 2, 1, 3).reshape(pad_h, pad_w)

    zbuf, owner, *rest = st
    return [image(f) for f in (owner, zbuf, *rest)], nres[inv].to(torch.int32)


def variant_reference(table, tile_start, depth0, scissor, *, tile_w=TILE_W,
                      tile_h, grid_w, grid_h, chunk, lex=False, exit=False,
                      lag2=False, strip_attrs=False, hoist_loads=False,
                      e2_stored=False):
    """``_variant_kernel``'s 7 maps (owner, z, order, uw, vw, iw, tex) for
    table f32 [E, 24], tile_start i32 [grid_w * grid_h + 1], depth0 f32
    [fb_h, fb_w] and a 4-int scissor, and the live entries each tile
    resolved.  ``exit`` implies ``lex``, as in the TPU kernel."""
    if tile_w != TILE_W:
        raise ValueError(f"tile_w {tile_w}: the probe's tiles are 128 wide")
    return _stream(table, tile_start, depth0, scissor, tile_h=tile_h,
                   grid_w=grid_w, grid_h=grid_h, align=chunk, span=chunk,
                   lex=lex or exit, exit=exit, lag2=lag2 and exit,
                   strip=strip_attrs, hoist=hoist_loads, e2_stored=e2_stored)


def packed_reference(packed, tile_start, depth0, scissor, *, tile_w=TILE_W,
                     tile_h, grid_w, grid_h, exit=True, lag2=False):
    """``_packed_kernel``'s maps on pack5's table [rows, 128], with e2
    derived (ROADMAP R8), and the live entries each tile resolved."""
    if tile_w != TILE_W:
        raise ValueError(f"tile_w {tile_w}: the probe's tiles are 128 wide")
    ent = packed[:, :PACK * S.NUM_CHANNELS].reshape(-1, S.NUM_CHANNELS)
    return _stream(ent, tile_start, depth0, scissor, tile_h=tile_h,
                   grid_w=grid_w, grid_h=grid_h, align=PACK,
                   span=ENT_PER_WIN, lex=True, exit=exit, lag2=lag2 and exit,
                   strip=False, hoist=False, e2_stored=False)


def _launch(name, table, cap, span, tile_start, depth0, scissor, *, tile_h,
            unroll, lex, exit_mode, strip, hoist, e2_stored, packed):
    dev = table.device
    fb_h, fb_w = depth0.shape
    grid_w, grid_h = grid_of(fb_w, fb_h, tile_h)
    ntiles = grid_w * grid_h
    width = PACK_LANES if packed else S.NUM_CHANNELS
    for what, t, dt, shape in (
            ("table", table, torch.float32, (table.shape[0], width)),
            ("tile_start", tile_start, torch.int32, (ntiles + 1,)),
            ("depth0", depth0, torch.float32, (fb_h, fb_w))):
        if (t.dtype != dt or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous {dt} "
                             f"{shape} on {dev}")
    if table.data_ptr() % 16 or cap < span:
        raise ValueError(f"{name}: the table must be 16-byte aligned and "
                         f"hold at least {span} entries")
    geometry = p3_launch(tile_h)
    pad = (grid_h * tile_h, grid_w * TILE_W)
    maps = [torch.empty(pad, dtype=dt, device=dev) for dt in (
        torch.int32, *(torch.float32,) * 5, torch.int32)]
    nres = torch.empty((ntiles,), dtype=torch.int32, device=dev)
    tile_order = torch.empty((ntiles,), dtype=torch.int32, device=dev)
    lib = _build.load()
    launches[name] += 1
    err = lib.ty_probe_visibility(
        tile_start.data_ptr(), table.data_ptr(), cap, span, depth0.data_ptr(),
        fb_w, fb_h, grid_w, grid_h, *S.scissor_ints(scissor), tile_h,
        geometry.threads, geometry.ppt, unroll, int(lex), exit_mode,
        int(strip), int(hoist), int(e2_stored), int(packed),
        *(m.data_ptr() for m in maps), nres.data_ptr(), tile_order.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    return maps, nres


def run_variant(table, tile_start, depth0, scissor, *, tile_h=16, chunk=128,
                unroll=4, lex=False, exit=False, lag2=False,
                strip_attrs=False, hoist_loads=False, e2_stored=False):
    """(7 maps, nres) of ``variant_reference`` at tiles of 128 x tile_h
    over depth0's frame: the kernel for CUDA tensors (the tile heights
    ``p3_launch`` takes, with the settings csrc/probes_visibility.cu
    compiles), the plain version for CPU ones."""
    fb_h, fb_w = depth0.shape
    grid_w, grid_h = grid_of(fb_w, fb_h, tile_h)
    if table.device.type == "cpu":
        return variant_reference(
            table, tile_start, depth0, scissor, tile_h=tile_h, grid_w=grid_w,
            grid_h=grid_h, chunk=chunk, lex=lex, exit=exit, lag2=lag2,
            strip_attrs=strip_attrs, hoist_loads=hoist_loads,
            e2_stored=e2_stored)
    if table.device.type != "cuda":
        raise ValueError(f"visibility_variant: unsupported device "
                         f"{table.device}")
    return _launch("visibility_variant", table, table.shape[0], chunk,
                   tile_start, depth0, scissor, tile_h=tile_h, unroll=unroll,
                   lex=lex or exit, exit_mode=(2 if lag2 else 1) if exit
                   else 0, strip=strip_attrs, hoist=hoist_loads,
                   e2_stored=e2_stored, packed=False)


def run_packed(packed, tile_start, depth0, scissor, *, tile_h=16, exit=True,
               lag2=False):
    """(7 maps, nres) of ``packed_reference``: the kernel for CUDA tensors
    (tile_h 16), the plain version for CPU ones."""
    fb_h, fb_w = depth0.shape
    grid_w, grid_h = grid_of(fb_w, fb_h, tile_h)
    if packed.device.type == "cpu":
        return packed_reference(packed, tile_start, depth0, scissor,
                                tile_h=tile_h, grid_w=grid_w, grid_h=grid_h,
                                exit=exit, lag2=lag2)
    if packed.device.type != "cuda":
        raise ValueError(f"visibility_packed: unsupported device "
                         f"{packed.device}")
    return _launch("visibility_packed", packed, PACK * packed.shape[0],
                   ENT_PER_WIN, tile_start, depth0, scissor, tile_h=tile_h,
                   unroll=PACK, lex=True,
                   exit_mode=(2 if lag2 else 1) if exit else 0, strip=False,
                   hoist=False, e2_stored=False, packed=True)


def ops_per_pair(lex: bool, e2_stored: bool) -> int:
    return OPS_BASE + (OPS_LEX if lex else 0) + (
        OPS_E2_STORED if e2_stored else 0)


def variant_bound(nres, depth0, tile_h, ops: int,
                  entry_bytes: float = ENTRY_BYTES) -> dict:
    """The rows of the live entries resolved, the tile starts and the depth
    read once, the 7 maps written once; ``ops`` per (entry, pixel) pair
    over every pixel of the tile.  Also the entries resolved, in all and
    the most and the mean a tile."""
    fb_h, fb_w = depth0.shape
    grid_w, grid_h = grid_of(fb_w, fb_h, tile_h)
    resolved = int(nres.sum())
    nbytes = (entry_bytes * resolved + 4 * (nres.numel() + 1)
              + 4 * depth0.numel() + 4 * MAPS * grid_h * tile_h * grid_w
              * TILE_W)
    return dict(_common.bound(nbytes, ops * resolved * TILE_W * tile_h),
                resolved=resolved, nres_max=int(nres.max()),
                nres_mean=resolved / nres.numel())


# ---------------------------------------------------------------- harness

def sponza_frame(device, resolution=(1920, 1080), grid_n=420):
    """One sponza frame (t = 0.5) up to the near clip, as the TPU tool
    builds it: (clipped triangles, viewport, scissor, mesh depth state,
    raster plan)."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops.clip import near_clip_triangles
    from tyleri_tpu_torch.ops.setup import transform_corner_table

    builder = tt.RenderDeviceBuilder()
    if device.type == "cpu":
        builder = builder.device("cpu")
    dev = builder.build()
    rig = tt.scenes.config5_sponza(dev, resolution, grid_n=grid_n)
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(resolution))
    scene = tt.RenderScene()
    rig.fill(scene, 0.5)
    inputs = rf.build_frame_inputs(dev, scene.render_resources, 1.0,
                                   resolution)
    (_, _, _, _, _, cam_valid, viewports, scissors, mvps, corners, tri_draw,
     tri_valid0, tri_tex) = inputs[:13]
    r = rf.plan.raster
    clip, uv3 = transform_corner_table(corners[0], tri_draw[0], mvps[0])
    ct = near_clip_triangles(clip, uv3, tri_tex[0],
                             tri_valid0[0] & bool(cam_valid[0]),
                             extra_cap=r.clip_cap)
    return ct, viewports[0], scissors[0], rf.mesh_state.depth, r, \
        rf.plan.tri_cap


def bin_frame(frame, tile_h, tile_w=TILE_W):
    """The frame binned at tile_w x tile_h, with spill and broad capacities
    grown until no entry is dropped.  Returns (binned, grid_w, grid_h)."""
    from tyleri_tpu_torch.ops.binning import bin_triangles, spill_rows
    from tyleri_tpu_torch.ops.setup import setup_triangles

    ct, viewport, scissor, _, r, tri_cap = frame
    fb_w, fb_h = r.fb_w, r.fb_h
    grid_w, grid_h = -(-fb_w // tile_w), -(-fb_h // tile_h)
    su = setup_triangles(ct.clip, ct.uv, ct.tex_id, ct.valid, viewport,
                         scissor, tile_w=tile_w, tile_h=tile_h, grid_w=grid_w,
                         grid_h=grid_h, order=ct.order)
    spill_cap, broad_cap = r.spill_cap, r.broad_cap
    for _ in range(8):
        entry_cap = max(r.entry_cap, tri_cap + r.clip_cap + spill_rows(
            spill_cap, r.max_tiles_per_tri))
        b = bin_triangles(su, grid_w=grid_w, grid_h=grid_h,
                          entry_cap=entry_cap,
                          max_tiles_per_tri=r.max_tiles_per_tri,
                          broad_cap=broad_cap, spill_cap=spill_cap)
        if not int(b.overflow):
            return b, grid_w, grid_h
        spill_cap, broad_cap = 2 * spill_cap, 4 * broad_cap
    raise AssertionError(f"binning overflow {int(b.overflow)} at tile_h "
                         f"{tile_h}")


def seg_starts(ntiles, seg, E, device):
    """Exactly ``seg`` entries a tile, capped at the table's end."""
    return torch.clamp(torch.arange(ntiles + 1, device=device) * seg,
                       max=E).to(torch.int32)


# name: options of the TPU tool's ``runs`` table (tools/exp_visibility.py:
# 496-540), with the TPU-only knobs mapped as the docstring says
_RUNS = {
    "base": {}, "lex": dict(lex=True), "zmax": {}, "zmaxdma": {},
    "exit": dict(exit=True), "exitspec": dict(exit=True),
    "exit2": dict(exit=True, lag2=True), "exitw2": dict(exit=True, lag2=True),
    "exitw": dict(exit=True), "e2stored": dict(exit=True, e2_stored=True),
    "e2derived": dict(exit=True), "th8": dict(tile_h=8),
    "th32": dict(tile_h=32), "chunk256": dict(chunk=256),
    "unroll8": dict(unroll=8), "unroll2": dict(unroll=2),
    "strip_attrs": dict(strip_attrs=True), "hoist": dict(hoist_loads=True),
    "hoist_strip": dict(hoist_loads=True, strip_attrs=True),
    "dynroll": {}, "dynroll8": dict(unroll=8),
    "th32c256": dict(tile_h=32, chunk=256),
    "th32c512": dict(tile_h=32, chunk=512),
    "th32c256u2": dict(tile_h=32, chunk=256, unroll=2),
    "th32c256u8": dict(tile_h=32, chunk=256, unroll=8),
    "th32c128u8": dict(tile_h=32, chunk=128, unroll=8),
    "th16c128u8": dict(tile_h=16, chunk=128, unroll=8),
    "th16c256u4": dict(tile_h=16, chunk=256, unroll=4),
    "th8c128u4": dict(tile_h=8, chunk=128, unroll=4),
    "th8c128u8": dict(tile_h=8, chunk=128, unroll=8),
    "th16c128u2": dict(tile_h=16, chunk=128, unroll=2),
    "th64c256": dict(tile_h=64, chunk=256), "c512": dict(chunk=512),
    "th32hoist": dict(tile_h=32, chunk=256, hoist_loads=True),
    "empty": dict(ts="empty"), "empty_th32": dict(ts="empty", tile_h=32),
    "empty_th64": dict(ts="empty", tile_h=64),
    "seg32": dict(ts=32), "seg64": dict(ts=64), "seg128": dict(ts=128),
    "seg256": dict(ts=256),
}
VARIANTS = {
    **{name: dict(kind="variant", **kw) for name, kw in _RUNS.items()},
    "prod": dict(kind="prod", chunk=64),
    "prodc32": dict(kind="prod", chunk=32),
    "packed5": dict(kind="packed", exit=True),
    "packed5_noexit": dict(kind="packed", exit=False),
    "packed5_lag2": dict(kind="packed", exit=True, lag2=True),
}
# the settings that change the maps, for the checks against the plain
# versions (the others give the same maps as one of these)
RESULT_DISTINCT = ("base", "lex", "exit", "exit2", "e2stored", "strip_attrs",
                   "hoist", "hoist_strip", "chunk256", "th8", "th32",
                   "th64c256", "c512", "seg256", "packed5", "packed5_noexit",
                   "packed5_lag2")


class Tables:
    """The frame's binned tables per tile height, built on first use."""

    def __init__(self, device, resolution=(1920, 1080), grid_n=420):
        self.device = device
        self.frame = sponza_frame(device, resolution, grid_n)
        r = self.frame[4]
        self.depth0 = torch.ones((r.fb_h, r.fb_w), device=device)
        self.scissor = self.frame[2]
        self._binned = {}

    def binned(self, tile_h, tile_w=TILE_W):
        key = (tile_h, tile_w)
        if key not in self._binned:
            self._binned[key] = bin_frame(self.frame, tile_h, tile_w)
        return self._binned[key]

    def inputs(self, name):
        """(table or packed table, tile_start, kernel options, ops, bytes
        per entry) of a variant or packed row."""
        kw = dict(VARIANTS[name])
        kind = kw.pop("kind")
        if kind == "packed":
            b, _, _ = self.binned(16)
            return (pack5(b.entry_channels), b.tile_start, kw,
                    ops_per_pair(True, False), 4 * PACK_LANES / PACK)
        ts_kind = kw.pop("ts", "binned")
        b, grid_w, grid_h = self.binned(kw.get("tile_h", 16))
        table = b.entry_channels
        if kw.get("e2_stored"):
            table = refill_e2(table)
        ts = b.tile_start
        if ts_kind == "empty":
            ts = torch.zeros_like(ts)
        elif ts_kind != "binned":
            ts = seg_starts(grid_w * grid_h, ts_kind, table.shape[0],
                            table.device)
        ops = ops_per_pair(kw.get("lex", False) or kw.get("exit", False),
                           kw.get("e2_stored", False))
        return table, ts, kw, ops, ENTRY_BYTES

    def run(self, name, table, ts, kw):
        if VARIANTS[name]["kind"] == "packed":
            return run_packed(table, ts, self.depth0, self.scissor, **kw)
        return run_variant(table, ts, self.depth0, self.scissor, **kw)

    def reference(self, name, table, ts, kw):
        """The plain version of a variant or packed row, on any device."""
        fb_h, fb_w = self.depth0.shape
        tile_h = kw.get("tile_h", 16)
        grid_w, grid_h = grid_of(fb_w, fb_h, tile_h)
        dims = dict(tile_h=tile_h, grid_w=grid_w, grid_h=grid_h)
        kw = {k: v for k, v in kw.items() if k not in ("tile_h", "unroll")}
        if VARIANTS[name]["kind"] == "packed":
            return packed_reference(table, ts, self.depth0, self.scissor,
                                    **dims, **kw)
        return variant_reference(table, ts, self.depth0, self.scissor,
                                 **dims, chunk=kw.pop("chunk", 128), **kw)


def run_prod(tables, name, device, reps, card):
    """The port's K3 at its own 16x16 tiles on the same frame: its visit
    count (counts variant), then the base variant's time."""
    from tyleri_tpu_torch.ops import raster_cuda

    chunk = VARIANTS[name]["chunk"]
    b, grid_w, grid_h = tables.binned(16, 16)
    fb_h, fb_w = tables.depth0.shape
    kw = dict(fb_w=fb_w, fb_h=fb_h, tile_w=16, tile_h=16, grid_w=grid_w,
              grid_h=grid_h, depth_state=tables.frame[3], chunk=chunk)
    _, nvis = raster_cuda.rasterize_visibility(
        b, tables.depth0, tables.scissor, counts=True, **kw)
    visited = int(nvis.sum())
    t = _common.timing(lambda: raster_cuda.rasterize_visibility(
        b, tables.depth0, tables.scissor, **kw), device, reps)
    nbytes = ENTRY_BYTES * visited + 4 * (
        b.tile_start.numel() + tables.depth0.numel() * (1 + MAPS))
    return _common.emit(
        "exp_visibility", name, device, card, **t, tile_h=16, chunk=chunk,
        entries=int(b.num_entries), visited=visited,
        **_common.bound(nbytes, ops_per_pair(True, False) * 256 * visited))


def run_variants(device: torch.device, reps: int, card=None, *,
                 resolution=(1920, 1080), grid_n=420, names=None,
                 tables=None) -> list[dict]:
    """One record a variant; ``tables`` (a ``Tables``) reuses frames
    already binned."""
    tables = tables or Tables(device, resolution, grid_n)
    out = []
    for name in names or VARIANTS:
        if VARIANTS[name]["kind"] == "prod":
            out.append(run_prod(tables, name, device, reps, card))
            continue
        table, ts, kw, ops, entry_bytes = tables.inputs(name)
        _, nres = tables.run(name, table, ts, kw)
        t = _common.timing(lambda: tables.run(name, table, ts, kw), device,
                           reps)
        tile_h = kw.get("tile_h", 16)
        out.append(_common.emit(
            "exp_visibility", name, device, card, **t, tile_h=tile_h,
            chunk=kw.get("chunk", ENT_PER_WIN if "packed" in name else 128),
            entries=int(tables.binned(tile_h)[0].num_entries),
            **variant_bound(nres, tables.depth0, tile_h, ops, entry_bytes)))
    return out


def _options(ap) -> None:
    ap.add_argument("--grid-n", type=int, default=420,
                    help="sponza's heightfield grid (420: 1.05 M triangles)")
    ap.add_argument("--resolution", default="1920x1080",
                    help="frame WxH (default 1920x1080)")
    ap.add_argument("variants", nargs="*",
                    help="variants to run (default: all)")


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__, _options)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{' '.join(VARIANTS)}")
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    w, h = (int(v) for v in args.resolution.split("x"))
    run_variants(device, args.reps, card, resolution=(w, h),
                 grid_n=args.grid_n, names=args.variants or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
