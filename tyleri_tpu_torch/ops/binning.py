"""Tile binning (counterpart of ``tyleri_tpu/ops/binning.py``).

Every valid triangle whose tile bbox covers at most ``max_tiles_per_tri``
tiles becomes one (tile, triangle) entry per covered tile; larger ("broad")
triangles go to a side list that every covered tile scans.  Entries are
sorted by (tile, conservative z-min in D16 quanta), so each tile's segment
streams front to back and the visibility resolve can stop early; per-tile
segment starts come from searchsorted.

Static capacities mirror the JAX package, so the frame plan's capacity
fits (rendering/forward.py) and the overflow and demand counters mean the
same thing:

  * a first sort of one packed int64 key per triangle orders live narrow
    triangles by descending spill count; its first ``valid_cap`` rows are
    the dense (first covered tile) slots;
  * spill level j (covers 2^(j-1) .. 2^j - 1) is a prefix of that order,
    sliced at the level's cap;
  * the entry emit writes one (tile << 16 | zmin) key and one triangle id
    for every dense slot and spill cover, in one pre-sort list: on CUDA
    tensors one launch of ``csrc/binning_emit.cu``, on CPU tensors its
    plain version, the eager emit (``emit_entries``);
  * the second sort is over that packed key.

Both sorts are unstable, so the entry order among equal keys (and with it
the owner ids of the visibility buffer) may differ between runs and
backends; the per-tile entry multisets do not.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.setup import TriangleSetup
from tyleri_tpu_torch.utils.profiling import span

# per-level capacity fractions of spill_cap (the JAX package's tuning)
_LEVEL_FRACS = (0.6, 0.2, 0.08, 0.03, 0.012)
# the first sort's packed int64 key: (31 - scount) << 37 | (tw - 1) << 32 |
# tri, a 32-bit triangle id; dead rows carry all ones, above every live key
TRI_BITS = 32
TRI_MASK = (1 << TRI_BITS) - 1
DEAD_KEY = (1 << (TRI_BITS + 10)) - 1


class BinnedEntries(NamedTuple):
    entry_channels: torch.Tensor  # f32 [E_cap, 24] sorted by (tile, zmin)
    entry_tile: torch.Tensor      # i32 [E_cap] tile id (ntiles = dead)
    tile_start: torch.Tensor      # i32 [ntiles + 1] segment offsets
    num_entries: torch.Tensor     # i32 [] live entries placed
    overflow: torch.Tensor        # i32 [] entries dropped (capacity)
    broad_channels: torch.Tensor  # f32 [B_cap, 24] huge-triangle list
    broad_tiles: torch.Tensor     # i32 [B_cap, 4] (tx0, ty0, tx1, ty1)
    num_broad: torch.Tensor       # i32 [] live broad rows
    dense_demand: torch.Tensor    # i32 [] live narrow triangles (pre-cap)
    level_demand: torch.Tensor    # i32 [L] per-spill-level demand (pre-cap)
    # per-triangle extra rows (the lit path's normal/w planes), gathered
    # with the entry and broad rows; None without extra rows
    entry_extra: torch.Tensor = None  # f32 [E_cap, K]
    broad_extra: torch.Tensor = None  # f32 [B_cap, K]


def _level_caps(spill_cap: int, K: int, override=()) -> list[int]:
    derived = []
    lo, j = 1, 0
    while lo < K:
        frac = _LEVEL_FRACS[min(j, len(_LEVEL_FRACS) - 1)]
        derived.append(max(int(spill_cap * frac) // 512 * 512, 512))
        lo *= 2
        j += 1
    if override:
        assert len(override) == len(derived), \
            f"spill_level_caps needs {len(derived)} levels"
        return [max(int(c) // 512 * 512, 512) for c in override]
    return derived


def spill_rows(spill_cap: int, K: int = 32, level_caps=()) -> int:
    """Total spill rows the multi-level expansion emits."""
    total, lo = 0, 1
    for cap in _level_caps(spill_cap, K, override=level_caps):
        hi = min(2 * lo, K) - 1
        total += (hi - lo + 1) * cap
        lo *= 2
    return total


def pack_key(scount, tw, tri):
    """The first sort's key of live narrow rows (int64 tensors): the most
    spill first, then the widest tile span, then the triangle id."""
    return (((31 - scount) << (TRI_BITS + 5)) | ((tw - 1) << TRI_BITS)
            | tri)


def unpack_key(key):
    """(live, scount, tw, tri) of packed keys; a dead row unpacks to the
    all-ones triangle id."""
    return (key != DEAD_KEY, 31 - ((key >> (TRI_BITS + 5)) & 0x1F),
            ((key >> TRI_BITS) & 0x1F) + 1, key & TRI_MASK)


def emit_segments(vcap: int, caps, entry_cap: int, K: int
                  ) -> tuple[tuple[int, int, int], ...]:
    """The pre-sort entry list's layout, ((first row, rows, cover), ...) in
    the plain emit's order: the dense slots (cover 0, the first ``vcap``
    rows of the first sort's order), then each spill level's covers c in
    [lo, hi], ``cap`` rows each, then the pad up to ``entry_cap`` (cover
    -1).  Empty segments are left out."""
    segs, row, lo = [(0, vcap, 0)], vcap, 1
    for cap in caps:
        for c in range(lo, min(2 * lo, K)):
            segs.append((row, cap, c))
            row += cap
        lo *= 2
        if lo >= K:
            break
    segs.append((row, entry_cap - row, -1))
    return tuple(s for s in segs if s[1] > 0)


@functools.lru_cache(maxsize=64)
def _segment_args(vcap: int, caps: tuple, entry_cap: int, K: int):
    """The kernel's segment table as ctypes arrays: each segment's first
    row and the list's length, each segment's cover."""
    segs = emit_segments(vcap, caps, entry_cap, K)
    starts = [s[0] for s in segs] + [sum(s[1] for s in segs)]
    return ((ctypes.c_longlong * len(starts))(*starts),
            (ctypes.c_int * len(segs))(*(s[2] for s in segs)), len(segs),
            starts[-1])


def emit_entries(key, opA, *, T: int, grid_w: int, ntiles: int, K: int,
                 vcap: int, caps, entry_cap: int):
    """The pre-sort entry list from the first sort's ``key`` and the
    permuted ``opA`` (int64, equal lengths): (key2, tri, placed_dense,
    placed_spill), key2 the (tile << 16 | zmin) key and tri the triangle id
    (clamped to T - 1) of every row of ``emit_segments``'s layout, int64,
    and the live dense and spill rows placed (int64 scalars).  On CUDA
    tensors one launch of ``csrc/binning_emit.cu`` (``kernel_launch``); on
    CPU tensors its plain version, the eager emit."""
    if key.device.type == "cuda":
        with span("bin.spill"):
            n = _segment_args(vcap, tuple(caps), entry_cap, K)[3]
            key2 = torch.empty(n, dtype=torch.int64, device=key.device)
            tri = torch.empty_like(key2)
            placed = torch.empty(2, dtype=torch.int64, device=key.device)
            kernel_launch(key, opA, key2, tri, placed, T=T, grid_w=grid_w,
                          ntiles=ntiles, K=K, vcap=vcap, caps=caps,
                          entry_cap=entry_cap)()
            return key2, tri, placed[0], placed[1]
    if key.device.type != "cpu":
        raise ValueError(f"emit_entries: unsupported device {key.device}")
    return _emit_plain(key, opA, T, grid_w, ntiles, K, vcap, caps,
                       entry_cap)


def kernel_launch(key, opA, key2, tri, placed, *, T: int, grid_w: int,
                  ntiles: int, K: int, vcap: int, caps, entry_cap: int):
    """The emit as one launch of ``csrc/binning_emit.cu``, writing
    ``key2`` and ``tri`` (int64, the layout's length) and the two counts
    into ``placed`` (int64 [2], zeroed by the launch).  Checks the inputs
    and returns the launch, on the current stream (chip_smoke.py times it
    alone)."""
    starts, covers, nseg, n = _segment_args(vcap, tuple(caps), entry_cap, K)
    dev = key.device
    rows = key.shape[0]
    _build.check_args("bin_emit", dev, (
        ("key", key, torch.int64, (rows,)), ("opA", opA, torch.int64, (rows,)),
        ("key2", key2, torch.int64, (n,)), ("tri", tri, torch.int64, (n,)),
        ("placed", placed, torch.int64, (2,))))
    if max([vcap, *caps]) > rows:
        raise ValueError(f"bin_emit: {rows} key rows, segments of up to "
                         f"{max([vcap, *caps])}")
    emit = _build.launcher("bin_emit", "ty_binning_emit", dev, (
        key.data_ptr(), opA.data_ptr(), rows, starts, covers, nseg, grid_w,
        ntiles, T - 1, key2.data_ptr(), tri.data_ptr(), placed.data_ptr()),
        dict(key=key, opA=opA, key2=key2, tri=tri, placed=placed))

    def launch():
        placed.zero_()
        emit()

    launch.tensors = emit.tensors
    return launch


def _emit_plain(key, opA, T, grid_w, ntiles, K, vcap, caps, entry_cap):
    """The kernel's plain version: eager unpacks, one body a spill cover,
    and the concatenation of the pieces in ``emit_segments``'s order."""
    dev = key.device

    def unpack(cap):
        a = opA[:cap]
        live, scnt, twl, tril = unpack_key(key[:cap])
        return live, scnt, twl, tril, a >> 16, (a >> 8) & 0xFF, a & 0xFF

    with span("bin.dense"):
        # dense slots: every live narrow triangle, compacted
        live, _, _, tril, zq, ty, tx = unpack(vcap)
        dead_tile = torch.full_like(tx, ntiles)
        seg_tile = [torch.where(live, ty * grid_w + tx, dead_tile)]
        seg_zmin, seg_tri = [zq], [tril]
        placed_dense = live.sum()
    with span("bin.spill"):
        placed_spill = torch.zeros((), dtype=torch.int64, device=dev)
        lo = 1
        for cap in caps:
            hi = min(2 * lo, K) - 1           # cover indices [lo, hi]
            live, scnt, twl, tril, zq, ty, tx = unpack(cap)
            dead_tile = torch.full_like(tx, ntiles)
            for c in range(lo, hi + 1):
                lv = live & (scnt >= c)
                cy = ty + torch.div(c, twl, rounding_mode="floor")
                cx = tx + c - torch.div(c, twl, rounding_mode="floor") * twl
                seg_tile.append(torch.where(lv, cy * grid_w + cx, dead_tile))
                seg_zmin.append(zq)
                seg_tri.append(tril)
                placed_spill = placed_spill + lv.sum()
            lo *= 2
            if lo >= K:
                break

        all_tile = torch.cat(seg_tile)
        all_zmin = torch.cat(seg_zmin)
        all_tri = torch.cat(seg_tri)
        pad = max(entry_cap - all_tile.shape[0], 0)
        if pad:
            all_tile = torch.cat([all_tile, all_tile.new_full((pad,), ntiles)])
            all_zmin = torch.cat([all_zmin, all_zmin.new_zeros((pad,))])
            all_tri = torch.cat([all_tri, all_tri.new_zeros((pad,))])
        key2 = (all_tile << 16) | torch.clamp(all_zmin, 0, 65535)
        # dead rows carry the all-ones triangle id; clamped, it gathers the
        # last row, as XLA's gather does
        all_tri = torch.clamp(all_tri, max=T - 1)
    return key2, all_tri, placed_dense, placed_spill


def bin_triangles(setup: TriangleSetup, extra=None, *, grid_w: int,
                  grid_h: int, entry_cap: int, max_tiles_per_tri: int = 32,
                  broad_cap: int = 256, spill_cap: int = 1 << 16,
                  valid_cap: int = 0, spill_level_caps=()) -> BinnedEntries:
    with span("bin"):
        return _bin_triangles(setup, extra, grid_w, grid_h, entry_cap,
                              max_tiles_per_tri, broad_cap, spill_cap,
                              valid_cap, spill_level_caps)


def _bin_triangles(setup, extra, grid_w, grid_h, entry_cap,
                   max_tiles_per_tri, broad_cap, spill_cap, valid_cap,
                   spill_level_caps) -> BinnedEntries:
    dev = setup.valid.device
    T = setup.valid.shape[0]
    ntiles = grid_w * grid_h
    K = max_tiles_per_tri
    assert grid_w <= 256 and grid_h <= 256, "packed key needs 8-bit tiles"
    assert K <= 32, "packed key carries scount/tw in 5 bits each"
    assert T < TRI_MASK, f"packed key carries triangle ids in {TRI_BITS} bits"

    with span("bin.sort"):
        tx0, ty0 = setup.tile_lo[:, 0].long(), setup.tile_lo[:, 1].long()
        tx1, ty1 = setup.tile_hi[:, 0].long(), setup.tile_hi[:, 1].long()
        tw = torch.clamp(tx1 - tx0 + 1, min=0)
        th = torch.clamp(ty1 - ty0 + 1, min=0)
        ncover = torch.where(setup.valid, tw * th, torch.zeros_like(tw))
        is_broad = setup.valid & (ncover > K)
        is_narrow = setup.valid & (ncover <= K) & (ncover > 0)
        dense_live = is_narrow.sum()

        tri_ids = torch.arange(T, dtype=torch.int64, device=dev)
        zmin_q = setup.channels[:, S.CH_ZMIN].to(torch.int64)  # 0..65535 exact
        scount = torch.where(is_narrow, torch.clamp(ncover - 1, min=0),
                             torch.zeros_like(ncover))
        total_spill = scount.sum()
        caps = _level_caps(spill_cap, K, override=spill_level_caps)
        level_demand = torch.stack([(scount >= (1 << j)).sum()
                                    for j in range(len(caps))])

        # key = (31-scount)<<37 | (tw-1)<<32 | tri  (dead rows: all ones)
        # opA = zmin<<16 | ty0<<8 | tx0
        key = pack_key(scount, torch.clamp(tw, 1, K), tri_ids)
        key = torch.where(is_narrow, key, torch.full_like(key, DEAD_KEY))
        opA = ((torch.clamp(zmin_q, 0, 65535) << 16)
               | (torch.clamp(ty0, 0, 255) << 8) | torch.clamp(tx0, 0, 255))
        vcap = min(valid_cap, entry_cap) if valid_cap else T
        n_pad = max(max(vcap, max(caps)) - T, 0)
        if n_pad:
            key = torch.cat([key, torch.full((n_pad,), DEAD_KEY,
                                             dtype=torch.int64, device=dev)])
            opA = torch.cat([opA, opA.new_zeros((n_pad,))])
        key, perm = torch.sort(key)
        opA = opA[perm]

    key2, all_tri, placed_dense, placed_spill = emit_entries(
        key, opA, T=T, grid_w=grid_w, ntiles=ntiles, K=K, vcap=vcap,
        caps=caps, entry_cap=entry_cap)

    with span("bin.tiles"):
        # disjoint overflow terms: valid_cap drops, level-cap drops, then
        # entry-cap drops of the rest
        live_placed = placed_dense + placed_spill
        overflow = ((dense_live - placed_dense) + (total_spill - placed_spill)
                    + torch.clamp(live_placed - entry_cap, min=0))

        # (tile, zmin) sort: dead rows carry the ntiles sentinel and sort last
        key2, perm2 = torch.sort(key2)
        i32 = torch.int32
        entry_tile = (key2[:entry_cap] >> 16).to(i32)
        entry_tri = all_tri[perm2[:entry_cap]]
        tile_start = torch.searchsorted(
            entry_tile, torch.arange(ntiles + 1, dtype=i32, device=dev),
            side="left").to(i32)
        # dead rows keep their (garbage) channels: consumers mask by segment
        entry_channels = setup.channels[entry_tri]

    with span("bin.broad"):
        # broad triangles: compacted side list (inverse lookup, no scatter)
        num_broad = is_broad.sum()
        bcum = torch.cumsum(is_broad.to(i32), dim=0, dtype=i32)
        broad_src = torch.searchsorted(
            bcum, torch.arange(1, broad_cap + 1, dtype=i32, device=dev),
            side="left")
        broad_live = broad_src < T
        broad_src = torch.clamp(broad_src, 0, T - 1)
        bbox = torch.stack([tx0, ty0, tx1, ty1], dim=1)[broad_src]
        empty = torch.zeros((1, 4), dtype=bbox.dtype, device=dev)
        empty[:, :2] = 1                      # (1, 1, 0, 0): an empty bbox
        broad_tiles = torch.where(broad_live[:, None], bbox, empty).to(i32)
        overflow = overflow + torch.clamp(num_broad - broad_cap, min=0)
        broad_channels = setup.channels[broad_src]

    return BinnedEntries(
        entry_channels=entry_channels,
        entry_tile=entry_tile,
        tile_start=tile_start,
        num_entries=torch.clamp(live_placed, max=entry_cap).to(i32),
        overflow=overflow.to(i32),
        broad_channels=broad_channels,
        broad_tiles=broad_tiles.contiguous(),
        num_broad=torch.clamp(num_broad, max=broad_cap).to(i32),
        dense_demand=dense_live.to(i32),
        level_demand=level_demand.to(i32),
        entry_extra=extra[entry_tri] if extra is not None else None,
        broad_extra=extra[broad_src] if extra is not None else None,
    )
