"""Visibility-buffer resolve in plain PyTorch (counterpart of
``tyleri_tpu/ops/visibility.py``): the plain version of K3.

Every tile resolves the visible entry per pixel; shading happens once per
pixel afterwards (ops/shade.py).  Vulkan's submission-order semantics for
depth ties come from the CH_ORDER channel, an int32 draw order carried as
its bit pattern (``setup.encode_order``) and compared as an integer: the
winner is the lexicographic best of (quantized z, draw order) — min z,
then the latest draw for LESS_OR_EQUAL or the earliest for LESS.  An exact
tie in both (the two halves of a split triangle on a shared edge) goes to
the entry the kernel processes last for LESS_OR_EQUAL and first for LESS;
narrow entries run in table order, then the broad list, so that is the
larger owner id for LESS_OR_EQUAL and the smaller for LESS.  The order
maps give the owner's order as f32, rounded past 2^24.

``rasterize_visibility_stream_reference`` is the plain version of the CUDA
kernel (ops/raster_cuda.py) in all three variants.  It streams every
tile's segment in the kernel's order (position k of every tile at once,
then the broad list), with the kernel's per-pixel state and its chunked
early exit: before each chunk of ``chunk`` rows, a tile stops once the
chunk's first CH_ZMIN bound lies beyond the tile's deepest depth.  Two
variants depend on that order and have no other form:

* peel2 carries a second layer per pixel, the depth-record holder just
  before the winner drew, for the two-layer sequential blend;
* the visit counter counts, per tile, the narrow entries the kernel
  resolves before its exit.

``rasterize_visibility_last_passing`` resolves the depth states K3 does
not take (``k3_supports``): ALWAYS and NEVER, the test off, and the write
off.  Under those the reference's XLA resolve lets the last drawn passing
fragment own the pixel (tyleri_tpu/ops/visibility.py:194-207), testing
each fragment against the incoming depth, which the pass never changes
while it tests; the depth buffer takes the owner's depth only with the
write on.

``rasterize_visibility_reference`` resolves the same table with no exit:
every entry of every tile's segment, then the broad list, evaluated in
blocks against the pixels of each tile and reduced per pixel with packed
integer keys.  It is the depth test's exact answer.  The exit skips only
entries that cannot pass wherever an entry's z plane stays above its
CH_ZMIN bound, which holds up to the f32 rounding of the plane's
evaluation; on a nearly degenerate triangle the rounding of |2A| scales
the whole plane, which can dip below the bound, and the exit then skips
an entry that would have won (a few pixels of a 1080p sponza frame; the
JAX package's Pallas kernel exits the same way).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tyleri_tpu_torch.pipeline.state import (
    CompareOp,
    DepthFormat,
    DepthState,
    lookup,
)
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries

# (entry, pixel) pairs evaluated per block of the plain version
_PAIRS_PER_BLOCK = 1 << 22


class VisibilityBuffer(NamedTuple):
    owner: torch.Tensor  # i32 [H, W] row of concat(entries, broad), -1 none
    depth: torch.Tensor  # f32 [H, W] quantized depth after the pass
    order: torch.Tensor  # f32 [H, W] draw order of the owner (-1 none)
    uw: torch.Tensor     # f32 [H, W] winner u/w at the pixel center
    vw: torch.Tensor     # f32 [H, W] winner v/w
    iw: torch.Tensor     # f32 [H, W] winner 1/w
    tex: torch.Tensor    # i32 [H, W] winner texture slot


_K3_COMPARE = {op: op in (CompareOp.LESS, CompareOp.LESS_OR_EQUAL)
               for op in CompareOp}
_D16 = {DepthFormat.D16_UNORM: True, DepthFormat.D32_SFLOAT: False}


def k3_supports(depth_state: DepthState) -> bool:
    """Depth test + write with LESS or LESS_OR_EQUAL: the states K3 and its
    plain versions resolve.  The rendering passes take
    ``rasterize_visibility_last_passing`` for every other state."""
    return (lookup(_K3_COMPARE, depth_state.compare_op)
            and depth_state.test_enable and depth_state.write_enable)


def check_depth_state(depth_state: DepthState) -> None:
    if not k3_supports(depth_state):
        raise ValueError(
            "K3 resolves depth test+write with LESS/LESS_OR_EQUAL; other "
            "states take rasterize_visibility_last_passing")


def depth_flags(depth_state: DepthState) -> tuple[bool, bool]:
    """(LESS_OR_EQUAL, D16) of a depth state K3 resolves."""
    check_depth_state(depth_state)
    return (depth_state.compare_op == CompareOp.LESS_OR_EQUAL,
            lookup(_D16, depth_state.format))


def _plane(ch, row, xf, yf):
    return (ch[..., row] * xf + ch[..., row + 1] * yf) + ch[..., row + 2]


def _quantized_z(ch, xf, yf, d16: bool):
    """(raw z, clamped z, quantized z) as the kernel computes them: D16
    multiplies by the f32 reciprocal of 65535, as raster_pallas.py:229
    does (ops/depth.py divides, as the JAX package's XLA path does)."""
    z = _plane(ch, S.CH_Z, xf, yf)
    zc = torch.clamp(z, 0.0, 1.0)
    if d16:
        return z, zc, torch.round(zc * 65535.0) * S.INV_D16
    return z, zc, zc


def _fragments(ch, xf, yf, live, d16: bool):
    """Coverage + depth-range test of entries ch [..., 24] at pixel centers
    (xf, yf) broadcast against them; ``live`` masks pixels.  Returns
    (frag bool, zq f32)."""
    tl = ch[..., S.CH_META].to(torch.int32) >> S.META_TEX_BITS
    e0 = _plane(ch, S.CH_E0, xf, yf)
    e1 = _plane(ch, S.CH_E1, xf, yf)
    e2 = (ch[..., S.CH_TWOA] - e0) - e1
    cov = (((e0 > 0) | ((e0 == 0) & ((tl & 1) > 0)))
           & ((e1 > 0) | ((e1 == 0) & ((tl & 2) > 0)))
           & ((e2 > 0) | ((e2 == 0) & ((tl & 4) > 0))))
    z, zc, zq = _quantized_z(ch, xf, yf, d16)
    return cov & (z == zc) & live, zq


class _Best:
    """Per-pixel running winner: a packed (z, order) key plus the owner."""

    def __init__(self, npix: int, dev, le: bool):
        self.le = le
        self.key = torch.full((npix,), torch.iinfo(torch.int64).max,
                              dtype=torch.int64, device=dev)
        self.owner = torch.full((npix,), -1, dtype=torch.int64, device=dev)

    def pack(self, zq, order):
        # zq in [0, 1]: its f32 bits order like the values; orders are
        # int32 draw orders, at most 2^31 - 1
        # (+ 0.0 turns a -0.0 into +0.0, which the kernel treats as equal)
        zbits = (zq + 0.0).contiguous().view(torch.int32).to(torch.int64)
        o = order.to(torch.int64)
        return (zbits << 32) | (((1 << 32) - 1 - o) if self.le else o)

    def update(self, pix, key, eid):
        """Fold candidates (pixel index, key, owner id) into the winner,
        with the kernel's tie rule for owners processed after the
        current ones."""
        npix = self.key.shape[0]
        if pix.numel() == 0:
            return
        best = torch.full((npix,), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=pix.device)
        best.scatter_reduce_(0, pix, key, reduce="amin")
        hit = key == best[pix]
        own = torch.full((npix,), -1 if self.le else torch.iinfo(
            torch.int64).max, dtype=torch.int64, device=pix.device)
        own.scatter_reduce_(0, pix[hit], eid[hit],
                            reduce="amax" if self.le else "amin")
        # later candidates win exact ties under LE, lose them under LESS
        take = (best < self.key) | ((best == self.key) & self.le
                                    & (best != torch.iinfo(torch.int64).max))
        self.key = torch.where(take, best, self.key)
        self.owner = torch.where(take, own, self.owner)


def _pair_blocks(binned: BinnedEntries, scissor, *, fb_w: int, fb_h: int,
                 tile_w: int, tile_h: int, grid_w: int, grid_h: int):
    """A binned table's (entry, pixel) pairs in blocks, in K3's order: each
    narrow entry against its tile's pixels, then each broad entry against
    every pixel of its tile box.  Yields (ch [N, 24], eid [N], xf, yf, live,
    pix), the last four [N, M]: pixel centers, in the framebuffer and the
    scissor, and the flat pixel index (clamped where not live)."""
    dev = binned.entry_channels.device
    scx, scy, scw, sch = S.scissor_ints(scissor)

    def block(ch, eids, px, py):
        live = ((px < fb_w) & (py < fb_h) & (px >= scx) & (px < scx + scw)
                & (py >= scy) & (py < scy + sch))
        pix = torch.clamp(py, 0, fb_h - 1) * fb_w + torch.clamp(px, 0,
                                                                fb_w - 1)
        return (ch, eids, px.to(torch.float32) + 0.5,
                py.to(torch.float32) + 0.5, live, pix)

    P = tile_w * tile_h
    lx = torch.arange(P, device=dev) % tile_w
    ly = torch.arange(P, device=dev) // tile_w
    hi = int(binned.tile_start[grid_w * grid_h])
    step = max(1, _PAIRS_PER_BLOCK // P)
    for s in range(0, hi, step):
        e = min(s + step, hi)
        tile = binned.entry_tile[s:e].long()
        px = (tile % grid_w * tile_w)[:, None] + lx[None, :]
        py = (tile // grid_w * tile_h)[:, None] + ly[None, :]
        yield block(binned.entry_channels[s:e],
                    torch.arange(s, e, device=dev), px, py)

    E_cap = binned.entry_channels.shape[0]
    nb = min(int(binned.num_broad), binned.broad_channels.shape[0])
    pid = torch.arange(fb_w * fb_h, device=dev)
    all_px, all_py = (pid % fb_w)[None, :], (pid // fb_w)[None, :]
    for j in range(nb):
        tx0, ty0, tx1, ty1 = binned.broad_tiles[j].tolist()
        in_box = ((all_px // tile_w >= tx0) & (all_px // tile_w <= tx1)
                  & (all_py // tile_h >= ty0) & (all_py // tile_h <= ty1))
        px = torch.where(in_box, all_px, torch.full_like(all_px, fb_w))
        yield block(binned.broad_channels[j:j + 1],
                    torch.full((1,), E_cap + j, device=dev), px, all_py)


def _winner_maps(binned: BinnedEntries, owner, depth0, fb_w: int, fb_h: int,
                 d16: bool, write: bool) -> VisibilityBuffer:
    """The maps of the winners ``owner`` (i64 [fb_h * fb_w], -1 none): each
    winner's planes at the pixel centers; the depth its quantized z with
    ``write``, else the incoming ``depth0``."""
    won = owner >= 0
    all_ch = torch.cat([binned.entry_channels, binned.broad_channels])
    ch = all_ch[torch.clamp(owner, min=0)]
    pid = torch.arange(fb_w * fb_h, device=owner.device)
    xf = (pid % fb_w).to(torch.float32) + 0.5
    yf = (pid // fb_w).to(torch.float32) + 0.5
    _, _, zq = _quantized_z(ch, xf, yf, d16)
    one, zero = torch.ones_like(xf), torch.zeros_like(xf)

    def plane_or(row, dflt):
        return torch.where(won, _plane(ch, row, xf, yf), dflt)

    def hw(t):
        return t.reshape(fb_h, fb_w)

    tex = ch[:, S.CH_META].to(torch.int32) & S.META_TEX_MASK
    return VisibilityBuffer(
        owner=hw(owner.to(torch.int32)),
        depth=hw(torch.where(won, zq, depth0) if write else depth0),
        order=hw(torch.where(won, S.decode_order(ch[:, S.CH_ORDER]).to(
            torch.float32), -one)),
        uw=hw(plane_or(S.CH_UW, zero)),
        vw=hw(plane_or(S.CH_VW, zero)),
        iw=hw(plane_or(S.CH_INVW, one)),
        tex=hw(torch.where(won, tex, torch.zeros_like(tex))),
    )


def rasterize_visibility_reference(
        binned: BinnedEntries, init_depth, scissor, *, fb_w: int, fb_h: int,
        tile_w: int, tile_h: int, grid_w: int, grid_h: int,
        depth_state: DepthState) -> VisibilityBuffer:
    """K3's resolve with no early exit (the depth test's exact answer).
    ``init_depth`` f32 [fb_h, fb_w]; scissor 4 host ints."""
    le, d16 = depth_flags(depth_state)
    depth0 = init_depth.reshape(fb_w * fb_h).to(torch.float32)
    best = _Best(fb_w * fb_h, depth0.device, le)
    for ch, eids, xf, yf, live, pix in _pair_blocks(
            binned, scissor, fb_w=fb_w, fb_h=fb_h, tile_w=tile_w,
            tile_h=tile_h, grid_w=grid_w, grid_h=grid_h):
        frag, zq = _fragments(ch[:, None, :], xf, yf, live, d16)
        z0 = depth0[pix]
        passing = frag & ((zq <= z0) if le else (zq < z0))
        order = S.decode_order(ch[:, S.CH_ORDER])[:, None].expand_as(zq)
        eid = eids[:, None].expand_as(zq)
        best.update(pix[passing], best.pack(zq[passing], order[passing]),
                    eid[passing])
    return _winner_maps(binned, best.owner, depth0, fb_w, fb_h, d16,
                        write=True)


# the test each fragment of the last-passing resolve meets against the
# incoming depth; None: the reference's visibility path refuses the op
_LAST_PASSING_TEST = {
    CompareOp.ALWAYS: "always", CompareOp.NEVER: "never",
    CompareOp.LESS: "less", CompareOp.LESS_OR_EQUAL: "le",
    CompareOp.EQUAL: None, CompareOp.GREATER: None,
    CompareOp.NOT_EQUAL: None, CompareOp.GREATER_OR_EQUAL: None,
}


def rasterize_visibility_last_passing(
        binned: BinnedEntries, init_depth, scissor, *, fb_w: int, fb_h: int,
        tile_w: int, tile_h: int, grid_w: int, grid_h: int,
        depth_state: DepthState) -> VisibilityBuffer:
    """The reference's resolve for the depth states K3 does not take
    (tyleri_tpu/ops/visibility.py:137-207): every covered, in-range,
    scissored fragment that passes the test against the incoming depth
    (ALWAYS and the test off: all; NEVER: none; write off under LESS or
    LESS_OR_EQUAL: the comparison) competes, and the largest draw order
    owns the pixel.  Among passing entries of one order the first resolved
    (narrow entries in table order, then the broad list) owns it.  With
    the write on the depth buffer takes the owner's depth, else it keeps
    the incoming one.  Depth is quantized as K3 quantizes it (XLA compiles
    the reference's division by 65535 into the same multiplication).

    (entry, pixel) pairs are evaluated in blocks, as in
    ``rasterize_visibility_reference``, and reduced per pixel with one
    packed (order, entry) key.  Other compare ops raise, as on the
    reference's visibility path; they render in exact mode."""
    test = (lookup(_LAST_PASSING_TEST, depth_state.compare_op)
            if depth_state.test_enable else "always")
    if test is None:
        raise NotImplementedError(
            f"the visibility path resolves LESS, LESS_OR_EQUAL, ALWAYS and "
            f"NEVER, not {depth_state.compare_op.name}; use exact mode for "
            f"other compare ops")
    if k3_supports(depth_state):
        raise ValueError("K3 resolves depth test+write with LESS/"
                         "LESS_OR_EQUAL (rasterize_visibility)")
    d16 = lookup(_D16, depth_state.format)
    depth0 = init_depth.reshape(fb_w * fb_h).to(torch.float32)
    # key = order << 32 | (2^32 - 1 - entry): the largest order, then the
    # first entry; -1 where nothing passed
    low = (1 << 32) - 1
    best = torch.full((fb_w * fb_h,), -1, dtype=torch.int64,
                      device=depth0.device)
    blocks = () if test == "never" else _pair_blocks(
        binned, scissor, fb_w=fb_w, fb_h=fb_h, tile_w=tile_w, tile_h=tile_h,
        grid_w=grid_w, grid_h=grid_h)
    for ch, eids, xf, yf, live, pix in blocks:
        frag, zq = _fragments(ch[:, None, :], xf, yf, live, d16)
        if test == "less":
            frag = frag & (zq < depth0[pix])
        elif test == "le":
            frag = frag & (zq <= depth0[pix])
        order = S.decode_order(ch[:, S.CH_ORDER]).to(torch.int64)[
            :, None].expand_as(zq)
        eid = eids[:, None].expand_as(zq)
        key = (order[frag] << 32) | (low - eid[frag])
        best.scatter_reduce_(0, pix[frag], key, reduce="amax")
    owner = torch.where(best >= 0, low - (best & low), -1)
    return _winner_maps(binned, owner, depth0, fb_w, fb_h, d16,
                        write=depth_state.write_enable)


class _Layer:
    """One layer of the kernel's per-pixel state, [tiles, tile pixels]; the
    order as an int32 draw order."""

    FIELDS = ("owner", "z", "order", "uw", "vw", "iw", "tex")

    def __init__(self, z0):
        self.owner = torch.full_like(z0, -1, dtype=torch.int32)
        self.z = z0.clone()
        self.order = torch.full_like(z0, -1, dtype=torch.int32)
        self.uw = torch.zeros_like(z0)
        self.vw = torch.zeros_like(z0)
        self.iw = torch.ones_like(z0)
        self.tex = torch.zeros_like(z0, dtype=torch.int32)


def _stream_step(l1: _Layer, l2: _Layer | None, n: int, ch, eid, xf, yf,
                 live, le: bool, d16: bool) -> None:
    """One entry per tile (ch [n or 1, 24], eid [n or 1, 1] i32) against the
    pixels of the first n tiles: the kernel's update, raster_pallas.py
    resolve_half, including the three layer-2 rules of peel2 (:262-291)."""
    def c(row):
        return ch[:, row:row + 1]

    def plane(row):
        return (c(row) * xf + c(row + 1) * yf) + c(row + 2)

    meta = c(S.CH_META).to(torch.int32)
    tl = meta >> S.META_TEX_BITS
    e0 = plane(S.CH_E0)
    e1 = plane(S.CH_E1)
    e2 = (c(S.CH_TWOA) - e0) - e1
    cov = (((e0 > 0) | ((e0 == 0) & ((tl & 1) > 0)))
           & ((e1 > 0) | ((e1 == 0) & ((tl & 2) > 0)))
           & ((e2 > 0) | ((e2 == 0) & ((tl & 4) > 0))))
    z = plane(S.CH_Z)
    zc = torch.clamp(z, 0.0, 1.0)
    zq = torch.round(zc * 65535.0) * S.INV_D16 if d16 else zc
    order = S.decode_order(c(S.CH_ORDER))
    frag = cov & (z == zc) & live
    z1, o1 = l1.z[:n], l1.order[:n]
    passing = frag & ((zq < z1) | ((zq == z1) & (
        (order >= o1) if le else (order < o1))))
    new = dict(owner=eid, z=zq, order=order, uw=plane(S.CH_UW),
               vw=plane(S.CH_VW), iw=plane(S.CH_INVW),
               tex=meta & S.META_TEX_MASK)
    updates = []
    if l2 is not None:
        z2, o2 = l2.z[:n], l2.order[:n]
        # a non-winning fragment enters layer 2 only if drawn before the
        # winner; a new winner demotes the old one only if drawn after it,
        # else layer 2 keeps its holder while still drawn before the new
        # winner, or becomes a record gate (owner -1) at the old winner
        beats2 = (frag & ~passing & (order < o1) & ((zq < z2) | (
            (zq == z2) & ((order >= o2) if le else (order < o2)))))
        demote = passing & (o1 < order)
        inval = passing & ~demote & ~(o2 < order)
        repl = demote | inval
        for f in _Layer.FIELDS:
            old1, old2 = getattr(l1, f)[:n], getattr(l2, f)[:n]
            if f == "owner":
                took = torch.where(demote, old1, torch.where(
                    inval, -1, torch.where(beats2, new[f], old2)))
            else:
                took = torch.where(repl, old1,
                                   torch.where(beats2, new[f], old2))
            updates.append((getattr(l2, f), took))
    for f in _Layer.FIELDS:
        old = getattr(l1, f)[:n]
        updates.append((getattr(l1, f), torch.where(passing, new[f], old)))
    for dst, val in updates:   # every new value is computed from old state
        dst[:n] = val


def rasterize_visibility_stream_reference(
        binned: BinnedEntries, init_depth, scissor, *, fb_w: int, fb_h: int,
        tile_w: int, tile_h: int, grid_w: int, grid_h: int,
        depth_state: DepthState, peel2: bool = False, counts: bool = False,
        chunk: int = 64):
    """Plain version of K3 in the kernel's stream order, early exit
    included (raster_pallas.py:381-446).

    Returns the VisibilityBuffer; with ``peel2`` (vis, layer-2 vis); with
    ``counts`` (vis, nvis i32 [grid_h, grid_w]), where nvis counts the
    narrow entries of every chunk of ``chunk`` rows the kernel resolves
    before its early exit (raster_pallas.py:400-410,429)."""
    le, d16 = depth_flags(depth_state)
    if peel2 and counts:
        raise ValueError("peel2 does not compose with counts")
    dev = binned.entry_channels.device
    scx, scy, scw, sch = S.scissor_ints(scissor)
    ntiles, P = grid_w * grid_h, tile_w * tile_h

    # tiles by descending segment length: the tiles still streaming at
    # position k are a prefix, so every step works on views
    ts = binned.tile_start.long()
    seg, perm = torch.sort(ts[1:] - ts[:-1], descending=True, stable=True)
    start = ts[:-1][perm]
    seg_host = seg.cpu().numpy()
    lx = torch.arange(P, device=dev) % tile_w
    ly = torch.arange(P, device=dev) // tile_w
    x = (perm % grid_w * tile_w)[:, None] + lx
    y = (perm // grid_w * tile_h)[:, None] + ly
    inside = (x < fb_w) & (y < fb_h)
    live = (inside & (x >= scx) & (x < scx + scw) & (y >= scy)
            & (y < scy + sch))
    xf = x.to(torch.float32) + 0.5
    yf = y.to(torch.float32) + 0.5
    pix = torch.clamp(y, max=fb_h - 1) * fb_w + torch.clamp(x, max=fb_w - 1)
    z0 = torch.where(inside, init_depth.reshape(-1).to(torch.float32)[pix],
                     torch.full_like(xf, -float("inf")))
    l1 = _Layer(z0)
    l2 = _Layer(z0) if peel2 else None
    alive = torch.ones((ntiles,), dtype=torch.bool, device=dev)
    nvis = torch.zeros((ntiles,), dtype=torch.int64, device=dev)

    ent = binned.entry_channels
    # tiles whose segment is longer than k, for every position k
    n_at = np.searchsorted(-seg_host, -np.arange(int(seg_host.max(
        initial=0))), side="left")
    for k, n in enumerate(n_at.tolist()):
        rows = start[:n] + k
        ch = ent[rows]
        if k % chunk == 0:
            # the kernel's exit test before chunk k // chunk: the deepest
            # depth of the tile (of layer 2 under peel2)
            thresh = (l2 or l1).z[:n].amax(dim=1)
            alive[:n] &= ch[:, S.CH_ZMIN] * S.INV_D16 <= thresh
            if counts:
                nvis[:n] += torch.where(
                    alive[:n], torch.clamp(seg[:n] - k, max=chunk), 0)
        _stream_step(l1, l2, n, ch, rows.to(torch.int32)[:, None], xf[:n],
                     yf[:n], live[:n] & alive[:n, None], le, d16)

    # broad entries after the narrow stream, every tile in the bbox
    owner_base = ent.shape[0]
    nb = min(int(binned.num_broad), binned.broad_channels.shape[0])
    gx, gy = perm % grid_w, perm // grid_w
    for j in range(nb):
        tx0, ty0, tx1, ty1 = binned.broad_tiles[j].tolist()
        in_box = (gx >= tx0) & (gx <= tx1) & (gy >= ty0) & (gy <= ty1)
        eid = torch.full((1, 1), owner_base + j, dtype=torch.int32,
                         device=dev)
        _stream_step(l1, l2, ntiles, binned.broad_channels[j:j + 1], eid,
                     xf, yf, live & in_box[:, None], le, d16)

    inv = torch.argsort(perm)

    def image(t):
        t = t[inv].reshape(grid_h, grid_w, tile_h, tile_w)
        return t.permute(0, 2, 1, 3).reshape(grid_h * tile_h,
                                             grid_w * tile_w)[:fb_h, :fb_w]

    def buffer(layer):
        return VisibilityBuffer(owner=image(layer.owner), depth=image(layer.z),
                                order=image(layer.order).to(torch.float32),
                                uw=image(layer.uw),
                                vw=image(layer.vw), iw=image(layer.iw),
                                tex=image(layer.tex))

    vis = buffer(l1)
    if peel2:
        return vis, buffer(l2)
    if counts:
        return vis, nvis[inv].to(torch.int32).reshape(grid_h, grid_w)
    return vis
