"""Visibility-buffer resolve in plain PyTorch (counterpart of
``tyleri_tpu/ops/visibility.py``): the plain version of K3.

Every tile resolves the visible entry per pixel; shading happens once per
pixel afterwards (ops/shade.py).  Vulkan's submission-order semantics for
depth ties come from the CH_ORDER channel: the winner is the lexicographic
best of (quantized z, draw order) — min z, then the latest draw for
LESS_OR_EQUAL or the earliest for LESS.  An exact tie in both (the two
halves of a split triangle on a shared edge) goes to the entry the kernel
processes last for LESS_OR_EQUAL and first for LESS; narrow entries run in
table order, then the broad list, so that is the larger owner id for
LESS_OR_EQUAL and the smaller for LESS.

``rasterize_visibility_reference`` computes what the CUDA kernel
(ops/raster_cuda.py) computes, from the same binned table: every entry of
every tile's segment (the kernel's early exit only skips entries that
cannot pass), then the broad list.  It evaluates entries in blocks, each
against the pixels of its tile, and reduces per pixel with packed integer
keys, so its memory stays bounded at 1080p.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState
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


def check_depth_state(depth_state: DepthState) -> None:
    if depth_state.compare_op not in (CompareOp.LESS,
                                      CompareOp.LESS_OR_EQUAL):
        raise NotImplementedError(
            "the visibility resolve supports LESS/LESS_OR_EQUAL; other "
            "compare ops need exact mode (not yet ported)")
    if not (depth_state.test_enable and depth_state.write_enable):
        raise NotImplementedError("the visibility resolve needs depth "
                                  "test+write")


def _plane(ch, row, xf, yf):
    return (ch[..., row] * xf + ch[..., row + 1] * yf) + ch[..., row + 2]


def _quantized_z(ch, xf, yf, fmt: DepthFormat):
    """(raw z, clamped z, quantized z) as the kernel computes them: D16
    multiplies by the f32 reciprocal of 65535, as raster_pallas.py:229
    does (ops/depth.py divides, as the JAX package's XLA path does)."""
    z = _plane(ch, S.CH_Z, xf, yf)
    zc = torch.clamp(z, 0.0, 1.0)
    if fmt == DepthFormat.D16_UNORM:
        return z, zc, torch.round(zc * 65535.0) * S.INV_D16
    return z, zc, zc


def _fragments(ch, xf, yf, live, fmt: DepthFormat):
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
    z, zc, zq = _quantized_z(ch, xf, yf, fmt)
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
        # exact integers below 2^24
        # (+ 0.0 turns a -0.0 into +0.0, which the kernel treats as equal)
        zbits = (zq + 0.0).contiguous().view(torch.int32).to(torch.int64)
        o = order.to(torch.int64)
        return (zbits << 24) | (((1 << 24) - 1 - o) if self.le else o)

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


def rasterize_visibility_reference(
        binned: BinnedEntries, init_depth, scissor, *, fb_w: int, fb_h: int,
        tile_w: int, tile_h: int, grid_w: int, grid_h: int,
        depth_state: DepthState) -> VisibilityBuffer:
    """Plain version of K3.  ``init_depth`` f32 [fb_h, fb_w]; scissor 4
    host ints."""
    check_depth_state(depth_state)
    dev = binned.entry_channels.device
    le = depth_state.compare_op == CompareOp.LESS_OR_EQUAL
    fmt = depth_state.format
    scx, scy, scw, sch = S.scissor_ints(scissor)
    npix = fb_w * fb_h
    depth0 = init_depth.reshape(npix).to(torch.float32)
    best = _Best(npix, dev, le)

    P = tile_w * tile_h
    lx = torch.arange(P, device=dev) % tile_w
    ly = torch.arange(P, device=dev) // tile_w

    def candidates(ch, eids, px, py):
        """ch [N, 24] against pixels px/py [N, M] -> folded into best."""
        xf = px.to(torch.float32) + 0.5
        yf = py.to(torch.float32) + 0.5
        live = ((px < fb_w) & (py < fb_h) & (px >= scx) & (px < scx + scw)
                & (py >= scy) & (py < scy + sch))
        frag, zq = _fragments(ch[:, None, :], xf, yf, live, fmt)
        pix = torch.clamp(py, 0, fb_h - 1) * fb_w + torch.clamp(px, 0,
                                                                fb_w - 1)
        z0 = depth0[pix]
        passing = frag & ((zq <= z0) if le else (zq < z0))
        order = ch[:, S.CH_ORDER][:, None].expand_as(zq)
        eid = eids[:, None].expand_as(zq)
        best.update(pix[passing], best.pack(zq[passing], order[passing]),
                    eid[passing])

    # narrow entries: each tile's segment against that tile's pixels
    hi = int(binned.tile_start[grid_w * grid_h])
    block = max(1, _PAIRS_PER_BLOCK // P)
    for s in range(0, hi, block):
        e = min(s + block, hi)
        tile = binned.entry_tile[s:e].long()
        px = (tile % grid_w * tile_w)[:, None] + lx[None, :]
        py = (tile // grid_w * tile_h)[:, None] + ly[None, :]
        candidates(binned.entry_channels[s:e],
                   torch.arange(s, e, device=dev), px, py)

    # broad entries: every pixel whose tile is in the entry's tile bbox
    E_cap = binned.entry_channels.shape[0]
    nb = min(int(binned.num_broad), binned.broad_channels.shape[0])
    pid = torch.arange(npix, device=dev)
    all_px, all_py = (pid % fb_w)[None, :], (pid // fb_w)[None, :]
    for j in range(nb):
        tx0, ty0, tx1, ty1 = binned.broad_tiles[j].tolist()
        in_box = ((all_px // tile_w >= tx0) & (all_px // tile_w <= tx1)
                  & (all_py // tile_h >= ty0) & (all_py // tile_h <= ty1))
        px = torch.where(in_box, all_px, torch.full_like(all_px, fb_w))
        candidates(binned.broad_channels[j:j + 1],
                   torch.full((1,), E_cap + j, device=dev), px, all_py)

    # winner attributes: the winner's planes at the pixel centers
    owner = best.owner
    won = owner >= 0
    all_ch = torch.cat([binned.entry_channels, binned.broad_channels])
    ch = all_ch[torch.clamp(owner, min=0)]
    xf = all_px[0].to(torch.float32) + 0.5
    yf = all_py[0].to(torch.float32) + 0.5
    _, _, zq = _quantized_z(ch, xf, yf, fmt)
    one, zero = torch.ones_like(xf), torch.zeros_like(xf)

    def plane_or(row, dflt):
        return torch.where(won, _plane(ch, row, xf, yf), dflt)

    def hw(t):
        return t.reshape(fb_h, fb_w)

    tex = ch[:, S.CH_META].to(torch.int32) & S.META_TEX_MASK
    return VisibilityBuffer(
        owner=hw(owner.to(torch.int32)),
        depth=hw(torch.where(won, zq, depth0)),
        order=hw(torch.where(won, ch[:, S.CH_ORDER], -one)),
        uw=hw(plane_or(S.CH_UW, zero)),
        vw=hw(plane_or(S.CH_VW, zero)),
        iw=hw(plane_or(S.CH_INVW, one)),
        tex=hw(torch.where(won, tex, torch.zeros_like(tex))),
    )
