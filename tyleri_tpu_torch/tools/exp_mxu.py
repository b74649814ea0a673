"""P2: K3's plane evaluation as matrix products (counterpart of
``tools/exp_mxu.py``: ``_mxu_kernel``), on the tensor cores.

Per tile of 128 x tile_h pixels and per chunk of ``chunk`` rows of a random
[E, 128] table at ``min(start + k * chunk, E - chunk)`` (no live mask: the
next tile's rows take part), the planes ``ct[:, :32] @ RHS_p``, RHS_p zero
but for rows 3p..3p+2 = (x + 0.5, y + 0.5, 1); split: the 64 lanes in bf16
against the exact bf16 split of the coordinates (15 rows a plane).  Then,
by variant: the min over planes and entries (bare); coverage, depth range
and D16 rounding (``do_ew``); the chunk's winner by min z, max order, max
row (``do_red``) merged into the carried one; the sums over tied winners
of planes 4..6 (``do_attr``) or of coefficient lanes 12..20 with the
planes evaluated per pixel at the end (``do_attrc``); and ``exit_cross``,
the production exit's structure on a gate that does not fire.  The output
is [grid, 8, PX]: depth, order, owner, four attributes, acc.

Precision: "highest" is an f32 product (the kernel: 3xTF32 packed into one
TF32 k8 product a plane); "default" rounds both operands to bf16 (nearest
even) and sums in f32, as the TPU's single bf16 pass does (the kernel: one
bf16 k16 product a plane, on ``wgmma``).  ``fat`` (the planes in one
product or one product each) is the same work on the card.

``prodlike`` runs the port's P3 variant kernel with the lex compare on the
table's first 24 lanes (``tools/exp_visibility.py``'s ``run_variant``).

Kernel: ``csrc/probes_mxu.cu`` ``mxu_kernel<MODE, NPLANES, STAGE, ATTR>``;
plain version ``mxu_reference``, which batches the tiles.

    python3 -m tyleri_tpu_torch.tools.exp_mxu [--device cpu] [--seg 256]
        [--chunk 128] [--tile-h 16] [--grid N] [variant ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common

TILE_W = 128
K = 32                     # the LHS lanes: coefficient rows 0..20, meta, order
FB_W, FB_H = 1920, 1080
BIG = 3.0e38
INV_Q = float(np.float32(1.0) / np.float32(65535.0))
OUT_ROWS = 8
# CUDA-core f32 operations per (entry, pixel) pair, counted from the
# kernel's source: bare, one min a plane; ew, 6 coverage compares, the
# clamp (2), the D16 rounding (3), z == zc, a select and a min; red, the
# same 12 and 4 compares of the running winner, then one add per sum
OPS_EW, OPS_RED = 14, 16
# (entry, pixel) pairs of one batch of the plain version's products
_PAIRS_PER_BATCH = 1 << 24

def grid_dims(tile_h: int) -> tuple[int, int]:
    return -(-FB_W // TILE_W), -(-FB_H // tile_h)


def _coords(gx, gy, tile_h, n, dev):
    """x + 0.5 and y + 0.5 [B, n] of lanes 0..n-1 (px = lane % PX)."""
    px = torch.arange(n, device=dev) & (TILE_W * tile_h - 1)
    xf = (gx[:, None] * TILE_W + (px & (TILE_W - 1))).to(torch.float32) + 0.5
    yf = (gy[:, None] * tile_h + (px >> 7)).to(torch.float32) + 0.5
    return xf, yf


def _rhs(gx, gy, tile_h, nplanes, split):
    """The probe's fat RHS [B, KF, nplanes * PX] for tiles (gx, gy)."""
    dev = gx.device
    PX = TILE_W * tile_h
    N = nplanes * PX
    kf, rows_per = (64, 15) if split else (K, 3)
    xf, yf = _coords(gx, gy, tile_h, N, dev)
    xf, yf = xf[:, None, :], yf[:, None, :]
    r0 = rows_per * (torch.arange(N, device=dev) // PX)
    rr = (torch.arange(kf, device=dev)[:, None] - r0[None, :])[None]
    zero = torch.zeros((), device=dev)
    if not split:
        return torch.where(rr == 0, xf, torch.where(
            rr == 1, yf, torch.where(rr == 2, 1.0, zero)))

    def hi(v):
        return (v * 0.0625).to(torch.bfloat16).to(torch.float32) * 16.0

    xhi, yhi = hi(xf), hi(yf)
    xlo, ylo = xf - xhi, yf - yhi
    return torch.where(
        (rr >= 0) & (rr < 6), torch.where(rr % 2 == 0, xhi, xlo),
        torch.where((rr >= 6) & (rr < 12), torch.where(rr % 2 == 0, yhi, ylo),
                    torch.where((rr >= 12) & (rr < 15), 1.0, zero)))


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def mxu_reference(entries, tile_start, *, grid, grid_w, chunk, precision,
                  nplanes, tile_h, fat, do_ew, do_red, do_attr, do_attrc,
                  split, exit_cross):
    """``_mxu_kernel``'s output [grid, 8, PX] for entries f32 [E, 128] and
    tile_start i32 [>= grid + 1]: the products in f32 ("highest") or on
    bf16-rounded operands ("default", split), the rest op for op.  ``fat``
    changes nothing computed here."""
    del fat
    dev = entries.device
    PX = TILE_W * tile_h
    N = nplanes * PX
    cap = entries.shape[0]
    ts = tile_start[:grid + 1].long()
    start, end = ts[:-1], ts[1:]
    nch = torch.where(end > start, -(-(end - start) // chunk), 0)
    t_all = torch.arange(grid, device=dev)
    bf16 = split or precision != "highest"
    batch = max(1, _PAIRS_PER_BATCH // (chunk * N))
    outs = []
    for b0 in range(0, grid, batch):
        t = t_all[b0:b0 + batch]
        B = t.numel()
        gx, gy = t % grid_w, t // grid_w
        rhs = _rhs(gx, gy, tile_h, nplanes, split)
        if bf16:
            rhs = _bf16(rhs)
        xf, yf = _coords(gx, gy, tile_h, PX, dev)
        zbuf = torch.full((B, PX), BIG, device=dev)
        obuf = torch.full((B, PX), -BIG, device=dev)
        owner = torch.full((B, PX), -1, dtype=torch.int32, device=dev)
        attrs = [torch.zeros((B, PX), device=dev)
                 for _ in range(10 if do_attrc else 4)]
        acc = torch.zeros((B, PX), device=dev)
        thresh = torch.full((B,), BIG, device=dev)
        alive = nch[t] > 0
        for k in range(int(nch[t].max()) if B else 0):
            s = torch.clamp(start[t] + k * chunk, max=cap - chunk)
            rows = s[:, None] + torch.arange(chunk, device=dev)
            ct = entries[rows]                              # [B, C, 128]
            alive = alive & (k < nch[t])
            if exit_cross:
                proceed = alive & (ct[:, 0, 23] * np.float32(1e-30) <= thresh)
            else:
                proceed = alive
            lhs = ct[:, :, :64 if split else K]
            if bf16:
                lhs = _bf16(lhs)
            ev_fat = torch.bmm(lhs, rhs)                     # [B, C, N]
            ev = [ev_fat[:, :, p * PX:(p + 1) * PX] for p in range(nplanes)]
            live = alive[:, None]
            if not do_ew:
                m = ev[0]
                for e in ev[1:]:
                    m = torch.minimum(m, e)
                acc = torch.where(live, acc + m.amin(dim=1), acc)
                alive = proceed
                continue
            meta = ct[:, :, 21:22].to(torch.int32)
            tl = meta >> 18
            order_c = ct[:, :, 22:23]
            e0, e1, e2, z = ev[:4]
            cov = (((e0 > 0) | ((e0 == 0) & ((tl & 1) > 0)))
                   & ((e1 > 0) | ((e1 == 0) & ((tl & 2) > 0)))
                   & ((e2 > 0) | ((e2 == 0) & ((tl & 4) > 0))))
            zc = torch.clamp(z, 0.0, 1.0)
            zq = torch.round(zc * 65535.0) * INV_Q
            frag = cov & (z == zc)
            zmask = torch.where(frag, zq, BIG)
            if not do_red:
                acc = torch.where(live, (acc + zmask.amin(dim=1))
                                  + order_c.amin(dim=1) * np.float32(1e-9),
                                  acc)
                alive = proceed
                continue
            zwin = zmask.amin(dim=1)
            at_z = frag & (zq == zwin[:, None, :])
            order_b = order_c.expand_as(zq)
            owin = torch.where(at_z, order_b, -BIG).amax(dim=1)
            at_zo = at_z & (order_b == owin[:, None, :])
            idx = rows.to(torch.int32)[:, :, None].expand_as(zq)
            iwin = torch.where(at_zo, idx, -1).amax(dim=1)
            beats = (zwin < zbuf) | ((zwin == zbuf) & (owin >= obuf))
            upd = beats & (zwin < BIG) & proceed[:, None]
            zbuf = torch.where(upd, zwin, zbuf)
            obuf = torch.where(upd, owin, obuf)
            owner = torch.where(upd, iwin, owner)
            if do_attr or do_attrc:
                sel = at_zo.to(torch.float32)
                cols = ([ev[4], ev[5], ev[6]] if do_attr else
                        [ct[:, :, r:r + 1] for r in range(12, 21)])
                texc = (meta & ((1 << 18) - 1)).to(torch.float32)
                for i, v in enumerate(cols + [texc]):
                    attrs[i] = torch.where(upd, (v * sel).sum(dim=1),
                                           attrs[i])
            if exit_cross:
                thresh = torch.where(
                    proceed, torch.minimum(zbuf.amax(dim=1), thresh), thresh)
            alive = proceed
        if do_attrc:
            def plane(i):
                return (attrs[i] * xf + attrs[i + 1] * yf) + attrs[i + 2]

            a4 = [plane(3), plane(6), plane(0), attrs[9]]
        else:
            a4 = attrs[:4]
        outs.append(torch.stack([zbuf, obuf, owner.to(torch.float32), *a4,
                                 acc], dim=1))
    return torch.cat(outs)


def _stage(do_ew, do_red):
    return 0 if not do_ew else (2 if do_red else 1)


def _nattr(do_ew, do_red, do_attr, do_attrc):
    if _stage(do_ew, do_red) != 2:
        return 0
    return 4 if do_attr else 10 if do_attrc else 0


def run_mxu(entries, tile_start, *, grid, grid_w, chunk, precision,
            nplanes, tile_h, fat, do_ew, do_red, do_attr, do_attrc, split,
            exit_cross):
    """``mxu_reference``'s output: the tensor-core kernel for CUDA tensors,
    the plain version for CPU ones."""
    kw = dict(grid=grid, grid_w=grid_w, chunk=chunk, precision=precision,
              nplanes=nplanes, tile_h=tile_h, fat=fat, do_ew=do_ew,
              do_red=do_red, do_attr=do_attr, do_attrc=do_attrc, split=split,
              exit_cross=exit_cross)
    dev = entries.device
    if dev.type == "cpu":
        return mxu_reference(entries, tile_start, **kw)
    if dev.type != "cuda":
        raise ValueError(f"mxu: unsupported device {dev}")
    mode = 2 if split else (0 if precision == "highest" else 1)
    stage = _stage(do_ew, do_red)
    attr = (1 if do_attr else 2 if do_attrc else 0) if stage == 2 else 0
    _build.check_args("mxu", dev, (
        ("entries", entries, torch.float32, None),
        ("tile_start", tile_start, torch.int32, None)))
    if (entries.dim() != 2 or entries.shape[1] < (64 if split else K)
            or entries.shape[1] % 4 or entries.data_ptr() % 16
            or entries.shape[0] < chunk):
        raise ValueError("mxu: entries must be 16-byte aligned f32 [E, C], "
                         "C >= the lanes read and a multiple of 4, E >= "
                         f"{chunk}")
    if tile_start.numel() < grid + 1:
        raise ValueError(f"mxu: tile_start must be i32 [>= {grid + 1}]")
    if (precision not in ("highest", "default") or nplanes not in (4, 7)
            or (mode == 2 and nplanes != 4) or (stage and nplanes < 4)
            or (attr == 1 and nplanes < 7) or chunk % 8 or tile_h not in
            (8, 16, 32)):
        raise ValueError(f"mxu: no kernel for {kw}")
    lib = _build.load()
    if not lib.ty_probe_mxu_smem(mode, nplanes, chunk, tile_h, stage,
                                 attr):
        raise ValueError(f"mxu: chunk {chunk} at tile_h {tile_h} needs more "
                         "shared memory than a block has")
    out = torch.empty((grid, OUT_ROWS, TILE_W * tile_h), device=dev)
    _build.launcher("mxu", "ty_probe_mxu", dev, (
        tile_start.data_ptr(), entries.data_ptr(), entries.shape[0],
        entries.shape[1], chunk, grid, grid_w, tile_h, mode, nplanes, stage,
        attr, int(exit_cross), out.data_ptr()))()
    return out


def mxu_bound(tile_start, opts, *, grid, chunk) -> dict:
    """The lanes of every chunk read and the output written once; the
    products' flops at the tensor cores' rate: "highest" (3xTF32) 8 TF32
    products a plane and pair, the packed k8 block that sums big * big,
    small * big and big * small at 495 TFLOP/s; bf16 ("default", split) the
    rows of each plane's RHS that are not zero (3, split 15) at 989; and the
    CUDA-core operations per (entry, pixel) pair.  ``tc_flops_formulated``
    counts the kernel's products: one k-block a plane, 8 TF32 rows or 16
    bf16 rows, zero rows included."""
    ts = tile_start[:grid + 1].long()
    nch = torch.where(ts[1:] > ts[:-1], -(-(ts[1:] - ts[:-1]) // chunk), 0)
    chunks = int(nch.sum())
    kf, rows_per = (64, 15) if opts["split"] else (K, 3)
    PX = TILE_W * opts["tile_h"]
    pairs = chunks * chunk * PX
    stage = _stage(opts["do_ew"], opts["do_red"])
    ops = ((opts["nplanes"], OPS_EW, OPS_RED)[stage]
           + _nattr(opts["do_ew"], opts["do_red"], opts["do_attr"],
                    opts["do_attrc"]))
    highest = opts["precision"] == "highest" and not opts["split"]
    products = 2.0 * pairs * opts["nplanes"]
    return dict(_common.bound(
        4 * (chunks * chunk * kf + grid * OUT_ROWS * PX + grid + 1),
        ops * pairs, products * (8 if highest else rows_per),
        _common.TC_TF32_FLOPS if highest else _common.TC_BF16_FLOPS),
        tc_flops_formulated=int(products * (8 if highest else 16)),
        chunks=chunks)


VARIANTS = {
    "mm4_def": dict(precision="default"),
    "mm4_hst": dict(),
    "mm7_hst": dict(nplanes=7),
    "ew": dict(do_ew=True),
    "red": dict(do_ew=True, do_red=True),
    "full": dict(nplanes=7, do_ew=True, do_red=True, do_attr=True),
    "fat4_hst": dict(fat=True),
    "fat4_def": dict(fat=True, precision="default"),
    "fat7_hst": dict(fat=True, nplanes=7),
    "fatred": dict(fat=True, do_ew=True, do_red=True),
    "fatfull": dict(fat=True, nplanes=7, do_ew=True, do_red=True,
                    do_attr=True),
    "fatfullc": dict(fat=True, do_ew=True, do_red=True, do_attrc=True),
    "fatsplit": dict(fat=True, split=True, precision="default"),
    "fatsplitred": dict(fat=True, split=True, precision="default",
                        do_ew=True, do_red=True),
    "fatsplitfullc": dict(fat=True, split=True, precision="default",
                          do_ew=True, do_red=True, do_attrc=True),
    "fatsplit_exit": dict(fat=True, split=True, precision="default",
                          do_ew=True, do_red=True, do_attrc=True,
                          exit_cross=True),
}


def options(name, tile_h=16) -> dict:
    opts = dict(precision="highest", nplanes=4, tile_h=tile_h, fat=False,
                do_ew=False, do_red=False, do_attr=False, do_attrc=False,
                split=False, exit_cross=False)
    opts.update(VARIANTS[name])
    return opts


def tool_inputs(device, *, grid=None, seg=256, chunk=128, tile_h=16,
                seed=0):
    """The tool's table f32 [E, 128] (normal, lane 21 a meta of 0..7 << 18,
    lane 22 an order in 0..4095) and tile starts ``seg`` apart, for
    ``grid`` tiles (default all of the 1080p frame's).  E is the tool's
    2^19 at the full grid, else just the tiles' rows (the last chunk then
    clamps at the table's end)."""
    full = grid is None
    grid_w, grid_h = grid_dims(tile_h)
    grid = grid_w * grid_h if full else grid
    e_cap = (max(1 << 19, -(-grid * seg // chunk) * chunk) if full
             else max(grid * seg, chunk))
    rng = np.random.default_rng(seed)
    ent = rng.standard_normal((e_cap, 128), dtype=np.float32)
    ent[:, 21] = rng.integers(0, 8, e_cap) << 18
    ent[:, 22] = rng.integers(0, 4096, e_cap)
    ts = np.minimum(np.arange(grid + 1) * seg, e_cap).astype(np.int32)
    return (torch.from_numpy(ent).to(device), torch.from_numpy(ts).to(device),
            grid)


def exact_inputs(device, *, grid, seg=256, chunk=128, split=False, seed=1):
    """A table whose products and partial sums are exact in f32, bf16 and
    TF32 whatever the order, for the lanes the layout multiplies (split:
    lanes 0..59 in planes of 15; else lanes 0..11, or 0..20 with 7 planes):
    lanes k/8, the depth plane's slopes k/2^14 (|k| <= 8) and offset k/128
    (so depths fall in [0, 1]), orders 0..7 (ties of depth and order).  The
    coordinates have at most 12 significant bits (x + 0.5 <= 1919.5), so a
    product has at most 19 and a plane's sum at most 23 (split: |k| < 32,
    at most 21 for its 15 products).  Metas carry 0..7 << 18 where no
    product reads lane 21 (split multiplies it: there a texture slot
    only)."""
    e_cap = max(grid * seg, chunk)
    rng = np.random.default_rng(seed)
    lim = 32 if split else 128
    ent = (rng.integers(-lim + 1, lim, (e_cap, 128)) / 8).astype(np.float32)
    slopes, offset = ((slice(45, 57), 57) if split else (slice(9, 11), 11))
    ent[:, slopes] = rng.integers(-8, 9, ent[:, slopes].shape) / 2.0 ** 14
    ent[:, offset] = rng.integers(0, 128, e_cap) / 128
    if split:
        ent[:, 58:60] = 0.0
        ent[:, 21] = rng.integers(0, 8, e_cap)
    else:
        ent[:, 21] = rng.integers(0, 8, e_cap) << 18
    ent[:, 22] = rng.integers(0, 8, e_cap)
    ts = np.minimum(np.arange(grid + 1) * seg, e_cap).astype(np.int32)
    return torch.from_numpy(ent).to(device), torch.from_numpy(ts).to(device)


# Kernel against plain version on inputs whose sums round: each plane sums
# its products in another order (and "highest" on the card is 3xTF32), so
# it may differ by a few roundings of 2^-24 of its terms' magnitude, and a
# depth by one D16 step more where the plane crosses a rounding boundary.
# A plane's magnitude is its lanes' count times their largest |value|
# times 1920, from the lanes that plane multiplies (3 a plane, split 15).
# The tolerance allows 2^-18 of it: for the depth, the depth plane's and
# one D16 step; for the attribute sums over tied winners, 8 of lanes
# 12..20's planes (the lanes ``do_attr`` evaluates and ``do_attrc`` sums);
# for acc, one a chunk of the largest plane's (the bare min) or of the
# depth's (the depth min); owner and order must be equal.
# A plane that close to an edge or a depth bound can give a pixel another
# winner: at most MAX_DIFFERING of the pixels may differ.
REL_TOL = 2.0 ** -18
D16_STEP = 2.0 ** -16
MAX_DIFFERING = 1e-3


def _plane_mag(entries, lo: int, n: int) -> float:
    return n * float(entries[:, lo:lo + n].abs().max()) * FB_W


def compare(got, want, entries, opts, chunks_per_tile: int):
    """(share of pixels with another winner or an output beyond the
    tolerance, largest |got - want| over the other pixels) of two [grid, 8,
    PX] outputs of variant ``opts`` on ``entries``."""
    n = 15 if opts["split"] else 3
    planes = [_plane_mag(entries, p * n, n) for p in range(opts["nplanes"])]
    depth = REL_TOL * planes[3] + D16_STEP if len(planes) > 3 else 0.0
    stage = _stage(opts["do_ew"], opts["do_red"])
    tol = torch.zeros((OUT_ROWS, 1), dtype=torch.float64, device=got.device)
    tol[0] = depth
    tol[3:7] = REL_TOL * 8 * max(_plane_mag(entries, lo, 3)
                                 for lo in (12, 15, 18))
    tol[7] = chunks_per_tile * (REL_TOL * max(planes) if stage == 0 else
                                depth if stage == 1 else 0.0)
    g, w = got.double(), want.double()
    diff = torch.where(g == w, 0.0, (g - w).abs())   # inf == inf: equal
    close = (diff <= tol).all(dim=1)
    err = torch.where(close[:, None, :], diff, 0.0)
    return float((~close).double().mean()), float(err.max())


def run_prodlike(ent, tile_start, grid, device, reps, card, *, chunk,
                 tile_h):
    """The P3 variant kernel with the lex compare on the table's first 24
    lanes over the 1080p frame; tiles past ``grid`` empty."""
    from tyleri_tpu_torch.tools import exp_visibility

    grid_w, grid_h = grid_dims(tile_h)
    ntiles = grid_w * grid_h
    seg = int(tile_start[1] - tile_start[0])
    ts = torch.clamp(torch.arange(ntiles + 1, device=device) * seg,
                     max=int(tile_start[grid])).to(torch.int32)
    ent24 = ent[:, :24].contiguous()
    depth0 = torch.ones((FB_H, FB_W), device=device)
    scissor = (0, 0, FB_W, FB_H)

    def call():
        return exp_visibility.run_variant(ent24, ts, depth0, scissor,
                                          tile_h=tile_h, chunk=chunk,
                                          lex=True)

    _, nres = call()
    t = _common.timing(call, device, reps)
    return _common.emit(
        "exp_mxu", "prodlike", device, card, **t, grid=grid,
        **exp_visibility.variant_bound(
            nres, depth0, tile_h, exp_visibility.ops_per_pair(True, False)))


def run_variants(device: torch.device, reps: int, card=None, *, seg=256,
                 chunk=128, tile_h=16, grid=None, names=None) -> list[dict]:
    ent, ts, grid = tool_inputs(device, grid=grid, seg=seg, chunk=chunk,
                                tile_h=tile_h)
    grid_w, _ = grid_dims(tile_h)
    out = []
    for name in names or ["prodlike", *VARIANTS]:
        if name == "prodlike":
            out.append(run_prodlike(ent, ts, grid, device, reps, card,
                                    chunk=chunk, tile_h=tile_h))
            continue
        opts = options(name, tile_h)
        t = _common.timing(lambda: run_mxu(ent, ts, grid=grid, grid_w=grid_w,
                                           chunk=chunk, **opts), device, reps)
        out.append(_common.emit("exp_mxu", name, device, card, **t,
                                grid=grid, seg=seg, chunk=chunk,
                                **mxu_bound(ts, opts, grid=grid,
                                            chunk=chunk)))
    return out


def _options(ap) -> None:
    ap.add_argument("--seg", type=int, default=256,
                    help="entries a tile (default 256)")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--tile-h", type=int, default=16, choices=(8, 16, 32))
    ap.add_argument("--grid", type=int, default=None,
                    help="tiles (default: the 1080p frame's)")
    ap.add_argument("variants", nargs="*",
                    help="variants to run (default: prodlike and all)")


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__, _options)
    unknown = sorted(set(args.variants) - {"prodlike", *VARIANTS})
    if unknown:
        raise SystemExit(f"unknown variants {unknown}")
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    run_variants(device, args.reps, card, seg=args.seg, chunk=args.chunk,
                 tile_h=args.tile_h, grid=args.grid,
                 names=args.variants or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
