"""P7: K3's per-block fixed cost with no entries (counterpart of
``tools/exp_fixed_grid.py``, ``_kernel``).

From a [1080, 1920] f32 depth buffer, padded with zeros to whole blocks of
``rows`` x 128 pixels, write ``nouts`` maps: map 0 the depth, plus 1.0 over
a block whose max exceeds 2.0 (``zmax_reduce``); maps 1 and 6 i32 filled
with -1; the rest f32 zeros.  These are K3's stores with nothing resolved:
the floor of its output traffic.  ``rows`` keeps its meaning (16/32/64/128
rows of the frame per block, at most ``MAX_ROWS``).

Kernel: ``csrc/probes.cu`` ``fixed_grid_kernel``, bit-equal to
``fixed_grid_reference``: a CTA a block, a warp along a block row in
16-byte loads and stores, the depth read once and held in registers, the
block's max by one barrier.

    python3 -m tyleri_tpu_torch.tools.exp_fixed_grid [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common

FB_W, FB_H = 1920, 1080
TILE_W = 128
INT_MAPS = (1, 6)
# the kernel's most rows a block: 32 warps of 8 rows (csrc/probes.cu)
MAX_ROWS = 256


def padded_shape(rows: int) -> tuple[int, int]:
    return -(-FB_H // rows) * rows, -(-FB_W // TILE_W) * TILE_W


def fixed_grid_reference(depth: torch.Tensor, rows: int, nouts: int = 7,
                         zmax_reduce: bool = True) -> list[torch.Tensor]:
    pad_h, pad_w = padded_shape(rows)
    z = torch.nn.functional.pad(depth.to(torch.float32),
                                (0, pad_w - FB_W, 0, pad_h - FB_H))
    if zmax_reduce:
        m = z.view(pad_h // rows, rows, pad_w // TILE_W, TILE_W).amax(
            dim=(1, 3))
        add = torch.where(m > 2.0, 1.0, 0.0)
        z = z + add.repeat_interleave(rows, 0).repeat_interleave(TILE_W, 1)
    return [torch.full((pad_h, pad_w), -1, dtype=torch.int32,
                       device=z.device) if i in INT_MAPS
            else z if i == 0 else torch.zeros_like(z) for i in range(nouts)]


def fixed_grid(depth: torch.Tensor, rows: int, nouts: int = 7,
               zmax_reduce: bool = True) -> list[torch.Tensor]:
    """The maps of ``fixed_grid_reference``: the kernel for a CUDA depth
    buffer (contiguous f32 [1080, 1920]), the plain version for a CPU one."""
    dev = depth.device
    if dev.type == "cpu":
        return fixed_grid_reference(depth, rows, nouts, zmax_reduce)
    if dev.type != "cuda":
        raise ValueError(f"fixed_grid: unsupported device {dev}")
    _build.check_args("fixed_grid", dev,
                      (("depth", depth, torch.float32, (FB_H, FB_W)),))
    if depth.data_ptr() % 16:
        raise ValueError("fixed_grid: depth must be 16-byte aligned (the "
                         "kernel reads it as float4)")
    if not (0 < rows <= MAX_ROWS and 1 <= nouts <= 7):
        raise ValueError(f"fixed_grid: rows {rows}, nouts {nouts}")
    shape = padded_shape(rows)
    maps = [torch.empty(shape, device=dev, dtype=torch.int32
                        if i in INT_MAPS else torch.float32)
            for i in range(nouts)]
    _build.launcher("fixed_grid", "ty_fixed_grid", dev, (
        depth.data_ptr(), rows, nouts, int(zmax_reduce),
        *(m.data_ptr() for m in maps), *(None,) * (7 - nouts)))()
    return maps


def fixed_grid_bound(rows: int, nouts: int = 7) -> dict:
    """The depth read once and every map written once; a compare and an
    add per pixel."""
    pad_h, pad_w = padded_shape(rows)
    return _common.bound(4 * (FB_H * FB_W + nouts * pad_h * pad_w),
                         2 * pad_h * pad_w)


def depth_input(device, seed=0) -> torch.Tensor:
    """A depth buffer on the D16 grid, from a seed."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 65536, (FB_H, FB_W)) / 65535.0
    return torch.from_numpy(d.astype(np.float32)).to(device)


VARIANTS = {
    **{f"rows{r}_outs7_zmax": dict(rows=r) for r in (16, 32, 64, 128)},
    "rows16_outs3_zmax": dict(rows=16, nouts=3),
    "rows16_outs7_nozmax": dict(rows=16, zmax_reduce=False),
    "rows16_outs1_zmax": dict(rows=16, nouts=1),
}


def run_variants(device: torch.device, reps: int, card=None) -> list[dict]:
    depth = depth_input(device)
    out = []
    for name, kw in VARIANTS.items():
        t = _common.timing(lambda: fixed_grid(depth, **kw), device, reps)
        out.append(_common.emit(
            "exp_fixed_grid", name, device, card, **t,
            **fixed_grid_bound(kw["rows"], kw.get("nouts", 7))))
    return out


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__)
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    run_variants(device, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
