"""The comparison that decides ``correct``: each frame the check judges,
as the window presented it, against the reference's frame for the same
frame time, drawn from the benchmark's own scene data.

Two numbers, each the worst over the judged frames:

* ``mismatch``: the share of the frame's pixels with a channel more than
  1 u8 off the reference (1 u8 is the presentation's rounding);
* ``block_mismatch``: the largest share, within one 16 x 16 block of the
  frame (the visibility kernel's tile), of pixels with a channel more than
  8 u8 off: a wrong tile, or a wrong patch of the overlay, reads high here
  however small a share of the frame it is.  The program's f32 planes put
  a magnified texel's bilinear ramp 2 to 5 u8 off near the camera, in
  clusters; 8 u8 leaves those out and keeps every wrong colour.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference

BLOCK = 16
PIXEL_TOL = 1    # u8 steps a pixel of ``mismatch`` may be off
BLOCK_TOL = 8    # u8 steps a pixel of ``block_mismatch`` may be off


def numbers(got: np.ndarray, want: np.ndarray) -> dict:
    if got.shape != want.shape:
        return dict(mismatch=1.0, block_mismatch=1.0)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
    off = diff > BLOCK_TOL
    H, W = off.shape
    hb, wb = -(-H // BLOCK), -(-W // BLOCK)
    pad = np.zeros((hb * BLOCK, wb * BLOCK), bool)
    pad[:H, :W] = off
    per = pad.reshape(hb, BLOCK, wb, BLOCK).sum(axis=(1, 3))
    area = np.full((hb, wb), BLOCK * BLOCK)
    area[-1, :] = (H - (hb - 1) * BLOCK) * BLOCK
    area[:, -1] = area[:, -1] // BLOCK * (W - (wb - 1) * BLOCK)
    return dict(mismatch=float((diff > PIXEL_TOL).mean()),
                block_mismatch=float((per / area).max()))


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def check(scene, overlay, config, frames: dict, times: dict, device_type,
          precision="f64") -> dict:
    """The worst numbers over ``frames`` {frame: presented u8 image}; a
    window that presented none of them fails every number."""
    import torch

    device = torch.device(device_type)
    readings = [dict(mismatch=1.0, block_mismatch=1.0)] if not frames else []
    for j, got in frames.items():
        want = reference.render(scene, scene.frame(times[j]), config, device,
                                overlay, precision)
        readings.append(numbers(np.asarray(got), want))
    return worst(readings)
