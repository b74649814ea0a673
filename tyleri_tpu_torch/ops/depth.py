"""Depth-format quantization (counterpart of ``tyleri_tpu/ops/depth.py``).

The reference renders against a D16_UNORM depth attachment; depth is kept
in f32 but only ever holds values on the D16 grid.

This is the JAX package's XLA-path quantization, which divides by 65535.
The visibility kernel multiplies by the f32 reciprocal instead
(raster_pallas.py:229), and so do the port's K3 and its plain version
(ops/visibility.py); the two roundings differ in the last bit for about
one value in a hundred.
"""

from __future__ import annotations

import torch

from tyleri_tpu.pipeline.state import DepthFormat


def quantize_depth(z: torch.Tensor, fmt: DepthFormat) -> torch.Tensor:
    """Clamp window depth to [0, 1] and round half to even onto the
    format's grid."""
    z = torch.clamp(z.to(torch.float32), 0.0, 1.0)
    if fmt == DepthFormat.D32_SFLOAT:
        return z
    return torch.round(z * 65535.0) / 65535.0
