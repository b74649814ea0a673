"""Device snapshot of the texture arena (counterpart of the device half of
``tyleri_tpu/resource/textures.py``).

Textures live in the JAX package's numpy ``TextureArena`` (the
descriptor-heap analog: a flat texel arena plus per-slot offset and
extent).  ``texture_tensors`` replaces that class's JAX snapshot: it builds
the 2x2 texel-quad table the sampler reads and copies it to a
``torch.device`` when the arena changed, keeping the copy on the arena.
"""

from __future__ import annotations

import numpy as np
import torch

from tyleri_tpu.resource.textures import TextureArena
from tyleri_tpu_torch.ops.sampling import make_texel_quads


def texture_tensors(arena: TextureArena, device: torch.device):
    """(texel quads f32 [cap, 16], offsets, widths, heights i32 [slots]) on
    ``device``; a white 1x1 texture stands in when no texture exists."""
    with arena._lock:
        snap = arena._device
        if (arena._dirty or not isinstance(snap, tuple)
                or not isinstance(snap[0], torch.Tensor)
                or snap[0].device != device):
            if arena._offsets:
                texels = arena._texels[:max(arena._used, 1)]
                offs, ws, hs = arena._offsets, arena._widths, arena._heights
            else:
                texels = np.ones((1, 4), np.float32)
                offs, ws, hs = [0], [1], [1]
            quads = make_texel_quads(texels, offs, ws, hs)
            snap = (torch.from_numpy(quads).to(device),
                    *(torch.tensor(list(a), dtype=torch.int32, device=device)
                      for a in (offs, ws, hs)))
            arena._device = snap
            arena._dirty = False
        return snap
