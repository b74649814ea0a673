"""Device snapshots of the geometry arenas (counterpart of the device half
of ``tyleri_tpu/resource/arenas.py``).

The arenas are the JAX package's numpy staging areas
(``BindlessBufferAllocator``, filled by the writer-callback upload API).
``device_arrays`` replaces that class's JAX snapshot: it copies the staging
arrays to tensors on a ``torch.device`` when they changed, and keeps the
copy on the arena, as the JAX method does with its own.
"""

from __future__ import annotations

import numpy as np
import torch

from tyleri_tpu.resource.arenas import BindlessBufferAllocator


def device_arrays(arena: BindlessBufferAllocator, device: torch.device
                  ) -> dict:
    """Upload-if-dirty: name -> tensor on ``device``.  u32 fields become
    int64 (PyTorch indexes with int64)."""
    with arena._lock:
        snap = arena._device
        if (arena._dirty or not isinstance(snap, dict)
                or any(not isinstance(t, torch.Tensor) or t.device != device
                       for t in snap.values())):
            snap = {}
            for name in arena.fields:
                a = arena.staging(name)
                if a.dtype == np.uint32:
                    a = a.astype(np.int64)
                snap[name] = torch.from_numpy(np.ascontiguousarray(a)).to(
                    device)
            arena._device = snap
            arena._dirty = False
        return snap


def geometry_tensors(allocator, device: torch.device):
    """(positions f32 [V, 3], uvs f32 [V, 2], normals f32 [V, 3], indices
    i64 [I]) of a ``tyleri_tpu.resource.allocator.MemoryAllocator`` on
    ``device``."""
    v = device_arrays(allocator.static_vertices_buffer, device)
    i = device_arrays(allocator.static_indices_buffer, device)
    return v["pos"], v["uv"], v["nrm"], i["idx"]
