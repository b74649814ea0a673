"""MemoryAllocator — the central resource owner (ref:
src/resource/resource_allocator.rs:13-61).

Owns:
* the two global bindless geometry arenas every static mesh suballocates
  from (initial capacities mirror the reference: 2048 vertices / 1024
  indices, ref: resource_allocator.rs:15-16,31-44)
* the texture arena (descriptor-heap analog)
* the upload queue — the transfer-queue analog: a lock that serializes
  flushes of the geometry arenas to the allocator's device (ref:
  parking_lot::Mutex<ParallelRecordingQueue>, resource_allocator.rs:20)

The port's own copy of ``tyleri_tpu/resource/allocator.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
The frame path copies the arenas to the card through
``resource/arenas.py::geometry_tensors`` and
``resource/textures.py::texture_tensors``, which take the device
explicitly; the JAX class's snapshot methods are left out.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tyleri_tpu_torch.resource.arenas import (
    BindlessBufferAllocator,
    device_arrays,
)
from tyleri_tpu_torch.resource.resource_info import ResourcesInfo
from tyleri_tpu_torch.resource.textures import TextureArena

VERTICES_INIT_SIZE = 2048  # ref: resource_allocator.rs:15
INDICES_INIT_SIZE = 1024   # ref: resource_allocator.rs:16


class UploadQueue:
    """Transfer-stream analog: serializes flushes of dirty arenas to the
    device.  ``device`` is where the tensors go: CUDA unless the caller
    names another device (the CPU)."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = torch.device("cuda" if device is None else device)
        self._lock = threading.Lock()

    def flush(self, *arenas):
        """Each ``BindlessBufferAllocator``'s field tensors on the device
        (uploaded if dirty), as ``resource/arenas.py::device_arrays``."""
        with self._lock:
            return [device_arrays(arena, self.device) for arena in arenas]


class MemoryAllocator:
    def __init__(self, device=None):
        self.resources_info = ResourcesInfo(device)
        # SoA vertex arena: positions [N,3] f32 + uvs [N,2] f32 (the Vertex
        # layout of tyleri-api: pos vec3 + uv vec2).  Every arena growth is
        # budget-checked first (try_memory_type analog): an oversized
        # allocation raises MemoryError early instead of OOMing mid-frame.
        ri = self.resources_info
        # "nrm" extends the reference layout for the lit path (BASELINE
        # config 3); unlit uploads leave it zero and cost nothing extra.
        self.static_vertices_buffer = BindlessBufferAllocator(
            {"pos": ((3,), np.float32), "uv": ((2,), np.float32),
             "nrm": ((3,), np.float32)},
            VERTICES_INIT_SIZE,
            budget_check=lambda n: ri.check_budget("static_vertices", n),
        )
        self.static_indices_buffer = BindlessBufferAllocator(
            {"idx": ((), np.uint32)}, INDICES_INIT_SIZE,
            budget_check=lambda n: ri.check_budget("static_indices", n),
        )
        self.texture_arena = TextureArena(
            budget_check=lambda n: ri.check_budget("textures", n)
        )
        # the device of the memory info the allocator was given (the render
        # device's), CUDA without one
        self.upload_queue = UploadQueue(getattr(device, "device", None))
