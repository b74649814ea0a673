"""RenderDevice — the central device context (counterpart of
``tyleri_tpu/device/render_device.py``; ref: src/render_device.rs:15-23).

Holds the ``torch.device`` every tensor of the frame path lives on, the
memory allocator (the JAX package's numpy geometry and texture arenas,
reused as they are), the depth format, the debug messenger and the dispatch
queue.  The batch upload API (create_vertices / create_indices /
create_textures) is the JAX package's: it only fills numpy staging arrays,
which the resource snapshots (resource/arenas.py, resource/textures.py)
copy to the device.
"""

from __future__ import annotations

import contextlib

import torch

from tyleri_tpu.device import render_device as _reference
from tyleri_tpu.device.debug import DebugMessenger
from tyleri_tpu.pipeline.state import DepthFormat
from tyleri_tpu.resource.allocator import MemoryAllocator


class DispatchQueue:
    """One ordered submission stream (ParallelRecordingQueue analog): work
    submitted here is enqueued on the queue's CUDA stream, so the frame
    loop's kernels run in order and off the default stream.  On the CPU
    there is no stream and work runs where it is submitted."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)

    def context(self):
        """Context manager that makes this queue's stream current."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def fence(self):
        """An event recorded after everything submitted so far, or None on
        the CPU (where submitted work has already run)."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event


class _MemoryInfo:
    """The ``memory_stats()`` face ResourcesInfo reads a budget from."""

    def __init__(self, device: torch.device):
        self.device = device

    def memory_stats(self) -> dict:
        if self.device.type != "cuda":
            return {}
        props = torch.cuda.get_device_properties(self.device)
        return {"bytes_limit": int(props.total_memory)}


class RenderDevice:
    # the upload API only writes numpy staging: the JAX package's own
    create_vertices = _reference.RenderDevice.create_vertices
    create_lit_vertices = _reference.RenderDevice.create_lit_vertices
    create_indices = _reference.RenderDevice.create_indices
    create_textures = _reference.RenderDevice.create_textures
    _report_oom = _reference.RenderDevice._report_oom

    def __init__(
        self,
        device: torch.device,
        *,
        depth_format: DepthFormat = DepthFormat.D16_UNORM,
        debug_messenger: DebugMessenger | None = None,
    ):
        self.device = torch.device(device)
        self.depth_format = depth_format
        self.debug_messenger = debug_messenger or DebugMessenger()
        self.memory_allocator = MemoryAllocator(_MemoryInfo(self.device))
        self.queue = DispatchQueue(self.device)
