"""RenderDevice — the central device context (counterpart of
``tyleri_tpu/device/render_device.py``; ref: src/render_device.rs:15-23).

Holds the ``torch.device`` every tensor of the frame path lives on, the
memory allocator (numpy geometry and texture arenas), the depth format, the
sampler's anisotropy, the pipeline cache, the debug messenger and a pool of
dispatch queues
(the ``SegQueue<ParallelRecordingQueue>`` analog, ref:
render_device.rs:19).  The batch upload API
(create_vertices / create_indices / create_textures, ref:
src/resource/mod.rs:31-136, with the writer-callback pattern) is copied from
the JAX package's class: it only fills numpy staging arrays, which the
resource snapshots (resource/arenas.py, resource/textures.py) copy to the
device.
"""

from __future__ import annotations

import contextlib
import queue

import numpy as np
import torch

from tyleri_tpu_torch.device import debug
from tyleri_tpu_torch.device.debug import DebugMessenger
from tyleri_tpu_torch.device.pipeline_cache import PipelineCache
from tyleri_tpu_torch.pipeline.state import DepthFormat
from tyleri_tpu_torch.resource.allocator import MemoryAllocator


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


class DispatchQueuePool:
    """The present queues, each on its own CUDA stream, popped for a frame
    and pushed back after it (ref: render_window.rs:157-178).

    Consecutive frames share the cached triangle tables, the arenas'
    device copies and the caching allocator's blocks, so the queues run in
    the order they were handed out: a popped queue's stream first waits
    for everything submitted on the queue pushed before it."""

    def __init__(self, device: torch.device, count: int = 4):
        self._q: "queue.SimpleQueue[DispatchQueue]" = queue.SimpleQueue()
        for _ in range(count):
            self._q.put(DispatchQueue(device))
        self._last = None   # event after the last pushed queue's work

    def pop(self) -> DispatchQueue:
        q = self._q.get()
        if q.stream is not None and self._last is not None:
            q.stream.wait_event(self._last)
        return q

    def push(self, q: DispatchQueue) -> None:
        if q.stream is not None:
            self._last = q.fence()
        self._q.put(q)

    def event(self, enable_timing: bool = False):
        """A CUDA event after everything submitted through the pool so far
        (None on the CPU), e.g. to time a run of frames."""
        q = self.pop()
        try:
            if q.stream is None:
                return None
            ev = torch.cuda.Event(enable_timing=enable_timing)
            ev.record(q.stream)
            return ev
        finally:
            self.push(q)


def aniso_taps(anisotropy) -> int:
    """The shade's taps for a sampler anisotropy: its rounding, clamped to
    2..16 (0 where it is unset or at most 1: plain bilinear)."""
    if not anisotropy or float(anisotropy) <= 1.0:
        return 0
    return max(2, min(int(round(float(anisotropy))), 16))


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
    def __init__(
        self,
        device: torch.device,
        *,
        depth_format: DepthFormat = DepthFormat.D16_UNORM,
        sampler_anisotropy: float | None = None,
        pipeline_cache: PipelineCache | None = None,
        debug_messenger: DebugMessenger | None = None,
        queue_pool_size: int = 4,
    ):
        self.device = torch.device(device)
        self.depth_format = depth_format
        # the shared sampler (ref: builders.rs:300-320): anisotropy above 1
        # engages the footprint-filtered deferred shade
        # (ops/sampling.py::sample_anisotropic); exact mode stays bilinear
        self.sampler_anisotropy = sampler_anisotropy
        self.pipeline_cache = pipeline_cache or PipelineCache()
        self.debug_messenger = debug_messenger or DebugMessenger()
        if sampler_anisotropy:
            self.debug_messenger.emit(
                debug.Severity.INFO,
                "sampler-anisotropy",
                f"sampler_anisotropy={sampler_anisotropy}: deferred shade "
                f"samples {aniso_taps(sampler_anisotropy)} footprint taps "
                "per pixel (visibility paths; exact mode stays bilinear)",
                debug.MessageType.PERFORMANCE,
            )
        self.memory_allocator = MemoryAllocator(_MemoryInfo(self.device))
        self.present_queues = DispatchQueuePool(self.device, queue_pool_size)

    # ---- batch upload API (ref: src/resource/mod.rs) ----

    def create_vertices(self, items):
        """items: [(count, writer), ...]; writer(buf) gets an AoS f32
        [count, 5] view (pos xyz + uv) to fill — the reference's
        FnOnce(&mut [Vertex]) writer (ref: resource/mod.rs:31-44).
        Returns [StaticVertices, ...] (arena handles with offset/len)."""
        arena = self.memory_allocator.static_vertices_buffer

        def adapt(writer, n):
            def soa_writer(pos_view, uv_view, nrm_view):
                aos = np.zeros((n, 5), np.float32)
                writer(aos)
                pos_view[:] = aos[:, :3]
                uv_view[:] = aos[:, 3:5]
                nrm_view[:] = 0.0

            return soa_writer

        return self._report_oom(
            "static_vertices",
            lambda: arena.allocate([(n, adapt(w, n)) for n, w in items]),
        )

    def create_lit_vertices(self, items):
        """items: [(count, writer), ...]; writer(buf) gets an AoS f32
        [count, 8] view (pos xyz + normal xyz + uv) to fill — the lit
        extension of the reference layout (api.vertex.LitVertex); required
        by Blinn-Phong shading (BASELINE config 3)."""
        arena = self.memory_allocator.static_vertices_buffer

        def adapt(writer, n):
            def soa_writer(pos_view, uv_view, nrm_view):
                aos = np.zeros((n, 8), np.float32)
                writer(aos)
                pos_view[:] = aos[:, :3]
                nrm_view[:] = aos[:, 3:6]
                uv_view[:] = aos[:, 6:8]

            return soa_writer

        return self._report_oom(
            "static_vertices",
            lambda: arena.allocate([(n, adapt(w, n)) for n, w in items]),
        )

    def create_indices(self, items):
        """items: [(count, writer), ...]; writer(buf) gets a u32 [count]
        view (ref: resource/mod.rs:45-58).

        Allocations are padded to multiples of 3 so every suballocation
        offset stays triangle-aligned — the vertex stage fetches each
        triangle's indices as one row of the [I/3, 3]-viewed arena."""
        arena = self.memory_allocator.static_indices_buffer

        def adapt(writer, n):
            def idx_writer(view):
                writer(view[:n])

            return idx_writer

        padded = [(-(-n // 3) * 3, adapt(w, n)) for n, w in items]
        handles = self._report_oom(
            "static_indices", lambda: arena.allocate(padded)
        )
        for h, (n, _) in zip(handles, items):
            h._alloc_len = h.len
            h.len = n
        return handles

    def create_textures(self, items):
        """items: [((width, height), writer), ...]; writer(buf) gets an
        [h, w, 4] f32 rgba view (the R8G8B8A8_UNORM image analog,
        ref: resource/mod.rs:59-136). Returns [StaticTexture, ...] — the
        per-texture descriptor-set analog is the texture slot id."""
        return self._report_oom(
            "textures",
            lambda: self.memory_allocator.texture_arena.allocate(items),
        )

    def _report_oom(self, resource_class, thunk):
        """Run an allocation; on budget failure report through the debug
        messenger (validation-layer analog) before re-raising — the failure
        surfaces at create time, not as an OOM mid-frame."""
        try:
            return thunk()
        except MemoryError as e:
            self.debug_messenger.emit(
                debug.Severity.ERROR,
                "memory-budget",
                f"{resource_class}: {e}",
                debug.MessageType.VALIDATION,
            )
            raise
