"""RenderWindow — owner of one render target's frame loop (counterpart of
``tyleri_tpu/window/render_window.py``; ref: src/render_window.rs).

``render()`` is the per-frame loop (ref: render_window.rs:126-218):

  reference                             port
  ---------                             ----
  steal available RenderScene           take the available scene object
  acquire_next_image                    ring-slot index from the swapchain
  pop a present queue                   pop a DispatchQueue (its own CUDA
                                        stream) from the device's pool
  rendering_function.record(...)        kernels enqueued on that stream
  queue_present                         on-device UNORM8 quantize plus async
                                        copies of the image and the frame's
                                        stats into pinned host memory
  fence wait on frame N-k               CUDA event of that slot's frame
  reset CBs / clear render resources    scene.clear(), stats -> validation

On a device mesh (``device_mesh=make_render_mesh(n)``, one window a rank)
``record`` becomes ``record_sharded``: each rank renders its band, and the
quantized bands are gathered over the mesh's ``tiles`` axis, so every rank
presents the whole image.

Frames in flight = swapchain image count: the host records frame N while
the card renders N-1..N-k.  A recycled frame's stats (overflow and demand
counters) are already on the host when its fence has passed, so reading
them costs no extra synchronization; they feed the rendering function's
capacity feedback (``note_overflow``).  Feedback is taken only from frames
recorded under the current plan: frames still in flight from before a plan
change would otherwise repeat the change they caused.  Their overflows are
reported all the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tyleri_tpu_torch.device.builders import RenderDeviceBuilder
from tyleri_tpu_torch.scene.render_scene import RenderScene
from tyleri_tpu_torch.utils.profiling import (
    FrameProfiler,
    count,
    recording,
    span,
)
from tyleri_tpu_torch.window.swapchain import ImageViewSwapchain
from tyleri_tpu_torch.rendering.forward import (
    ForwardRenderingFunction,
    quantize_unorm8,
)


@dataclasses.dataclass(frozen=True, eq=True)
class WindowHandle:
    """Hashable window+display handle (ref: src/lib.rs:25-34); ``None``
    fields = headless."""

    window: Optional[int] = None
    display: Optional[int] = None


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start an async device->host copy into pinned memory (CPU tensors
    are already on the host)."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _check_mesh(device_mesh, render_device) -> None:
    """A window renders on a (draws, tiles) DeviceMesh
    (``parallel.mesh.make_render_mesh``) whose device is the rank's render
    device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from tyleri_tpu_torch.parallel.mesh import AXIS_DRAWS, AXIS_TILES

    if (not isinstance(device_mesh, DeviceMesh)
            or device_mesh.mesh_dim_names != (AXIS_DRAWS, AXIS_TILES)):
        raise TypeError(f"device_mesh must be a DeviceMesh with dims "
                        f"({AXIS_DRAWS!r}, {AXIS_TILES!r}) (make_render_mesh),"
                        f" got {device_mesh!r}")
    dev = render_device.device
    if device_mesh.device_type != dev.type or (
            dev.type == "cuda"
            and dev.index != dist.get_rank() % torch.cuda.device_count()):
        raise ValueError(
            f"rank {dist.get_rank()} of a {device_mesh.device_type} mesh "
            f"renders on its own device, not {dev} (build the device with "
            f".device_id(rank % torch.cuda.device_count()), or with "
            f".device('cpu') for a cpu mesh)")


class _InFlight:
    """One swapchain slot's frame (ref: render_window.rs:29-43)."""

    def __init__(self, frame, scene, plan, image, stats, fence, index,
                 triangles):
        self.frame = frame    # the recorded Frame (device tensors)
        self.scene = scene    # the RenderScene that recorded it
        self.plan = plan      # the rendering function's plan at record time
        self._image = image   # u8 [H, W, 4] host copy in flight
        self._stats = stats   # i32 stats vector host copy in flight
        self._fence = fence   # CUDA event after the copies (None on CPU)
        self.index = index    # the window's frame_index when it recorded
        self.triangles = triangles  # the scene's triangle count

    def pending(self) -> bool:
        """Whether the fence has not passed yet (a wait would block)."""
        return self._fence is not None and not self._fence.query()

    def wait(self):
        """Fence wait (ref: render_window.rs:193); returns (image, stats)
        as numpy."""
        if self._fence is not None:
            self._fence.synchronize()
        return self._image.numpy(), self._stats.numpy()


class RenderWindow:
    def __init__(
        self,
        render_device,
        window_handle: Optional[WindowHandle] = None,
        *,
        resolution=(800, 600),
        scale_factor: float = 1.0,
        rendering_function=ForwardRenderingFunction,
        present_target: Optional[Callable[[np.ndarray], None]] = None,
        exact: bool = False,
        blend_parity: str = "auto",
        present_mode: str = "fifo",
        refresh_hz: float = 60.0,
        device_mesh=None,
        composite_alpha: str = "opaque",
    ):
        if device_mesh is not None:
            _check_mesh(device_mesh, render_device)
        self.device_mesh = device_mesh
        if composite_alpha not in ("opaque", "inherit"):
            raise ValueError(f"unsupported composite_alpha {composite_alpha!r}")
        self.render_device = render_device
        self.window_handle = window_handle or WindowHandle()
        # surface-support re-check at window creation
        # (ref: render_window.rs:62-75)
        if not RenderDeviceBuilder._supports_presentation(
                render_device.device, self.window_handle):
            raise ValueError(f"device {render_device.device} cannot present "
                             f"to {self.window_handle!r}")
        self._scale_factor = float(scale_factor)
        self.swapchain = ImageViewSwapchain(resolution,
                                            present_mode=present_mode)
        self.rendering_function = rendering_function(
            render_device, self.swapchain, exact=exact,
            blend_parity=blend_parity)
        self.composite_alpha = composite_alpha
        # FIFO (vsync) presentation is mandatory in the reference
        # (swapchain.rs:46-51); "immediate" skips the pacing
        self._pacer = None
        if self.swapchain.present_mode == "fifo":
            from tyleri_tpu_torch import native

            self._pacer = native.FramePacer(refresh_hz)
        self.present_target = present_target
        self._latest_image = None
        self.frame_index = 0
        self._available_scene = RenderScene()
        self._using: dict[int, _InFlight] = {}
        self.profiler = FrameProfiler()

    @property
    def resolution(self):
        return self.swapchain.resolution

    @property
    def scale_factor(self) -> float:
        return self._scale_factor

    def get_render_scene(self) -> RenderScene:
        return self._available_scene

    @property
    def latest_image(self) -> Optional[np.ndarray]:
        """The last presented u8 image [H, W, 4] (host copy)."""
        return self._latest_image

    def get_swapchain_images(self) -> int:
        return self.swapchain.image_count

    def resize(self, resolution) -> None:
        """Drain in-flight frames, rebuild the image ring and re-target the
        rendering function; learned capacities carry over."""
        self.flush()
        self.swapchain = ImageViewSwapchain(
            resolution, present_mode=self.swapchain.present_mode)
        self._latest_image = None
        self.rendering_function.resize(resolution)

    def render(self, render_device=None) -> int:
        with span("frame", frame=self.frame_index):
            return self._render(render_device or self.render_device)

    def _render(self, device) -> int:
        scene = self._available_scene
        self._available_scene = None  # stolen (the MaybeUninit swap analog)
        tri_count = sum(
            sum(m.triangle_count for m in cam.mesh_renderers)
            for cam in scene.render_resources.cameras)
        image_index = self.swapchain.acquire_next_image()

        rf = self.rendering_function
        queue = device.present_queues.pop()
        try:
            with queue.context():
                if self.device_mesh is None:
                    frame = rf.record(device, scene.render_resources,
                                      self._scale_factor,
                                      self.swapchain.resolution)
                else:
                    frame = rf.record_sharded(
                        device, scene.render_resources, self._scale_factor,
                        self.swapchain.resolution, self.device_mesh)
                plan = rf.plan
                with span("present.enqueue"):
                    image = quantize_unorm8(
                        frame.color, opaque=self.composite_alpha == "opaque")
                    if self.device_mesh is not None:
                        # every rank presents the whole image
                        from tyleri_tpu_torch.parallel.sharding import (
                            gather_rows,
                        )

                        image = gather_rows(image, rf.frame_mesh,
                                            self.swapchain.resolution[1])
                    image = _to_host(image)
                    stats = _to_host(frame.stats_vector())
                    fence = queue.fence()
        finally:
            device.present_queues.push(queue)

        previous = self._using.pop(image_index, None)
        self._using[image_index] = _InFlight(frame, scene, plan, image,
                                             stats, fence, self.frame_index,
                                             tri_count)
        if previous is not None:
            self._present(device, previous)
            previous.scene.clear()
            self._available_scene = previous.scene
        else:
            self._available_scene = RenderScene()

        if self._pacer is not None:
            with span("pace"):
                self._pacer.wait()  # FIFO present: next refresh tick
        self.frame_index += 1
        return image_index

    def _present(self, device, using: _InFlight) -> None:
        """Fence-wait a recycled frame, present its image and report its
        stats."""
        with span("present", frame=using.index):
            if recording() and using.pending():
                count("present.fence_pending")
            with span("present.fence_wait"):
                img, stats = using.wait()
            self._latest_image = img
            with span("present.target"):
                if self.present_target is not None:
                    self.present_target(img)
                self.profiler.frame(using.triangles)
            with span("present.feedback"):
                self._report_stats(
                    device, stats,
                    current=using.plan == self.rendering_function.plan)

    def _report_stats(self, device, stats: np.ndarray, current: bool) -> None:
        """Report a frame's overflows (never dropped) and, if it ran under
        the current plan, feed the capacity feedback.  ``stats`` is
        Frame.stats_vector() on the host."""
        bin_of, tile_of, clip_of, clip_x, bin_dem, entry_dem = (
            int(v) for v in stats[:6])
        # binning's work: live narrow triangles and entries placed (the
        # entry demand, capped at the plan's entry_cap), one report a frame
        count("bin.reported")
        count("bin.live", bin_dem)
        count("bin.entries", entry_dem)
        device.debug_messenger.check_overflow("bin-entries", bin_of)
        device.debug_messenger.check_overflow("tile-entries", tile_of)
        device.debug_messenger.check_overflow("clip-splits", clip_of)
        if current:
            self.rendering_function.note_overflow(
                bin_of, tile_of, clip_of, clip_x, bin_dem, entry_dem,
                spill_demand=stats[6:], n_frames=1)

    def flush(self) -> Optional[np.ndarray]:
        """Drain all in-flight frames (the Drop behavior, ref:
        render_window.rs:226-233), oldest first; returns the last presented
        image."""
        with span("flush"):
            order = sorted(self._using.items(), key=lambda kv: (
                (kv[0] - self.swapchain.last_acquired_image - 1)
                % self.swapchain.image_count))
            for _, using in order:
                self._present(self.render_device, using)
                using.scene.clear()
            self._using.clear()
        return self.latest_image

    def __enter__(self) -> "RenderWindow":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.flush()
