"""RenderDeviceBuilder — fluent device creation (counterpart of
``tyleri_tpu/device/builders.py``; ref: src/render_device/builders.rs).

``build()`` picks a CUDA device: the one named by ``device_id``, else the
one with the most memory.  With no CUDA device it raises
``DeviceSelectionError``; the CPU is used only when asked for explicitly
with ``.device("cpu")`` (the plain PyTorch versions of the kernels run
there).  There is no silent fallback from the card to the CPU.

The reference's configuration surface is kept: the application and engine
names, the sampler's anisotropy, the pipeline cache (a seed of compiled
libraries, or a directory to build into: ``device/pipeline_cache.py``),
the windows the device must present to (checked in ``build()``), and the
size of the dispatch-queue pool.
"""

from __future__ import annotations

import enum
import os

import torch

from tyleri_tpu_torch.device.debug import DebugMessenger, Severity
from tyleri_tpu_torch.device.pipeline_cache import PipelineCache
from tyleri_tpu_torch.pipeline.state import DepthFormat
from tyleri_tpu_torch.device.render_device import RenderDevice

DEFAULT_APP_NAME = "Tyleri App"        # ref: builders.rs:29
DEFAULT_ENGINE_NAME = "Tyleri Engine"  # ref: builders.rs:30
DEFAULT_DEPTH_FORMAT = DepthFormat.D16_UNORM  # ref: builders.rs:31


class ValidationLevel(enum.IntEnum):
    NONE = 0
    ERROR = 1
    WARNING = 2
    INFO = 3
    VERBOSE = 4


_SEVERITY_FOR_LEVEL = {
    ValidationLevel.NONE: None,
    ValidationLevel.ERROR: Severity.ERROR,
    ValidationLevel.WARNING: Severity.WARNING,
    ValidationLevel.INFO: Severity.INFO,
    ValidationLevel.VERBOSE: Severity.VERBOSE,
}


class DeviceSelectionError(RuntimeError):
    pass


class RenderDeviceBuilder:
    def __init__(self):
        self._app_name = DEFAULT_APP_NAME
        self._engine_name = DEFAULT_ENGINE_NAME
        self._validation = ValidationLevel.NONE
        self._debug_callback = None
        self._device_type = "cuda"
        self._device_id = None
        self._depth_format = DEFAULT_DEPTH_FORMAT
        self._anisotropy = None
        self._pipeline_cache_seed = None
        self._pipeline_cache_dir = None
        self._windows = []
        self._queue_pool_size = 4

    def app_name(self, name: str):
        self._app_name = name
        return self

    def engine_name(self, name: str):
        self._engine_name = name
        return self

    def validation_level(self, level: ValidationLevel):
        self._validation = level
        return self

    def debug_callback(self, cb):
        self._debug_callback = cb
        return self

    def device(self, device_type: str):
        """"cuda" (the default) or "cpu" (the plain PyTorch versions)."""
        if device_type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device type {device_type!r}")
        self._device_type = device_type
        return self

    def device_id(self, device_id: int):
        self._device_id = device_id
        return self

    def depth_format(self, fmt: DepthFormat):
        self._depth_format = fmt
        return self

    def max_sampler_anisotropy(self, value: float):
        """Above 1, the deferred shade takes that many bilinear taps
        (clamped to 2..16) along each pixel's footprint."""
        self._anisotropy = value
        return self

    def pipeline_cache_data(self, data):
        """Seed the pipeline cache (ref: builders.rs:85-88,321-331): the
        ``bytes`` of a previous device's ``pipeline_cache.get_data()``
        (unpacked into a fresh directory), or a directory path that the
        kernel library and the host runtime are built into and loaded
        from."""
        if isinstance(data, (bytes, bytearray)):
            self._pipeline_cache_seed = bytes(data)
        else:
            self._pipeline_cache_dir = os.fspath(data)
        return self

    def present_to(self, window_handle):
        """Register a window the device must present to; ``build()``
        checks each (the reference's surface-support check)."""
        self._windows.append(window_handle)
        return self

    def queue_pool_size(self, n: int):
        self._queue_pool_size = n
        return self

    @staticmethod
    def _supports_presentation(device, handle) -> bool:
        """The surface-support check (ref: builders.rs:185-221).  The port
        presents by a device-to-host copy: a headless handle (both fields
        None) always presents; a handle naming an OS window or display
        needs well-formed non-negative ints and a windowing system on the
        host (DISPLAY or WAYLAND_DISPLAY) to hand the pixels to."""
        window = getattr(handle, "window", None)
        display = getattr(handle, "display", None)
        for field in (window, display):
            if field is not None and (not isinstance(field, int) or field < 0):
                return False
        if window is None and display is None:
            return True
        return bool(os.environ.get("DISPLAY")
                    or os.environ.get("WAYLAND_DISPLAY"))

    def _pick(self) -> torch.device:
        if self._device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise DeviceSelectionError(
                "no CUDA device available (ask for .device('cpu') explicitly "
                "to run the plain PyTorch versions)")
        n = torch.cuda.device_count()
        if self._device_id is not None:
            if not 0 <= self._device_id < n:
                raise DeviceSelectionError(
                    f"CUDA device id {self._device_id} not among {n} devices")
            return torch.device("cuda", self._device_id)
        best = max(range(n), key=lambda i: (
            torch.cuda.get_device_properties(i).total_memory, -i))
        return torch.device("cuda", best)

    def build(self) -> RenderDevice:
        device = self._pick()
        for handle in self._windows:
            if not self._supports_presentation(device, handle):
                raise DeviceSelectionError(
                    f"device {device} cannot present to window {handle!r}")
        if self._queue_pool_size < 1:
            raise DeviceSelectionError("queue pool must hold at least 1 queue")
        min_sev = _SEVERITY_FOR_LEVEL[self._validation]
        messenger = DebugMessenger(
            min_severity=min_sev if min_sev is not None else Severity.ERROR,
            callback=self._debug_callback,
        )
        if min_sev is None:
            # validation off: swallow everything
            messenger.emit = lambda *a, **k: None  # type: ignore[assignment]
        cache = PipelineCache(self._pipeline_cache_dir,
                              seed=self._pipeline_cache_seed)
        return RenderDevice(
            device,
            depth_format=self._depth_format,
            sampler_anisotropy=self._anisotropy,
            pipeline_cache=cache,
            debug_messenger=messenger,
            queue_pool_size=self._queue_pool_size,
        )
