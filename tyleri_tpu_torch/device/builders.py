"""RenderDeviceBuilder — fluent device creation (counterpart of
``tyleri_tpu/device/builders.py``; ref: src/render_device/builders.rs).

``build()`` picks a CUDA device: the one named by ``device_id``, else the
one with the most memory.  With no CUDA device it raises
``DeviceSelectionError``; the CPU is used only when asked for explicitly
with ``.device("cpu")`` (the plain PyTorch versions of the kernels run
there).  There is no silent fallback from the card to the CPU.
"""

from __future__ import annotations

import enum

import torch

from tyleri_tpu_torch.device.debug import DebugMessenger, Severity
from tyleri_tpu_torch.pipeline.state import DepthFormat
from tyleri_tpu_torch.device.render_device import RenderDevice

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
        self._validation = ValidationLevel.NONE
        self._debug_callback = None
        self._device_type = "cuda"
        self._device_id = None
        self._depth_format = DEFAULT_DEPTH_FORMAT

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
        min_sev = _SEVERITY_FOR_LEVEL[self._validation]
        messenger = DebugMessenger(
            min_severity=min_sev if min_sev is not None else Severity.ERROR,
            callback=self._debug_callback,
        )
        if min_sev is None:
            # validation off: swallow everything
            messenger.emit = lambda *a, **k: None  # type: ignore[assignment]
        return RenderDevice(
            device,
            depth_format=self._depth_format,
            debug_messenger=messenger,
        )
