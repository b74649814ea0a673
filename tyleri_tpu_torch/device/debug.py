"""Validation-layer analog: the debug messenger.

The reference optionally enables the Vulkan validation layer and installs a
DebugUtilsMessenger printing severity/type/id/message
(ref: src/render_device/builders.rs:93-130).  Here the "validation layer" is
runtime checking inside the framework itself (capacity overflows, shape/dtype
misuse, non-finite matrices), routed through the same kind of callback.

The port's own copy of ``tyleri_tpu/device/debug.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
from typing import Callable, Optional


class Severity(enum.IntEnum):
    VERBOSE = 0
    INFO = 1
    WARNING = 2
    ERROR = 3


class MessageType(enum.Enum):
    GENERAL = "general"
    VALIDATION = "validation"
    PERFORMANCE = "performance"


@dataclasses.dataclass
class DebugMessage:
    severity: Severity
    message_type: MessageType
    message_id: str
    message: str


def default_messenger(msg: DebugMessage) -> None:
    # matches the reference's println of severity/type/id/message
    # (builders.rs:109-116)
    print(
        f"[{msg.severity.name}] [{msg.message_type.value}] "
        f"[{msg.message_id}] {msg.message}",
        file=sys.stderr,
    )


class DebugMessenger:
    def __init__(
        self,
        min_severity: Severity = Severity.WARNING,
        callback: Optional[Callable[[DebugMessage], None]] = None,
    ):
        self.min_severity = min_severity
        self.callback = callback or default_messenger

    def emit(
        self,
        severity: Severity,
        message_id: str,
        message: str,
        message_type: MessageType = MessageType.VALIDATION,
    ) -> None:
        if severity >= self.min_severity:
            self.callback(DebugMessage(severity, message_type, message_id, message))

    def check_overflow(self, name: str, count) -> None:
        """Report raster capacity overflows (PassStats consumers call this)."""
        n = int(count)
        if n > 0:
            self.emit(
                Severity.ERROR,
                "capacity-overflow",
                f"{name}: {n} entries dropped — raise the RasterPlan capacity",
                MessageType.VALIDATION,
            )
