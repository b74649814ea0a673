"""Frame record types (counterpart of ``tyleri_tpu/rendering/function.py``).

``record`` turns a RenderScene into one frame's work, queued on the device
asynchronously; the returned tensors are still being computed.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import torch


class Frame(NamedTuple):
    """One recorded frame: device tensors plus validation stats."""

    color: torch.Tensor           # f32 [H, W, 4]
    depth: torch.Tensor           # f32 [H, W]
    bin_overflow: torch.Tensor    # i32 []
    tile_overflow: torch.Tensor   # i32 []
    order: torch.Tensor           # f32 [H, W] global draw order of the
                                  # pixel's winner (-1 = clear, >= 1 meshes)
    clip_overflow: torch.Tensor   # i32 [] near-clip splits beyond capacity
    clip_crossings: torch.Tensor  # i32 [] near-plane crossings observed
    bin_demand: torch.Tensor      # i32 [] max live narrow triangles
    entry_demand: torch.Tensor    # i32 [] max live placed entries
    spill_demand: torch.Tensor    # i32 [L] per-spill-level demand (max)

    def stats_vector(self) -> torch.Tensor:
        """The scalars the frame loop reads back, as one i32 vector:
        (bin, tile, clip overflow, crossings, bin demand, entry demand,
        spill demand...)."""
        head = torch.stack([self.bin_overflow, self.tile_overflow,
                            self.clip_overflow, self.clip_crossings,
                            self.bin_demand, self.entry_demand])
        return torch.cat([head.to(torch.int32),
                          self.spill_demand.to(torch.int32)])


class RenderingFunction(Protocol):
    def __init__(self, render_device, swapchain): ...

    def record(self, render_device, render_resources, scale_factor: float,
               window_size) -> Frame: ...

    def note_overflow(self, bin_overflow: int, tile_overflow: int,
                      clip_overflow: int, clip_crossings: int,
                      bin_demand: int, entry_demand: int, spill_demand,
                      n_frames: int = 1) -> None: ...
