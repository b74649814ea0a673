"""Texture arena: the descriptor-heap analog (the port's own copy of
``tyleri_tpu/resource/textures.py``, which it never imports;
``tests/test_torch_vendored.py`` holds the two together).

The reference creates one R8G8B8A8_UNORM sampled image + one descriptor set
per texture (ref: src/resource/mod.rs:59-136).  Here every texture is a
row-major slice of one flat numpy rgba texel arena; a ``StaticTexture`` is
just a slot id + extent — the "descriptor set" that mesh/UI draws carry.
``texture_tensors`` builds the 2x2 texel-quad table the sampler reads and
copies it to a ``torch.device`` when the arena changed, keeping the copy on
the arena.
"""

from __future__ import annotations

import bisect
import threading

import numpy as np
import torch

from tyleri_tpu_torch.ops.sampling import make_texel_quads


class StaticTexture:
    """Texture handle: slot id into the arena metadata (descriptor analog)."""

    def __init__(self, arena: "TextureArena", slot: int, width: int, height: int):
        self.arena = arena
        self.slot = int(slot)
        self.width = int(width)
        self.height = int(height)
        self._freed = False

    def free(self) -> None:
        """Release the texels and slot back to the arena (the reference's
        textures drop with their Arc — src/resource/mod.rs:59-136).  Using
        the handle after free() renders whatever texture reuses the slot."""
        if not self._freed:
            self._freed = True
            self.arena.free(self)


class TextureArena:
    def __init__(self, initial_texels: int = 1 << 16, budget_check=None):
        # budget_check(total_texels) raises MemoryError if a growth would
        # exceed the device budget (checked before growing, like the
        # reference's try_memory_type probing — resource_info.rs:47-58)
        self._budget_check = budget_check
        self._texels = np.zeros((int(initial_texels), 4), np.float32)
        self._used = 0
        self._offsets: list[int] = []
        self._widths: list[int] = []
        self._heights: list[int] = []
        self._free_extents: list[tuple[int, int]] = []  # (offset, size) sorted
        self._free_slots: list[int] = []
        self._dirty = True
        self._device = None
        self._lock = threading.Lock()

    @property
    def num_slots(self) -> int:
        return len(self._offsets)

    def _ensure(self, extra: int) -> None:
        need = self._used + extra
        if need <= len(self._texels):
            return
        cap = len(self._texels)
        while cap < need:
            cap *= 2
        if self._budget_check is not None:
            self._budget_check(cap)
        grown = np.zeros((cap, 4), np.float32)
        grown[: self._used] = self._texels[: self._used]
        self._texels = grown

    def allocate(self, items):
        """Batch-create textures: [( (width, height), writer ), ...].

        writer(buf) receives an [h, w, 4] f32 view to fill (rgba in [0,1]);
        uint8 data should be divided by 255 by the caller (the reference's
        images are R8G8B8A8_UNORM, so u8/255 reproduces its sampled values).
        Returns [StaticTexture, ...].
        """
        items = list(items)
        with self._lock:
            total = sum(w * h for (w, h), _ in items)
            self._ensure(total)
            out = []
            for (w, h), writer in items:
                off = self._take_extent(w * h)
                view = self._texels[off : off + w * h].reshape(h, w, 4)
                writer(view)
                if self._free_slots:
                    slot = self._free_slots.pop()
                    self._offsets[slot] = off
                    self._widths[slot] = w
                    self._heights[slot] = h
                else:
                    slot = len(self._offsets)
                    self._offsets.append(off)
                    self._widths.append(w)
                    self._heights.append(h)
                out.append(StaticTexture(self, slot, w, h))
            self._dirty = True
            return out

    def _take_extent(self, size: int) -> int:
        """First-fit from the free list, else bump-allocate."""
        for i, (off, sz) in enumerate(self._free_extents):
            if sz >= size:
                if sz == size:
                    self._free_extents.pop(i)
                else:
                    self._free_extents[i] = (off + size, sz - size)
                return off
        off = self._used
        self._used += size
        return off

    def free(self, tex: StaticTexture) -> None:
        """Reclaim a texture's extent + slot (the reference's Arc-drop
        semantics, ref: src/resource/mod.rs:59-136).  Adjacent free extents
        coalesce; a trailing free extent shrinks the bump pointer."""
        with self._lock:
            slot = tex.slot
            off = self._offsets[slot]
            size = self._widths[slot] * self._heights[slot]
            self._offsets[slot] = 0
            self._widths[slot] = 0
            self._heights[slot] = 0
            self._free_slots.append(slot)
            # insert + coalesce
            exts = self._free_extents
            i = bisect.bisect_left(exts, (off, size))
            exts.insert(i, (off, size))
            if i + 1 < len(exts) and exts[i][0] + exts[i][1] == exts[i + 1][0]:
                exts[i] = (exts[i][0], exts[i][1] + exts[i + 1][1])
                exts.pop(i + 1)
            if i > 0 and exts[i - 1][0] + exts[i - 1][1] == exts[i][0]:
                exts[i - 1] = (exts[i - 1][0], exts[i - 1][1] + exts[i][1])
                exts.pop(i)
                i -= 1
            if exts and exts[-1][0] + exts[-1][1] == self._used:
                self._used = exts[-1][0]
                exts.pop()
            self._dirty = True


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
