"""The yardstick of the kernels' roofline shares: the card's published
peaks and the bytes and operations each kernel's work needs, counted from
the shapes of the tensors it reads and writes (each input read once, each
output written once) and from the work its inputs need.

NVIDIA H100 SXM, data sheet peaks at the card's 700 W limit.  The kernels
build with ``-fmad=false``, so every f32 add, multiply and compare is an
instruction of its own: half the 67 TFLOP/s that counts a fused
multiply-add as two."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2

# K1+K2 (fused setup): f32 operations per table row, counted from the
# kernel's source (transform, clip flags, setup of the planes)
K1K2_OPS_PER_ROW = 300
# K3's resolve per pixel and entry: 19 f32 operations (three planes, the
# derived edge, clamp, D16 rounding) and 10 compares
K3_OPS_PER_PAIR = 29
K3_MAPS = 7          # owner, z, order, uw, vw, iw, tex: 4 bytes a pixel each
ENTRY_BYTES = 96     # 24 f32 channels a table row


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(nbytes_: float, nops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory's peak and the operations at the f32 instruction peak."""
    return max(nbytes_ / HBM_BYTES_PER_S, nops / F32_INSTR_PER_S) * 1e3


def k1k2_bound_ms(inputs, outputs, rows: int) -> float:
    """K1+K2 on a table of ``rows`` rows: corners, draw and texture ids,
    valid flags and MVPs read; the channel rows, valid flags, tile boxes
    and crossing flags written."""
    return bound_ms(nbytes(*inputs, *outputs), K1K2_OPS_PER_ROW * rows)


def k3_bound_ms(binned, depth0, visited: int, tile_px: int) -> float:
    """K3's base variant on one table: the narrow rows it visited (its
    counts variant's count on the same table), the live broad rows with
    their tile boxes, the tile starts and the depth read once; the seven
    maps written once; the resolve's operations for every visited row and
    pixel of its tile, and every broad row and pixel of its box."""
    nb = int(binned.num_broad)
    box = binned.broad_tiles[:nb].long()
    broad_px = int(((box[:, 2] - box[:, 0] + 1).clamp(min=0)
                    * (box[:, 3] - box[:, 1] + 1).clamp(min=0)).sum()
                   ) * tile_px
    b = (visited * ENTRY_BYTES + nb * (ENTRY_BYTES + 16)
         + nbytes(binned.tile_start, depth0) + K3_MAPS * depth0.numel() * 4)
    return bound_ms(b, K3_OPS_PER_PAIR * (visited * tile_px + broad_px))
