"""Image output utilities: UNORM conversion + PNG writing (stdlib zlib).

The port's copy of ``tyleri_tpu/utils/image.py``: the headless present
target (``RenderWindow(present_target=lambda img: write_png(path, img))``).

The presentation engine's "surface format" analog: framebuffers are f32 rgba
in [0,1]; presenting converts to 8-bit UNORM exactly as a Vulkan
R8G8B8A8_UNORM swapchain image would store it (round-to-nearest).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_unorm8(img) -> np.ndarray:
    """f32 [H, W, C] in [0,1] -> u8, round-to-nearest (UNORM store)."""
    arr = np.asarray(img, np.float64)
    return np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an [H, W, 4] u8 (or f32 in [0,1]) image as RGBA PNG.

    Uses the native C++ encoder (tyleri_tpu_torch.native) when built — the
    presentation hot path — with this pure-python zlib fallback."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = to_unorm8(arr)
    if arr.ndim != 3 or arr.shape[2] != 4:
        raise ValueError(f"expected [H, W, 4] rgba, got {arr.shape}")
    try:
        from tyleri_tpu_torch import native

        if native.available():
            with open(path, "wb") as f:
                f.write(native.png_encode(arr))
            return
    except Exception:
        pass
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit RGBA/RGB, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitdepth, ctype = struct.unpack(">IIBB", payload[:10])
            assert bitdepth == 8, "only 8-bit supported"
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    rpos = 0
    for y in range(h):
        filt = raw[rpos]
        row = np.frombuffer(raw[rpos + 1 : rpos + 1 + stride], np.uint8).copy()
        rpos += 1 + stride
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            for x in range(channels, stride):
                row[x] = (int(row[x]) + int(row[x - channels])) & 0xFF
        elif filt == 2:  # Up
            row = (row.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        else:
            raise NotImplementedError(f"png filter {filt}")
        out[y] = row
        prev = row
    return out.reshape(h, w, channels)
