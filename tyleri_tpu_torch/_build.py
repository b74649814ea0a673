"""Build and load the hand-written CUDA kernels of ``csrc/``.

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: the build takes seconds).
The library lands in ``build/tyleri_tpu_torch/`` at the repository root,
keyed by a hash of the sources and flags, and is built on the first kernel
launch of a process.  A failed build raises; there is no fallback.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded, as
eager PyTorch does, so each kernel is bit-equal to its plain version on the
card.  No fast-math: divisions and square roots stay IEEE.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tyleri_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtyleri_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ty_fused_setup.restype = i
    lib.ty_fused_setup.argtypes = [
        p, p, p, p, p,            # corners, tri_draw, tri_tex, tri_valid, mvps
        i, i, i,                  # T, D, cam_valid
        f, f, f, f, f, f,         # viewport
        i, i, i, i,               # scissor
        i, i, i, i,               # tile shifts, grid dims
        i, i,                     # cull, ccw_front
        p, p, p, p, p,            # channels, valid, tile_lo, tile_hi, crossed
        p,                        # stream
    ]
    lib.ty_rasterize_visibility.restype = i
    lib.ty_rasterize_visibility.argtypes = [
        p, p, p, p, p, i,         # tile_start, entries, broad ch/tiles, nbroad, B
        p,                        # depth0
        i, i, i, i, i, i,         # fb_w, fb_h, tile_w, tile_h, grid_w, grid_h
        i, i, i, i,               # scissor
        i, i, i, i,               # owner_base, chunk, le, d16
        p, p, p, p, p, p, p,      # owner, z, order, uw, vw, iw, tex
        p, p, p, p, p, p, p,      # layer 2 of the same (peel2), or null
        p,                        # nvis (counts), or null
        p,                        # stream
    ]


def load():
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
