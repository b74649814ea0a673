"""Native host runtime: ctypes bindings to host_runtime.cpp.

The port's copy of ``tyleri_tpu/native/__init__.py``.  g++ builds the
shared library on first use into the build directory the kernel library
uses (``_build.build_dir()``: ``build/tyleri_tpu_torch/`` at the repository
root, listed in ``.gitignore``, unless a pipeline cache names another),
keyed by a hash of the flags and the source; ``compiles`` counts the builds
this process made.  The PNG encoder links zlib, so g++ must find
``zlib.h``; ``build_error()`` says why a build failed.  Every native
component has a pure-python fallback, so ``available()`` failing never
breaks the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from tyleri_tpu_torch import _build as _kernels

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_runtime.cpp")
BUILD_DIR = _kernels.BUILD_DIR   # the default build directory
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-lz", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None
compiles = 0   # g++ builds of the library in this process


def library_path(directory: str | None = None) -> str:
    """The library's path in ``directory`` (default: the build directory),
    keyed by the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(directory or _kernels.build_dir(),
                        f"libtyleri_host_{h.hexdigest()[:16]}.so")


def _build() -> str:
    global compiles
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    compiles += 1
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp, *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed ({e.returncode}): {e.stderr}") from e
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except Exception as e:  # keep the python fallback working
            _build_error = f"{type(e).__name__}: {e}"
            return None
        u64 = ctypes.c_uint64
        lib.ty_allocator_create.restype = ctypes.c_void_p
        lib.ty_allocator_create.argtypes = [u64]
        lib.ty_allocator_destroy.argtypes = [ctypes.c_void_p]
        lib.ty_allocator_allocate.restype = u64
        lib.ty_allocator_allocate.argtypes = [ctypes.c_void_p, u64]
        lib.ty_allocator_par_allocate.restype = ctypes.c_int
        lib.ty_allocator_par_allocate.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(u64), u64, u64, ctypes.POINTER(u64)
        ]
        lib.ty_allocator_free.argtypes = [ctypes.c_void_p, u64, u64]
        lib.ty_allocator_grow.argtypes = [ctypes.c_void_p, u64]
        lib.ty_allocator_capacity.restype = u64
        lib.ty_allocator_capacity.argtypes = [ctypes.c_void_p]
        lib.ty_allocator_largest_free.restype = u64
        lib.ty_allocator_largest_free.argtypes = [ctypes.c_void_p]
        lib.ty_png_encode.restype = u64
        lib.ty_png_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_char_p, u64,
        ]
        lib.ty_pacer_create.restype = ctypes.c_void_p
        lib.ty_pacer_create.argtypes = [ctypes.c_double]
        lib.ty_pacer_destroy.argtypes = [ctypes.c_void_p]
        lib.ty_pacer_wait.restype = ctypes.c_uint32
        lib.ty_pacer_wait.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


class NativeBlockAllocator:
    """ctypes wrapper matching resource.arenas.BlockBasedAllocator's API."""

    def __init__(self, capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.ty_allocator_create(capacity)
        self.capacity = int(capacity)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ty_allocator_destroy(h)
            self._h = None

    def allocate(self, size: int) -> int:
        from tyleri_tpu_torch.resource.arenas import AllocationError

        off = self._lib.ty_allocator_allocate(self._h, size)
        if off == (1 << 64) - 1:
            raise AllocationError(f"arena exhausted: {size} of {self.capacity}")
        return int(off)

    def par_allocate(self, sizes, total_hint=None):
        from tyleri_tpu_torch.resource.arenas import AllocationError

        sizes = list(sizes)
        n = len(sizes)
        arr = (ctypes.c_uint64 * n)(*sizes)
        out = (ctypes.c_uint64 * n)()
        hint = total_hint if total_hint is not None else sum(sizes)
        rc = self._lib.ty_allocator_par_allocate(self._h, arr, n, hint, out)
        if rc != 0:
            raise AllocationError(f"arena exhausted (batch of {n})")
        return [int(x) for x in out]

    def free(self, offset: int, size: int) -> None:
        self._lib.ty_allocator_free(self._h, offset, size)

    def grow(self, new_capacity: int) -> None:
        self._lib.ty_allocator_grow(self._h, new_capacity)
        self.capacity = max(self.capacity, int(new_capacity))

    @property
    def largest_free(self) -> int:
        return int(self._lib.ty_allocator_largest_free(self._h))


def png_encode(rgba) -> bytes:
    """Encode [H, W, 4] u8 rgba via the native encoder."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    arr = np.ascontiguousarray(rgba, np.uint8)
    h, w = arr.shape[:2]
    cap = arr.nbytes + (1 << 16)
    out = ctypes.create_string_buffer(cap)
    n = lib.ty_png_encode(arr.ctypes.data_as(ctypes.c_char_p), w, h, out, cap)
    if n == 0:
        raise RuntimeError("png encode failed")
    return out.raw[:n]


class FramePacer:
    """FIFO/vsync presentation clock (swapchain.rs:46-51 analog)."""

    def __init__(self, refresh_hz: float = 60.0):
        lib = _load()
        self._lib = lib
        self._h = lib.ty_pacer_create(float(refresh_hz)) if lib else None
        self._refresh = refresh_hz

    def wait(self) -> int:
        if self._h is not None:
            return int(self._lib.ty_pacer_wait(self._h))
        return 0

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ty_pacer_destroy(h)
            self._h = None
