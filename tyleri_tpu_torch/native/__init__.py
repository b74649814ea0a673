"""Native host runtime: ctypes bindings to host_runtime.cpp.

The port's copy of ``tyleri_tpu/native/__init__.py``, without the PNG
encoder.  g++ builds the shared library on first use into
``build/tyleri_tpu_torch/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source.  Every native component has
a pure-python fallback, so ``available()`` failing never breaks the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "tyleri_tpu_torch")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libtyleri_host_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp,
           "-pthread"]
    subprocess.run(cmd, check=True, capture_output=True)
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
