"""Build and load the hand-written CUDA kernels of ``csrc/``.

nvcc compiles every ``csrc/*.cu`` to an object, one nvcc per source, all
started together, and links them into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: the build takes seconds).
The library lands in ``build/tyleri_tpu_torch/`` at the repository root,
keyed by a hash of the sources and flags, and is built on the first kernel
launch of a process.  A failed build raises; there is no fallback.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded, as
eager PyTorch does, so each kernel is bit-equal to its plain version on the
card.  No fast-math: divisions and square roots stay IEEE.  ``-Xptxas -v``
makes ptxas report each kernel's registers and spills; the report is kept
beside the library (``kernel_resources``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tyleri_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def report_path(lib_path: str | None = None) -> str:
    """ptxas's report of the library's build."""
    return (lib_path or library_path())[:-len(".so")] + ".ptxas.txt"


def build() -> str:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    # one nvcc per source, all started together, then one link
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                         for src, obj in zip(_sources(), objs))]
    reports = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        _raise_if_failed(cmd, proc.returncode, stdout, stderr)
        reports.append(stderr)
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    _raise_if_failed(link, proc.returncode, proc.stdout, proc.stderr)
    for obj in objs:
        os.remove(obj)
    with open(f"{tmp}.ptxas", "w") as f:
        f.write("".join(reports))
    os.replace(f"{tmp}.ptxas", report_path(out))
    os.replace(tmp, out)
    return out


def parse_ptxas(text: str) -> dict[str, tuple[int, int]]:
    """{kernel symbol: (registers, spill-store bytes)} from ``ptxas -v``
    output, one block per "Compiling entry function"."""
    out = {}
    for block in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[block.split("'", 1)[0]] = (int(regs[1]), int(spill[1]))
    return out


def demangle(symbols: list[str]) -> list[str]:
    """The names of C++ symbols, without their parameters, by the toolkit's
    ``cu++filt`` (binutils' ``c++filt`` where the toolkit has none)."""
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin")
    path = os.pathsep.join([os.environ.get("PATH", ""), cuda_bin])
    tool = shutil.which("cu++filt", path=path) or "c++filt"
    out = subprocess.run([tool, "-p"], input="\n".join(symbols),
                         capture_output=True, text=True, check=True)
    return [name.replace("(anonymous namespace)::", "")
            for name in out.stdout.splitlines()]


def kernel_resources() -> dict[str, tuple[int, int]]:
    """Registers and spill-store bytes of every kernel in the library, from
    ptxas's report of its build."""
    with open(report_path(build())) as f:
        found = parse_ptxas(f.read())
    return dict(zip(demangle(list(found)), found.values()))


def _raise_if_failed(cmd, returncode, stdout, stderr) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")


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
    maps = [p] * 7                # up to 7 output maps, null past the last
    lib.ty_gather_rows.restype = i
    lib.ty_gather_rows.argtypes = [p, p, i, i, i, p, p, p]
    lib.ty_fixed_grid.restype = i
    lib.ty_fixed_grid.argtypes = [p, i, i, i, *maps, p]
    lib.ty_fixed_cost.restype = i
    lib.ty_fixed_cost.argtypes = [p, p, i, i, p, i, *maps, p]
    lib.ty_fill.restype = i
    lib.ty_fill.argtypes = [p, i, i, i, i, p]
    lib.ty_pipe_cost.restype = i
    lib.ty_pipe_cost.argtypes = [p, p, i, i, i, i, i, *maps, p]
    lib.ty_probe_visibility.restype = i
    lib.ty_probe_visibility.argtypes = [
        p, p, i, i, p,            # tile_start, table, cap, span, depth0
        i, i, i, i,               # fb_w, fb_h, grid_w, grid_h
        i, i, i, i,               # scissor
        i, i, i, i, i, i, i, i,   # tile_h, unroll, lex, exit, strip, hoist,
                                  # e2_stored, packed
        *maps, p,                 # owner, z, order, uw, vw, iw, tex; nres
        p,                        # stream
    ]
    lib.ty_probe_mxu_smem.restype = ctypes.c_longlong
    lib.ty_probe_mxu_smem.argtypes = [i, i, i, i, i]
    lib.ty_probe_mxu.restype = i
    lib.ty_probe_mxu.argtypes = [
        p, p, i, i, i,            # tile_start, entries, cap, stride, chunk
        i, i, i,                  # grid, grid_w, tile_h
        i, i, i, i, i,            # mode, nplanes, stage, attr, exit_cross
        p, p,                     # out, stream
    ]
    lib.ty_transpose_rows.restype = i
    lib.ty_transpose_rows.argtypes = [p, i, i, p, p]


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
