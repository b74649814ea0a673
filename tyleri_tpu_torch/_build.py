"""Build and load the hand-written CUDA kernels of ``csrc/``.

nvcc compiles every ``csrc/*.cu`` to an object, one nvcc per source, all
started together, and links them into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: the build takes seconds).
The library lands in the build directory (``build_dir()``:
``build/tyleri_tpu_torch/`` at the repository root unless a pipeline cache
names another, ``device/pipeline_cache.py``), keyed by a hash of the
sources, their headers (``csrc/*.cuh``) and the flags, and is built on the
first kernel launch of a process, under a file lock, so that processes
started together build it once.  A library found at the key's path is
loaded and nvcc does not run; ``compiles`` counts the builds this process
made.  A failed build raises; there is no fallback.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded, as
eager PyTorch does, so each kernel is bit-equal to its plain version on the
card.  No fast-math: divisions and square roots stay IEEE.  ``-Xptxas -v``
makes ptxas report each kernel's registers and spills; the report is kept
beside the library (``kernel_resources``).
"""

from __future__ import annotations

import ctypes
import fcntl
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
_dir = BUILD_DIR
compiles = 0        # nvcc builds of the library in this process
loaded_path = None  # the library load() loaded


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


def build_dir() -> str:
    """The directory the kernel library and the host runtime (``native``)
    are built into and loaded from.  Process-wide."""
    return _dir


def set_build_dir(directory: str) -> None:
    """Point this process's builds and loads at ``directory`` (a pipeline
    cache's).  A library already loaded stays loaded."""
    global _dir
    _dir = os.path.abspath(directory)


def toolkit_release() -> str | None:
    """The release line of ``nvcc --version`` ("Cuda compilation tools,
    release 12.4, V12.4.131"), or None where no nvcc is found (then nothing
    runs)."""
    try:
        nvcc = _nvcc()
    except RuntimeError:
        return None
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout
    lines = [line.strip() for line in out.splitlines() if "release" in line]
    return lines[0] if lines else out.strip()


def library_path(directory: str | None = None) -> str:
    """The library's path in ``directory`` (default: ``build_dir()``), keyed
    by the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(directory or _dir,
                        f"libtyleri_kernels_{h.hexdigest()[:16]}.so")


def report_path(lib_path: str | None = None) -> str:
    """ptxas's report of the library's build."""
    return (lib_path or library_path())[:-len(".so")] + ".ptxas.txt"


def build() -> str:
    """Compile the kernels if this source hash has no library yet.  Processes
    that call it together (the ranks of a mesh) build once: the first takes
    an exclusive lock on the build directory, the others wait for it and
    find the library.  The operating system releases the lock (``flock``)
    when its holder exits, so a build that was cut off leaves none behind."""
    global compiles
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            compiles += 1
            _compile(out)
    return out


def _compile(out: str) -> None:
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
        i, i,                     # draw mask: keep draw % n == i
        f, f, f, f, f, f,         # viewport
        i, i, i, i,               # scissor
        i, i, i, i,               # tile shifts, grid dims
        i, i,                     # cull, ccw_front
        p, p, p, p, p,            # channels, valid, tile_lo, tile_hi, crossed
        p,                        # crossings (i32, zeroed)
        p,                        # stream
    ]
    lib.ty_rasterize_visibility.restype = i
    lib.ty_rasterize_visibility.argtypes = [
        p, p, p, p, p, i,         # tile_start, entries, broad ch/tiles, nbroad, B
        p,                        # depth0
        i, i, i, i, i, i,         # fb_w, fb_h, tile_w, tile_h, grid_w, grid_h
        i, i, i, i,               # scissor
        i, i, i, i,               # owner_base, chunk, le, d16
        i, i,                     # threads, pixels a thread (k3_launch)
        p, p, p, p, p, p, p,      # owner, z, order, uw, vw, iw, tex
        p, p, p, p, p, p, p,      # layer 2 of the same (peel2), or null
        p,                        # nvis (counts), or null
        p,                        # tile order (scratch, i32 [ntiles])
        p,                        # stream
    ]
    lib.ty_raster_exact.restype = i
    lib.ty_raster_exact.argtypes = [
        p, p, p, i,               # channels, draw regions, vertex-color
                                  # planes (or null), T
        p, p, p, p, i,            # texel quads, texture offsets, widths,
                                  # heights, slots
        p, p, i, i,               # color, depth (in place), fb_w, fb_h
        i, i, i,                  # compare, depth write, d16
        i, i, i, i, i, i, i,      # blend: enable, src/dst color factor,
                                  # color op, src/dst alpha factor, alpha op
        i,                        # write mask bits
        p,                        # stream
    ]
    ll = ctypes.c_longlong
    lib.ty_binning_emit.restype = i
    lib.ty_binning_emit.argtypes = [
        p, p, ll,                 # key, opA, their rows
        p, p, i,                  # segment starts (host, nseg + 1), covers
                                  # (host), nseg
        i, i, ll,                 # grid_w, ntiles, T - 1
        p, p, p,                  # key2, tri, placed counts
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
        i, i, i,                  # tile_h, threads, pixels a thread
                                  # (p3_launch)
        i, i, i, i, i, i, i,      # unroll, lex, exit, strip, hoist,
                                  # e2_stored, packed
        *maps, p,                 # owner, z, order, uw, vw, iw, tex; nres
        p,                        # tile order (scratch, i32 [ntiles])
        p,                        # stream
    ]
    lib.ty_probe_mxu_smem.restype = ctypes.c_longlong
    lib.ty_probe_mxu_smem.argtypes = [i, i, i, i, i, i]
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
    """The kernel library, built on first call.  A library this process did
    not build (a pipeline cache's seed) that fails to load is deleted and
    built again, which ``compiles`` counts; one it built that fails raises."""
    global _lib, loaded_path
    with _lock:
        if _lib is None:
            before = compiles
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                if compiles != before:
                    raise
                os.remove(path)
                path = build()
                lib = ctypes.CDLL(path)
            _bind(lib)
            _lib, loaded_path = lib, path
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
