"""Pipeline cache — the port's compiled libraries, kept across processes
(counterpart of ``tyleri_tpu/device/pipeline_cache.py``; ref:
src/render_device/builders.rs:85-88,321-331).

The reference seeds a VkPipelineCache from bytes so that a later run skips
its pipeline compiles; the JAX package points XLA's persistent compilation
cache at a directory.  The port compiles two libraries on first use: nvcc
builds the CUDA kernels (``_build``) and g++ the host runtime (``native``).
Both are built into, and loaded from, one directory: the cache's.
``get_data()`` packs the libraries of the current sources into bytes, and
``seed=`` unpacks such bytes into a directory, so that a new process on a
fresh machine loads the kernels without running nvcc.

The directory is process-wide, as ``jax_compilation_cache_dir`` is in the
JAX package: a cache given a directory or a seed points ``_build`` and
``native`` at it; one given neither reports the directory in use
(``build/tyleri_tpu_torch/`` unless a cache named another).  A library
already loaded stays loaded: a later seed serves later processes, as
compiled executables stay in memory in JAX.  JAX's ``min_compile_seconds``
has no counterpart: one nvcc build makes one library, kept whatever it
took.

A seed is checked entry by entry, and an entry that fails a check is left
out, a miss that is built again:

- bytes that are not a zip leave the cache disabled (``enabled`` false,
  ``error`` says why);
- an entry whose path leaves the directory is skipped;
- an entry whose sha256 is not the manifest's is skipped;
- a kernel library or its ptxas report whose manifest names other nvcc
  flags, or another toolkit release than this machine's nvcc (or where no
  nvcc is found), is skipped;
- a file of the port's (``libtyleri_*``) that the manifest does not list is
  skipped; other files are restored as they are.

Each file is written through a temporary file and ``os.replace``, so a
process that builds or loads at the same moment never sees half a library.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import zipfile

from tyleri_tpu_torch import _build, native

MANIFEST = "manifest.json"
_KERNELS = "libtyleri_kernels_"


class PipelineCache:
    def __init__(self, directory: str | None = None,
                 seed: bytes | None = None):
        if seed is not None and not directory:
            directory = tempfile.mkdtemp(prefix="tyleri-pcache-")
        self.directory = (os.path.abspath(directory) if directory
                          else _build.build_dir())
        self.enabled = False
        self.error = None
        try:
            os.makedirs(self.directory, exist_ok=True)
            if seed:
                self._unpack(seed, self.directory)
        except Exception as e:
            # the cache only saves builds; device creation never dies on it
            # (the reference's "TODO check if cache is valid",
            # builders.rs:321-331: the same fail-open policy)
            self.error = f"{type(e).__name__}: {e}"
            return
        _build.set_build_dir(self.directory)
        self.enabled = True

    @staticmethod
    def _unpack(data: bytes, directory: str) -> None:
        """Restore a ``get_data()`` archive into ``directory``, entry by
        entry as the module docstring says."""
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            manifest = _read_manifest(zf)
            kernels = _kernels_match(manifest) if any(
                os.path.basename(n).startswith(_KERNELS)
                for n in zf.namelist()) else False
            root = os.path.realpath(directory)
            for info in zf.infolist():
                if info.is_dir() or info.filename == MANIFEST:
                    continue
                dest = os.path.realpath(os.path.join(directory, info.filename))
                if not dest.startswith(root + os.sep):
                    continue
                name = os.path.relpath(dest, root)
                payload = zf.read(info)
                if not _admit(name, payload, manifest, kernels):
                    continue
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                if not os.path.exists(dest):
                    tmp = f"{dest}.{os.getpid()}.tmp"
                    with open(tmp, "wb") as out:
                        out.write(payload)
                    os.replace(tmp, dest)

    def get_data(self) -> bytes:
        """The cache as bytes (the vkGetPipelineCacheData analog): the
        kernel library of the current sources and flags, its ptxas report
        and the host runtime library, each where it exists (libraries of
        other keys are left out), and a manifest with the key, the nvcc
        flags, the toolkit's release (asked of nvcc only when the kernel
        library is there) and each file's sha256.  Hand it to
        ``RenderDeviceBuilder.pipeline_cache_data`` in a later process."""
        lib = _build.library_path(self.directory)
        files = {}
        for path in (lib, _build.report_path(lib),
                     native.library_path(self.directory)):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    files[os.path.basename(path)] = f.read()
        manifest = {
            "key": os.path.basename(lib)[len(_KERNELS):-len(".so")],
            "nvcc_flags": _build.NVCC_FLAGS,
            "toolkit": (_build.toolkit_release()
                        if os.path.basename(lib) in files else None),
            "files": {name: hashlib.sha256(payload).hexdigest()
                      for name, payload in files.items()},
        }
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr(MANIFEST, json.dumps(manifest, indent=1))
            for name, payload in files.items():
                zf.writestr(name, payload)
        return buf.getvalue()


def _read_manifest(zf: zipfile.ZipFile) -> dict:
    """The archive's manifest, or {} where it has none or it is not a JSON
    object (then only files that are not the port's are restored)."""
    try:
        manifest = json.loads(zf.read(MANIFEST))
    except (KeyError, ValueError):
        return {}
    return manifest if isinstance(manifest, dict) else {}


def _kernels_match(manifest: dict) -> bool:
    """Whether the manifest's kernel library was built with this port's
    nvcc flags by this machine's toolkit release (asks nvcc for it)."""
    if manifest.get("nvcc_flags") != _build.NVCC_FLAGS:
        return False
    toolkit = _build.toolkit_release()
    return toolkit is not None and manifest.get("toolkit") == toolkit


def _admit(name: str, payload: bytes, manifest: dict, kernels: bool) -> bool:
    """Whether an entry of a seed may be written (module docstring);
    ``kernels`` is ``_kernels_match(manifest)``."""
    listed = manifest.get("files")
    digest = listed.get(name) if isinstance(listed, dict) else None
    if digest is None:
        return not os.path.basename(name).startswith("libtyleri_")
    if hashlib.sha256(payload).hexdigest() != digest:
        return False
    return kernels or not os.path.basename(name).startswith(_KERNELS)
