"""The port's pipeline cache (``tyleri_tpu_torch/device/pipeline_cache.py``)
against the JAX package's, on the CPU: the archive format both read, the
seed's checks entry by entry, the build directory that ``_build`` and
``native`` read from the active cache, and the builder's surface.

There is no nvcc here: a kernel library is a file of stand-in bytes at
``_build.library_path()``'s name, ``_build.toolkit_release`` is patched to
name a toolkit, and ``_build._compile`` is patched to raise, so a test
fails if nvcc would run.
"""

import hashlib
import io
import json
import os
import tempfile
import zipfile

import jax
import numpy as np
import pytest
import torch

import tyleri_tpu_torch as tt
from tyleri_tpu.device.pipeline_cache import PipelineCache as JaxCache
from tyleri_tpu_torch import _build, native
from tyleri_tpu_torch.device.pipeline_cache import MANIFEST, PipelineCache
from tyleri_tpu_torch.device.render_device import RenderDevice
from tyleri_tpu_torch.testing import seeded_frame

TOOLKIT = "Cuda compilation tools, release 12.9, V12.9.86"


class NvccRan(Exception):
    pass


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Temporary directories under tmp_path, nvcc never run, and the
    process-wide build directory and the JAX package's cache settings as
    they were.  The host runtime is loaded first, from the default build
    directory: a stand-in host library is never loaded."""
    assert native.available(), native.build_error()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(_build, "toolkit_release", lambda: TOOLKIT)

    def compile_(out):
        raise NvccRan(out)

    monkeypatch.setattr(_build, "_compile", compile_)
    saved = (_build.build_dir(), jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    _build.set_build_dir(saved[0])
    jax.config.update("jax_compilation_cache_dir", saved[1])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[2])


def files_under(directory) -> dict[str, bytes]:
    out = {}
    for base, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


def built_dir(path) -> dict[str, bytes]:
    """A build directory as nvcc and g++ would leave it, with stand-in
    bytes: the kernel library, its ptxas report and the host runtime."""
    path.mkdir(exist_ok=True)
    lib = _build.library_path(str(path))
    made = {lib: b"\x7fELF kernels", _build.report_path(lib): b"ptxas -v",
            native.library_path(str(path)): b"\x7fELF host"}
    for name, payload in made.items():
        with open(name, "wb") as f:
            f.write(payload)
    return {os.path.basename(k): v for k, v in made.items()}


def archive(entries: dict[str, bytes], manifest=None) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        if manifest is not None:
            zf.writestr(MANIFEST, json.dumps(manifest))
        for name, payload in entries.items():
            zf.writestr(name, payload)
    return buf.getvalue()


def test_a_jax_blob_unpacks_in_the_port_with_the_same_entries(tmp_path):
    src = tmp_path / "jax_cache"
    src.mkdir()
    (src / "jit__frame-abc123").write_bytes(b"\x28\xb5\x2f\xfdfake-exe")
    (src / "sub").mkdir()
    (src / "sub" / "entry").write_bytes(b"nested")
    blob = JaxCache(str(src)).get_data()
    cache = PipelineCache(seed=blob)
    assert cache.enabled and cache.directory != str(src)
    assert cache.directory.startswith(str(tmp_path))
    assert files_under(cache.directory) == files_under(src)
    assert _build.build_dir() == cache.directory


def test_a_port_blob_unpacks_in_the_jax_package_with_the_same_entries(
        tmp_path):
    made = built_dir(tmp_path / "built")
    blob = PipelineCache(str(tmp_path / "built")).get_data()
    names = zipfile.ZipFile(io.BytesIO(blob)).namelist()
    assert sorted(names) == sorted([MANIFEST, *made])
    theirs = JaxCache(seed=blob)
    assert theirs.enabled
    restored = files_under(theirs.directory)
    assert sorted(restored) == sorted(names)
    assert {k: v for k, v in restored.items() if k != MANIFEST} == made
    # and back: the JAX package's export of it seeds the port
    ours = PipelineCache(seed=theirs.get_data())
    assert ours.enabled and files_under(ours.directory) == made


def test_get_data_holds_the_current_libraries_and_a_manifest(tmp_path):
    made = built_dir(tmp_path / "built")
    (tmp_path / "built" / "libtyleri_kernels_0123456789abcdef.so").write_bytes(
        b"stale")
    (tmp_path / "built" / "build.lock").write_bytes(b"")
    cache = PipelineCache(str(tmp_path / "built"))
    assert cache.enabled and _build.build_dir() == cache.directory
    with zipfile.ZipFile(io.BytesIO(cache.get_data())) as zf:
        assert zf.infolist()[0].compress_type == zipfile.ZIP_STORED
        manifest = json.loads(zf.read(MANIFEST))
        assert sorted(zf.namelist()) == sorted([MANIFEST, *made])
    lib = os.path.basename(_build.library_path())
    assert manifest["key"] == lib[len("libtyleri_kernels_"):-len(".so")]
    assert manifest["nvcc_flags"] == _build.NVCC_FLAGS
    assert manifest["toolkit"] == TOOLKIT
    assert manifest["files"] == {name: hashlib.sha256(payload).hexdigest()
                                 for name, payload in made.items()}


def test_get_data_asks_no_toolkit_without_a_kernel_library(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(_build, "toolkit_release",
                        lambda: pytest.fail("nvcc asked"))
    (tmp_path / "empty").mkdir()
    with zipfile.ZipFile(io.BytesIO(
            PipelineCache(str(tmp_path / "empty")).get_data())) as zf:
        assert zf.namelist() == [MANIFEST]
        assert json.loads(zf.read(MANIFEST))["toolkit"] is None


def test_a_corrupt_seed_leaves_the_cache_disabled():
    before = _build.build_dir()
    cache = PipelineCache(seed=b"not a zip")
    assert not cache.enabled and "BadZipFile" in cache.error
    assert _build.build_dir() == before


def test_an_entry_that_leaves_the_directory_is_skipped(tmp_path):
    blob = archive({"../escape.txt": b"out", "sub/../../escape2.txt": b"out",
                    "kept.txt": b"in"})
    cache = PipelineCache(seed=blob)
    assert cache.enabled
    assert files_under(cache.directory) == {"kept.txt": b"in"}
    assert not (tmp_path / "escape.txt").exists()
    assert not (tmp_path / "escape2.txt").exists()


def test_a_seeded_library_is_loaded_without_nvcc(tmp_path):
    """The seed's library lies at ``library_path()``'s name in the new
    directory: ``build()`` finds it, and ``_compile`` (patched to raise)
    never runs."""
    made = built_dir(tmp_path / "built")
    blob = PipelineCache(str(tmp_path / "built")).get_data()
    before = _build.compiles
    cache = PipelineCache(seed=blob)
    assert cache.enabled and cache.directory != str(tmp_path / "built")
    path = _build.build()
    assert path == _build.library_path()
    assert path.startswith(cache.directory + os.sep)
    with open(path, "rb") as f:
        assert f.read() == made[os.path.basename(path)]
    assert native.library_path().startswith(cache.directory + os.sep)
    assert os.path.exists(native.library_path())
    assert _build.compiles == before


@pytest.mark.parametrize("fault", ["toolkit", "flags", "sha256", "unlisted",
                                   "no_nvcc"])
def test_a_kernel_library_that_fails_a_check_is_not_loaded(tmp_path,
                                                           monkeypatch,
                                                           fault):
    """Another toolkit, other flags, a changed payload, a library the
    manifest does not list, or no nvcc to ask: the library is not written,
    so ``build()`` would run nvcc (a miss), and the seed's other entries
    are restored."""
    made = built_dir(tmp_path / "built")
    blob = PipelineCache(str(tmp_path / "built")).get_data()
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        manifest = json.loads(zf.read(MANIFEST))
        entries = {n: zf.read(n) for n in zf.namelist() if n != MANIFEST}
    lib = os.path.basename(_build.library_path())
    if fault == "toolkit":
        manifest["toolkit"] = "Cuda compilation tools, release 12.4, V12.4.131"
    elif fault == "flags":
        manifest["nvcc_flags"] = [f for f in manifest["nvcc_flags"]
                                  if f != "-fmad=false"]
    elif fault == "sha256":
        entries[lib] = b"\x7fELF changed"
    elif fault == "unlisted":
        del manifest["files"][lib]
    else:
        monkeypatch.setattr(_build, "toolkit_release", lambda: None)
    cache = PipelineCache(seed=archive(entries, manifest))
    assert cache.enabled
    restored = files_under(cache.directory)
    assert lib not in restored
    host = os.path.basename(native.library_path())
    assert restored[host] == made[host]
    with pytest.raises(NvccRan):
        _build.build()


def test_a_seed_without_a_manifest_restores_no_library_of_the_ports():
    blob = archive({"libtyleri_host_0123456789abcdef.so": b"\x7fELF",
                    "libtyleri_kernels_0123456789abcdef.so": b"\x7fELF",
                    "jit__other": b"kept"})
    cache = PipelineCache(seed=blob)
    assert files_under(cache.directory) == {"jit__other": b"kept"}


@pytest.mark.parametrize("this_process_built", [False, True])
def test_a_library_that_fails_to_load(tmp_path, monkeypatch,
                                      this_process_built):
    """A seeded library that ``ctypes.CDLL`` refuses is deleted and built
    again, and ``compiles`` counts the build; one this process built
    raises."""
    cache = PipelineCache(str(tmp_path / "lib"))
    built = []

    def compile_(out):
        built.append(out)
        with open(out, "wb") as f:
            f.write(b"\x7fELF rebuilt")

    def cdll(path):
        with open(path, "rb") as f:
            if f.read() != b"\x7fELF rebuilt":
                raise OSError(f"{path}: invalid ELF header")
        return object()

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_bind", lambda lib: None)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "loaded_path", None)
    before = _build.compiles
    if this_process_built:
        monkeypatch.setattr(_build, "_compile", lambda out: open(
            out, "wb").write(b"\x7fELF broken"))
        with pytest.raises(OSError):
            _build.load()
        assert _build.compiles == before + 1
        return
    with open(_build.library_path(), "wb") as f:
        f.write(b"\x7fELF seeded, truncated")
    assert _build.load() is not None
    assert built == [_build.library_path()]
    assert _build.loaded_path == _build.library_path()
    assert _build.loaded_path.startswith(cache.directory + os.sep)
    assert _build.compiles == before + 1


@pytest.mark.parametrize("seed_as", ["bytes", "path"])
def test_the_builder_takes_bytes_or_a_path(tmp_path, seed_as):
    made = built_dir(tmp_path / "built")
    data = (PipelineCache(str(tmp_path / "built")).get_data()
            if seed_as == "bytes" else tmp_path / "built")
    dev = tt.RenderDeviceBuilder().device("cpu").pipeline_cache_data(
        data).build()
    cache = dev.pipeline_cache
    assert cache.enabled and _build.build_dir() == cache.directory
    assert (cache.directory == str(tmp_path / "built")) == (seed_as == "path")
    assert files_under(cache.directory) == made
    # the CPU frame renders on the plain versions: the seeded library is
    # never loaded
    rig = tt.scenes.config1_triangle(dev, (32, 32))
    win = tt.RenderWindow(dev, resolution=(32, 32), present_mode="immediate")
    rig.fill(win.get_render_scene(), 0.0)
    win.render()
    assert win.flush()[16, 16, 0] == 255
    assert _build._lib is None


def test_a_device_without_a_seed_reports_the_build_directory(tmp_path):
    dev = RenderDevice(torch.device("cpu"))
    assert dev.pipeline_cache.enabled
    assert dev.pipeline_cache.directory == _build.build_dir()
    PipelineCache(str(tmp_path / "elsewhere"))
    assert tt.RenderDeviceBuilder().device("cpu").build().pipeline_cache \
        .directory == str(tmp_path / "elsewhere")


def test_a_seeded_process_on_the_cpu_builds_nothing():
    """``testing/seeded_frame.py`` on the CPU: a new process seeded with
    this process's host runtime loads it from its seeded directory with no
    g++ build, asks nothing of nvcc, and renders config 2 as this process
    does."""
    assert native.available(), native.build_error()
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    want = seeded_frame.render_one(dev, 2, (96, 72))
    got = seeded_frame.run(dev.pipeline_cache.get_data(), config=2,
                           resolution=(96, 72), device="cpu", timeout=240)
    assert got["enabled"] and not os.path.exists(got["directory"])
    assert (got["compiles"], got["host_compiles"]) == (0, 0), got
    assert got["library"] is None
    assert got["host_library"].startswith(got["directory"] + os.sep)
    assert got["image_sha256"] == seeded_frame.image_digest(want)
    assert np.asarray(want)[..., :3].any()
