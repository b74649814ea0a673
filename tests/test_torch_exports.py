"""The port's public surface against the reference's, on the CPU.

``tyleri_tpu_torch`` exports every name of ``tyleri_tpu``'s root, and
``tyleri_tpu_torch.resource`` every name of ``tyleri_tpu.resource``, each
from the port's module under the reference's relative path and never from
the JAX package.  No name is left out (``OMITTED`` is empty).
"""

import importlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import tyleri_tpu
import tyleri_tpu.resource as jresource
import tyleri_tpu_torch as tt
import tyleri_tpu_torch.resource as tresource
from tyleri_tpu_torch.resource import arenas as tarenas
from tyleri_tpu_torch.resource.allocator import MemoryAllocator, UploadQueue

# names of the reference's surface the port does not export, with the reason
OMITTED: dict[str, str] = {}


def port_path(module: str) -> str:
    """The port's counterpart of a module path of the JAX package."""
    assert module.startswith("tyleri_tpu.")
    return "tyleri_tpu_torch." + module[len("tyleri_tpu."):]


def home(obj) -> str:
    """The module that defines a class or function, or an instance's
    class."""
    if isinstance(obj, type) or callable(obj):
        return obj.__module__
    return type(obj).__module__


def test_root_exports_cover_the_reference():
    missing = set(tyleri_tpu.__all__) - set(tt.__all__) - set(OMITTED)
    assert not missing, sorted(missing)
    assert len(tyleri_tpu.__all__) == 33


def test_resource_exports_cover_the_reference():
    missing = set(jresource.__all__) - set(tresource.__all__) - set(OMITTED)
    assert not missing, sorted(missing)
    assert len(jresource.__all__) == 13


@pytest.mark.parametrize("name", sorted(tyleri_tpu._EXPORTS))
def test_root_name_comes_from_the_ports_module(name):
    """Each root name is the object of the port's module under the
    reference's path, defined in the port."""
    got = getattr(tt, name)
    module = importlib.import_module(port_path(tyleri_tpu._EXPORTS[name]))
    assert got is getattr(module, name)
    assert home(got).startswith("tyleri_tpu_torch."), home(got)
    assert name in dir(tt)


@pytest.mark.parametrize("name", sorted(jresource.__all__))
def test_resource_name_comes_from_the_port(name):
    got = getattr(tresource, name)
    want = getattr(jresource, name)
    if isinstance(want, int):   # the init sizes: the same values
        assert got == want
        assert name in vars(importlib.import_module(
            "tyleri_tpu_torch.resource.allocator"))
    else:
        assert home(got).startswith("tyleri_tpu_torch.resource."), home(got)
        assert got.__name__ == want.__name__


def test_resource_handle_aliases():
    assert tresource.StaticVertices is tresource.BindlessBuffer
    assert tresource.StaticIndices is tresource.BindlessBuffer


def test_the_applications_names_import_from_the_root():
    from tyleri_tpu_torch import Camera, MeshRenderer, Vertex

    assert Camera.__module__ == "tyleri_tpu_torch.scene.camera"
    assert MeshRenderer.__module__ == "tyleri_tpu_torch.scene.mesh_renderer"
    assert Vertex.__module__ == "tyleri_tpu_torch.api.vertex"
    with pytest.raises(AttributeError):
        tt.NoSuchName   # noqa: B018


def test_importing_the_root_imports_no_module():
    """The exports resolve lazily: importing the package imports neither
    torch nor any of its modules, so it touches no CUDA."""
    code = ("import sys, tyleri_tpu_torch; "
            "print(sorted(m for m in sys.modules if m == 'torch' "
            "or m.startswith('tyleri_tpu_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def geometry_arena(seed=3):
    """A vertex arena with two blocks written from a seed."""
    rng = np.random.default_rng(seed)
    alloc = MemoryAllocator()
    arena = alloc.static_vertices_buffer
    for n in (5, 9):
        pos = rng.standard_normal((n, 3)).astype(np.float32)

        def write(p, uv, nrm, pos=pos):
            p[:] = pos
        arena.allocate([(n, write)])
    return alloc, arena


def test_upload_queue_flushes_as_device_arrays():
    alloc, arena = geometry_arena()
    q = UploadQueue(torch.device("cpu"))
    (got,) = q.flush(arena)
    want = tarenas.device_arrays(arena, torch.device("cpu"))
    assert sorted(got) == sorted(want) == sorted(arena.fields)
    for name in want:
        assert got[name].device.type == "cpu"
        assert torch.equal(got[name], want[name])
    v, i = q.flush(alloc.static_vertices_buffer, alloc.static_indices_buffer)
    assert v["pos"] is want["pos"]   # clean: the same snapshot
    assert i["idx"].dtype == torch.int64


def test_upload_queue_device():
    """CUDA unless the caller names another device (no CUDA is touched to
    make the queue); a render device's allocator flushes to its device."""
    assert UploadQueue().device == torch.device("cuda")
    assert UploadQueue("cpu").device == torch.device("cpu")
    assert MemoryAllocator().upload_queue.device == torch.device("cuda")
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    assert dev.memory_allocator.upload_queue.device == torch.device("cpu")


def test_upload_queue_serializes_flushes():
    """A flush waits while another holds the queue."""
    _, arena = geometry_arena()
    q = UploadQueue("cpu")
    done = threading.Event()
    with q._lock:
        worker = threading.Thread(target=lambda: (q.flush(arena), done.set()))
        worker.start()
        assert not done.wait(0.2)
    worker.join(10)
    assert done.is_set()
