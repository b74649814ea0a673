"""The port stands alone: it imports no JAX, picks no device silently and
leaves the kernels alone on the CPU.

The isolation check runs in a subprocess: this test process has JAX loaded
already (the repository's root conftest imports it).
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAME = textwrap.dedent("""
    import sys
    import tyleri_tpu_torch as tt
    from tyleri_tpu.models import scenes
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda

    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = scenes.config1_triangle(dev, (64, 64))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    rig.fill(win.get_render_scene(), 0.0)
    win.render()
    img = win.flush()
    assert img.shape == (64, 64, 4) and img[32, 32, 0] == 255, img[32, 32]
    assert (setup_cuda.launches, raster_cuda.launches()) == (0, 0)
    jax_modules = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    assert not jax_modules, jax_modules[:5]
    print("ok")
""")


def test_cpu_frame_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", FRAME], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_package_sources_never_import_jax():
    jax_import = re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)", re.M)
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "tyleri_tpu_torch")):
        sources += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            assert not jax_import.search(f.read()), path


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where the JAX package is not installed: it reaches
    the reused numpy-only modules through tyleri_tpu_torch."""
    imports = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        names = set(imports.findall(f.read()))
    ours = {n for n in names if n.split(".")[0].startswith("tyleri")}
    assert ours and all(n.split(".")[0] == "tyleri_tpu_torch" for n in ours), \
        ours


def test_builder_without_cuda_raises():
    from tyleri_tpu_torch.device.builders import (
        DeviceSelectionError,
        RenderDeviceBuilder,
    )

    if torch.cuda.is_available():
        assert RenderDeviceBuilder().build().device.type == "cuda"
        return
    with pytest.raises(DeviceSelectionError):
        RenderDeviceBuilder().build()
    assert RenderDeviceBuilder().device("cpu").build().device.type == "cpu"


def test_cpu_tensors_never_launch_kernels():
    """The wrappers route CPU tensors to the plain versions; the launch
    counters (which count kernel launches only) stay at zero."""
    from tyleri_tpu.models import scenes
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda

    setup_cuda.reset_launches()
    raster_cuda.reset_launches()
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = scenes.config2_cube(dev, (48, 32))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    for f in range(3):
        rig.fill(win.get_render_scene(), 0.4 * f)
        win.render()
    win.flush()
    assert (setup_cuda.launches, raster_cuda.launches()) == (0, 0)


@pytest.mark.parametrize("what", ["exact", "ui", "mesh"])
def test_unported_paths_raise(what):
    """Each path left for a later port says so instead of rendering
    something else."""
    import numpy as np

    import tyleri_tpu_torch as tt
    from tyleri_tpu.models import scenes

    dev = tt.RenderDeviceBuilder().device("cpu").build()
    kw = {"exact": dict(exact=True),
          "mesh": dict(device_mesh=object())}.get(what, {})
    if kw:
        with pytest.raises(NotImplementedError):
            tt.RenderWindow(dev, resolution=(32, 32), **kw)
        return
    rig = scenes.config1_triangle(dev, (32, 32))
    win = tt.RenderWindow(dev, resolution=(32, 32), present_mode="immediate")
    scene = win.get_render_scene()
    rig.fill(scene, 0.0)
    (tex,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    v = np.zeros((3, 8), np.float32)
    v[:, :2] = [[0, 0], [8, 0], [0, 8]]
    scene.add_ui([(v, np.arange(3, dtype=np.uint32), tex)])
    with pytest.raises(NotImplementedError):
        win.render()
