"""The port stands alone: it imports no JAX and nothing of the JAX
package, picks no device silently and leaves the kernels alone on the CPU.

The isolation check runs in a subprocess: this test process has JAX and the
JAX package loaded already (the repository's root conftest imports them).
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
    from tyleri_tpu_torch import _build

    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config1_triangle(dev, (64, 64))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    rig.fill(win.get_render_scene(), 0.0)
    win.render()
    img = win.flush()
    assert img.shape == (64, 64, 4) and img[32, 32, 0] == 255, img[32, 32]
    # the lit path (config 3)
    rig = tt.scenes.config3_suzanne(dev, (48, 48))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    rig.fill(win.get_render_scene(), 0.3)
    win.render()
    assert win.rendering_function.plan.lit and win.flush()[..., :3].any()
    # a UI overlay over config 1, and config 2 in exact mode
    rig = tt.scenes.config1_triangle(dev, (64, 64))
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    scene = win.get_render_scene()
    rig.fill(scene, 0.0)
    scene.add_ui([([((4, 4), (0, 0), (0, 1, 0, 1)),
                    ((28, 4), (1, 0), (0, 1, 0, 1)),
                    ((28, 16), (1, 1), (0, 1, 0, 1))], [0, 1, 2], white)])
    win.render()
    img = win.flush()
    assert win.rendering_function.plan.has_ui and img[6, 20, 1] == 255
    rig = tt.scenes.config2_cube(dev, (48, 32))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate", blend_parity="exact")
    rig.fill(win.get_render_scene(), 0.9)
    win.render()
    assert win.rendering_function.plan.raster.exact and win.flush()[..., :3].any()
    assert not _build.launches
    # every probe tool
    import importlib, pkgutil
    import tyleri_tpu_torch.tools as tools
    names = [m.name for m in pkgutil.iter_modules(tools.__path__)
             if m.name.startswith("exp_")]
    assert len(names) == 7, names
    for name in names:
        importlib.import_module(f"tyleri_tpu_torch.tools.{name}")
    # multi-device rendering, the frame profiler and the card's smoke script
    import tyleri_tpu_torch.parallel.sharding
    import tyleri_tpu_torch.testing.profile_frame
    import chip_smoke
    jax_modules = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    assert not jax_modules, jax_modules[:5]
    ours = [m for m in sys.modules
            if m == "tyleri_tpu" or m.startswith("tyleri_tpu.")]
    assert not ours, ours[:5]
    print("ok")
""")


def test_cpu_frame_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", FRAME], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def port_sources():
    """Every module of the port (parallel/ included), chip_smoke.py and the
    rank worker of tests/test_torch_parallel.py, which must run where the
    JAX package is not installed."""
    sources = [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "tests", "torch_mesh_worker.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "tyleri_tpu_torch")):
        sources += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert os.path.join(ROOT, "tyleri_tpu_torch", "parallel",
                        "sharding.py") in sources
    return sources


def test_package_sources_never_import_jax():
    jax_import = re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)", re.M)
    for path in port_sources():
        with open(path) as f:
            assert not jax_import.search(f.read()), path


def test_sources_never_import_the_jax_package():
    """No module of the port, not chip_smoke.py and not the mesh tests'
    rank worker imports ``tyleri_tpu`` or a module of it, by statement or by
    a module string handed to importlib."""
    statement = re.compile(
        r"^\s*(?:import|from)\s+tyleri_tpu(?:\.[\w.]+)?(?:\s|,|$)", re.M)
    string = re.compile(r"[\"']tyleri_tpu(?:\.[\w.]*)?[\"']")
    sources = port_sources()
    assert len(sources) > 40
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not statement.search(text), (path, statement.search(text))
        assert not string.search(text), (path, string.search(text))


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where the JAX package is not installed: it reaches
    the port's copies of the numpy-only modules through tyleri_tpu_torch."""
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
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch import _build

    _build.reset_launches()
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config2_cube(dev, (48, 32))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    for f in range(3):
        rig.fill(win.get_render_scene(), 0.4 * f)
        win.render()
    win.flush()
    assert not _build.launches


@pytest.mark.parametrize("what", ["mesh", "greater_on_visibility"])
def test_unported_paths_raise(what):
    """What the port does not render says so instead of rendering
    something else: a device mesh that is not a (draws, tiles) DeviceMesh,
    and GREATER on the visibility path (the reference's own refusal; exact
    mode renders it)."""
    import dataclasses

    import tyleri_tpu_torch as tt

    dev = tt.RenderDeviceBuilder().device("cpu").build()
    if what == "mesh":
        with pytest.raises(TypeError):
            tt.RenderWindow(dev, resolution=(32, 32), device_mesh=object())
        return
    rig = tt.scenes.config1_triangle(dev, (32, 32))
    for exact in (False, True):
        win = tt.RenderWindow(dev, resolution=(32, 32),
                              present_mode="immediate", exact=exact)
        rf = win.rendering_function
        rf.mesh_state = dataclasses.replace(
            rf.mesh_state, depth=dataclasses.replace(
                rf.mesh_state.depth, compare_op=tt.CompareOp.GREATER))
        rig.fill(win.get_render_scene(), 0.0)
        if not exact:
            with pytest.raises(NotImplementedError):
                win.render()
            continue
        win.render()
        # nothing is nearer than the cleared depth: GREATER draws nothing
        assert not win.flush()[..., :3].any()
