"""The port's copies of the JAX package's numpy-only modules against their
originals, on the CPU.

The port imports nothing of ``tyleri_tpu``: it keeps its own copies of the
pipeline state, scenes, models, oracle, math, arenas and native runtime.
These tests hold each copy to its original on the same inputs, so the two
cannot drift apart unnoticed; the port's enums are its own, and a lookup
keyed by one raises on the JAX package's member of the same name.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from tyleri_tpu.device import render_device as jax_render_device
from tyleri_tpu.models import scenes as jscenes
from tyleri_tpu.pipeline import state as jstate
from tyleri_tpu.resource import arenas as jarenas
from tyleri_tpu.scene import camera as jcamera
from tyleri_tpu.scene import light as jlight
from tyleri_tpu.scene import mesh_renderer as jmesh_renderer
from tyleri_tpu.scene import render_scene as jrender_scene
from tyleri_tpu.scene import ui as jui
from tyleri_tpu.testing import oracle as joracle
from tyleri_tpu.utils import math3d as jmath3d
import tyleri_tpu_torch as tt
from tyleri_tpu_torch import interop, native
from tyleri_tpu_torch.models import scenes as tscenes
from tyleri_tpu_torch.ops import depth as tdepth
from tyleri_tpu_torch.ops import setup as tsetup
from tyleri_tpu_torch.ops import visibility as tvis
from tyleri_tpu_torch.pipeline import state as tstate
from tyleri_tpu_torch.resource import arenas as tarenas
from tyleri_tpu_torch.testing import oracle as toracle
from tyleri_tpu_torch.utils import math3d as tmath3d

JAX_CLASSES = {
    **interop.classes_of(jstate, jcamera, jlight, jmesh_renderer,
                         jrender_scene, jui, jmath3d),
    "VariableLengthBuffer": jarenas.VariableLengthBuffer,
}

ENUMS = sorted(n for n, c in vars(jstate).items()
               if isinstance(c, type) and issubclass(c, enum.Enum)
               and c.__module__ == jstate.__name__)


@pytest.mark.parametrize("name", ENUMS)
def test_state_enums_have_the_same_members(name):
    ours, theirs = getattr(tstate, name), getattr(jstate, name)
    assert ours is not theirs
    assert [(m.name, m.value) for m in ours] == \
        [(m.name, m.value) for m in theirs]
    # identity differs: a member of one is no key of the other
    for m in theirs:
        assert m != ours[m.name]


@pytest.mark.parametrize("name", ["MESH_PIPELINE_STATE", "UI_PIPELINE_STATE",
                                  "UI_PIPELINE_STATE_PREMULTIPLIED_ALPHA"])
def test_pipeline_states_convert_to_the_copies(name):
    """The copies' pipeline states equal the originals rebuilt with the
    port's classes, and convert back to them."""
    ours, theirs = getattr(tstate, name), getattr(jstate, name)
    assert interop.from_jax(theirs) == ours
    assert interop.convert(ours, JAX_CLASSES) == theirs
    assert ours != theirs


def test_lookups_raise_on_the_jax_packages_members():
    """Every enum-keyed lookup of the port raises on a JAX member instead of
    taking a default branch."""
    jds = jstate.MESH_PIPELINE_STATE.depth
    with pytest.raises(ValueError):
        tvis.k3_supports(jds)
    with pytest.raises(ValueError):
        tvis.k3_supports(tstate.DepthState(compare_op=jds.compare_op))
    with pytest.raises(ValueError):
        tvis.depth_flags(dataclasses.replace(
            tstate.MESH_PIPELINE_STATE.depth, format=jds.format))
    with pytest.raises(ValueError):
        tdepth.quantize_depth(torch.zeros(4), jstate.DepthFormat.D32_SFLOAT)
    with pytest.raises(ValueError):
        tsetup.cull_keep_mask(torch.ones(4), jstate.CullMode.NONE, None)
    with pytest.raises(ValueError):
        tsetup.cull_keep_mask(torch.ones(4), tstate.CullMode.BACK,
                              jstate.FrontFace.COUNTER_CLOCKWISE)
    with pytest.raises(ValueError):
        toracle.quantize_depth(np.zeros(4), jstate.DepthFormat.D16_UNORM)


def test_scene_converts_and_round_trips():
    """A JAX RenderScene rebuilt with the port's classes (cameras, their
    meshes, lights, viewports) holds the same values, shares the arena
    handles, and converts back."""
    jdev = jax_render_device.RenderDevice(None, queue_pool_size=1)
    rig = jscenes.config3_suzanne(jdev, (48, 40))
    scene = jrender_scene.RenderScene()
    rig.fill(scene, 0.3)
    ours = interop.from_jax(scene)
    assert isinstance(ours, tt.RenderScene)
    (jcam,), (tcam,) = (scene.render_resources.cameras,
                        ours.render_resources.cameras)
    assert type(tcam).__module__ == "tyleri_tpu_torch.scene.camera"
    assert type(tcam.light).__module__ == "tyleri_tpu_torch.scene.light"
    np.testing.assert_array_equal(tcam.get_projection_matrix(),
                                  jcam.get_projection_matrix())
    np.testing.assert_array_equal(tcam.light.as_array(), jcam.light.as_array())
    assert (tcam.viewport.width, tcam.scissor.height) == (48, 40)
    for tm, jm in zip(tcam.mesh_renderers, jcam.mesh_renderers):
        assert type(tm).__module__ == "tyleri_tpu_torch.scene.mesh_renderer"
        assert tm.vertices is jm.vertices and tm.texture is jm.texture
        np.testing.assert_array_equal(tm.model, jm.model)
    back = interop.convert(ours, JAX_CLASSES)
    assert isinstance(back, jrender_scene.RenderScene)
    (bcam,) = back.render_resources.cameras
    assert bcam.viewport == jcam.viewport and bcam.light == jcam.light
    with pytest.raises(ValueError):
        interop.convert(jstate.CompareOp.LESS, {})


def small_configs():
    return {
        "config1": lambda m, d: m.config1_triangle(d, (32, 32)),
        "config2": lambda m, d: m.config2_cube(d, (48, 32)),
        "config3": lambda m, d: m.config3_suzanne(d, (48, 40)),
        "config4": lambda m, d: m.config4_instances(d, (64, 36),
                                                    n_instances=12),
        "config5": lambda m, d: m.config5_sponza(d, (80, 48), grid_n=16),
    }


@pytest.mark.parametrize("name", sorted(small_configs()))
def test_scenes_build_the_same_arrays(name):
    """The port's scenes module uploads the same vertex, index and texel
    arrays as the JAX package's, and fills the same cameras."""
    make = small_configs()[name]
    jdev = jax_render_device.RenderDevice(None, queue_pool_size=1)
    tdev = tt.RenderDeviceBuilder().device("cpu").build()
    jrig, trig = make(jscenes, jdev), make(tscenes, tdev)
    assert (jrig.resolution, jrig.triangle_count) == \
        (trig.resolution, trig.triangle_count)
    ja, ta = jdev.memory_allocator, tdev.memory_allocator
    for field in ("pos", "uv", "nrm"):
        np.testing.assert_array_equal(
            ta.static_vertices_buffer.staging(field),
            ja.static_vertices_buffer.staging(field))
    np.testing.assert_array_equal(ta.static_indices_buffer.staging("idx"),
                                  ja.static_indices_buffer.staging("idx"))
    jt, tt_ = ja.texture_arena, ta.texture_arena
    np.testing.assert_array_equal(tt_._texels, jt._texels)
    assert (tt_._offsets, tt_._widths, tt_._heights) == \
        (jt._offsets, jt._widths, jt._heights)
    js, ts = jrender_scene.RenderScene(), tt.RenderScene()
    jrig.fill(js, 0.7)
    trig.fill(ts, 0.7)
    for jc, tc in zip(js.render_resources.cameras, ts.render_resources.cameras,
                      strict=True):
        np.testing.assert_array_equal(tc.view_matrix, jc.view_matrix)
        np.testing.assert_array_equal(tc.get_projection_matrix(),
                                      jc.get_projection_matrix())
        assert interop.convert(tc.viewport, JAX_CLASSES) == jc.viewport
        assert (tc.light is None) == (jc.light is None)
        for tm, jm in zip(tc.mesh_renderers, jc.mesh_renderers, strict=True):
            np.testing.assert_array_equal(tm.model, jm.model)
            assert (tm.vertices.offset, tm.indices.offset, tm.indices.len,
                    tm.texture.slot) == (jm.vertices.offset,
                                         jm.indices.offset, jm.indices.len,
                                         jm.texture.slot)


ORACLE_CASES = {
    # (config, state change, lit)
    "mesh": ("config2", {}, False),
    "lit": ("config3", {}, True),
    "cull_back_d32": ("config2", dict(
        raster=jstate.RasterState(cull_mode=jstate.CullMode.BACK),
        depth=jstate.DepthState(format=jstate.DepthFormat.D32_SFLOAT)),
        False),
    "ui_blend_not_equal": ("config4", dict(
        blend=jstate.UI_PIPELINE_STATE.blend,
        depth=jstate.DepthState(compare_op=jstate.CompareOp.NOT_EQUAL)),
        False),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_gives_the_same_image(case):
    """The oracle copy rasterizes a small scene to the same color and depth
    as the original, each with its own package's state."""
    name, change, lit = ORACLE_CASES[case]
    jdev = jax_render_device.RenderDevice(None, queue_pool_size=1)
    rig = small_configs()[name](jscenes, jdev)
    scene = jrender_scene.RenderScene()
    rig.fill(scene, 0.4)
    alloc = jdev.memory_allocator
    pos = alloc.static_vertices_buffer.staging("pos")
    nrm = alloc.static_vertices_buffer.staging("nrm")
    uvs = alloc.static_vertices_buffer.staging("uv")
    idx = alloc.static_indices_buffer.staging("idx")
    W, H = rig.resolution
    jstate_ = dataclasses.replace(jstate.MESH_PIPELINE_STATE, **change)
    out = {}
    for pkg, st in (("jax", jstate_), ("port", interop.from_jax(jstate_))):
        o = joracle if pkg == "jax" else toracle
        color = np.zeros((H, W, 4))
        depth = np.ones((H, W))
        for cam in scene.render_resources.cameras:
            cam = cam if pkg == "jax" else interop.from_jax(cam)
            vp = (np.asarray(cam.get_projection_matrix(), np.float64)
                  @ np.asarray(cam.view_matrix, np.float64))
            for mesh in cam.mesh_renderers:
                i = idx[mesh.indices.offset:mesh.indices.offset
                        + mesh.indices.len].astype(np.int64)
                i = i + mesh.vertices.offset
                model = np.asarray(mesh.model, np.float64)
                kw = {}
                if lit:
                    kw = dict(normals=nrm[i.reshape(-1, 3)] @ np.linalg.inv(
                        model[:3, :3]), light=cam.light,
                        inv_vp=np.linalg.inv(vp), eye=cam.eye_position())
                o.rasterize(color, depth,
                            o.make_mesh_clip(pos, i, vp @ model),
                            uvs[i.reshape(-1, 3)], st, cam.viewport,
                            cam.scissor, **kw)
        out[pkg] = (color, depth)
    assert (out["jax"][1] < 1).any()
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])


@pytest.mark.skipif(not native.available(),
                    reason=f"native build failed: {native.build_error()}")
def test_native_allocator_copy_matches_python_and_the_original():
    """The copied C++ allocator answers as the python free-list and as the
    JAX package's allocator on the same random sequence."""
    from tyleri_tpu import native as jnative

    rng = np.random.default_rng(11)
    allocs = [tarenas.BlockBasedAllocator(1 << 10),
              native.NativeBlockAllocator(1 << 10),
              jarenas.BlockBasedAllocator(1 << 10)]
    errors = (tarenas.AllocationError, jarenas.AllocationError)
    if jnative.available():
        allocs.append(jnative.NativeBlockAllocator(1 << 10))
    live = []
    for step in range(400):
        if live and rng.random() < 0.45:
            off, sz = live.pop(rng.integers(len(live)))
            for a in allocs:
                a.free(off, sz)
            continue
        sz = int(rng.integers(1, 48))
        got = []
        for a in allocs:
            try:
                got.append(a.allocate(sz))
            except errors:
                got.append(None)
        assert len(set(got)) == 1, f"step {step}: {got}"
        if got[0] is not None:
            live.append((got[0], sz))
    assert native.BUILD_DIR.endswith("build/tyleri_tpu_torch")


def test_math3d_copy_matches():
    eye = np.asarray([0.5, 1.0, 3.0])
    for fn in (lambda m: m.perspective_rh(0.8, 1.7, 0.1, 50.0),
               lambda m: m.look_at_rh(eye, [0, 0, 0], [0, 1, 0]),
               lambda m: m.compose(m.translation([1, 2, 3]),
                                   m.rotation_y(0.4), m.scale([2, 2, 2]))):
        np.testing.assert_array_equal(fn(tmath3d), fn(jmath3d))


@pytest.mark.parametrize("module,cls", [("common_pipeline", "CommonPipeline"),
                                        ("ui_pipeline", "UIPipeline")])
def test_pipeline_objects_match(module, cls):
    """The copies of the pipeline objects carry the originals' state and
    push-constant size."""
    import importlib

    jmod = importlib.import_module(f"tyleri_tpu.pipeline.{module}")
    tmod = importlib.import_module(f"tyleri_tpu_torch.pipeline.{module}")
    ours, theirs = getattr(tmod, cls)(), getattr(jmod, cls)()
    assert interop.from_jax(theirs.state) == ours.state
    assert ours.push_constant_bytes == theirs.push_constant_bytes == \
        tmod.PUSH_CONSTANT_BYTES
