"""The five BASELINE benchmark scene configs (BASELINE.json):

1. single flat triangle, headless 512x512
2. textured spinning cube + depth, 800x600
3. "Suzanne"-scale organic mesh (~1k tris) with per-frame camera updates
4. 100 instanced meshes, mixed textures, 1080p
5. Sponza-scale (~1M tris) heightfield city, 1080p

Each builder uploads geometry through the RenderDevice API and returns a
SceneRig: a callable that fills a RenderScene for frame t — the app-side
per-frame scene assembly of the reference (SURVEY §3.5).

The port's own copy of ``tyleri_tpu/models/scenes.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from tyleri_tpu_torch.models import primitives as prim
from tyleri_tpu_torch.scene.camera import Camera
from tyleri_tpu_torch.scene.mesh_renderer import MeshRenderer
from tyleri_tpu_torch.utils import math3d
from tyleri_tpu_torch.utils.math3d import Rect2D, Viewport


@dataclasses.dataclass
class SceneRig:
    name: str
    resolution: tuple
    triangle_count: int
    fill: Callable  # fill(scene, frame_t: float) -> None


def _upload(device, verts_aos, indices):
    (v,) = device.create_vertices(
        [(len(verts_aos), lambda buf, a=verts_aos: buf.__setitem__(slice(None), a))]
    )
    (i,) = device.create_indices(
        [(len(indices), lambda buf, a=indices: buf.__setitem__(slice(None), a))]
    )
    return v, i


def _upload_texture(device, img):
    (t,) = device.create_textures(
        [((img.shape[1], img.shape[0]),
          lambda buf, a=img: buf.__setitem__(slice(None), a))]
    )
    return t


def _camera(resolution, eye, center, fov=45.0):
    cam = Camera()
    w, h = resolution
    cam.view_matrix = np.asarray(math3d.look_at_rh(eye, center, [0, 1, 0]), np.float32)
    cam.fov = fov
    cam.viewport = Viewport(0, 0, float(w), float(h), 0.0, 1.0)
    cam.scissor = Rect2D(0, 0, int(w), int(h))
    return cam


def config1_triangle(device, resolution=(512, 512)) -> SceneRig:
    """Single textured triangle rendered headless (BASELINE config 1)."""
    verts, idx = prim.triangle(z=0.5)
    v, i = _upload(device, verts, idx)
    tex = _upload_texture(device, np.ones((1, 1, 4), np.float32))

    def fill(scene, t):
        cam = _camera(resolution, [0, 0, 2.2], [0, 0, 0])
        cam.mesh_renderers.append(MeshRenderer(v, i, tex))
        scene.add_camera(cam)

    return SceneRig("triangle_512", resolution, 1, fill)


def config2_cube(device, resolution=(800, 600)) -> SceneRig:
    """Textured spinning cube with depth (BASELINE config 2)."""
    verts, idx = prim.cube(1.2)
    v, i = _upload(device, verts, idx)
    tex = _upload_texture(device, prim.checkerboard_texture(64, 8))

    def fill(scene, t):
        cam = _camera(resolution, [0, 1.2, 2.5], [0, 0, 0])
        model = np.asarray(
            math3d.compose(math3d.rotation_y(t), math3d.rotation_x(0.4 * t)),
            np.float32,
        )
        cam.mesh_renderers.append(MeshRenderer(v, i, tex, model))
        scene.add_camera(cam)

    return SceneRig("cube_800x600", resolution, 12, fill)


def config3_suzanne(device, resolution=(800, 600)) -> SceneRig:
    """~1k-triangle organic mesh, Blinn-Phong lit, per-frame camera +
    uniform (light/model) updates (BASELINE config 3; a UV sphere stands in
    for Suzanne)."""
    from tyleri_tpu_torch.scene.light import DirectionalLight

    verts8, idx = prim.uv_sphere_lit(16, 24, 1.0)
    (v,) = device.create_lit_vertices(
        [(len(verts8), lambda buf, a=verts8: buf.__setitem__(slice(None), a))]
    )
    (i,) = device.create_indices(
        [(len(idx), lambda buf, a=idx: buf.__setitem__(slice(None), a))]
    )
    tex = _upload_texture(device, prim.gradient_texture(64))
    ntris = len(idx) // 3

    def fill(scene, t):
        eye = [2.5 * np.sin(0.3 * t), 0.8, 2.5 * np.cos(0.3 * t)]
        cam = _camera(resolution, eye, [0, 0, 0])
        model = np.asarray(math3d.rotation_y(0.7 * t), np.float32)
        cam.mesh_renderers.append(MeshRenderer(v, i, tex, model))
        # per-frame uniform update: the light orbits too
        cam.light = DirectionalLight(
            direction=(np.sin(0.5 * t), -1.0, np.cos(0.5 * t)))
        scene.add_camera(cam)

    return SceneRig("suzanne_1k_lit", resolution, ntris, fill)


def config4_instances(device, resolution=(1920, 1080), n_instances=100) -> SceneRig:
    """100 instanced meshes, mixed textures, 1080p (BASELINE config 4)."""
    cube_v, cube_i = prim.cube(0.5)
    sph_v, sph_i = prim.uv_sphere(8, 12, 0.3)
    vc, ic = _upload(device, cube_v, cube_i)
    vs, is_ = _upload(device, sph_v, sph_i)
    textures = [
        _upload_texture(device, prim.checkerboard_texture(32, 4)),
        _upload_texture(device, prim.gradient_texture(32)),
        _upload_texture(device, prim.checkerboard_texture(32, 8,
                                                          (1, 0.6, 0.2, 1),
                                                          (0.1, 0.2, 0.8, 1))),
    ]
    rng = np.random.default_rng(42)
    grid = int(np.ceil(np.sqrt(n_instances)))
    offsets = [
        (
            (ix - grid / 2) * 1.2 + rng.uniform(-0.2, 0.2),
            rng.uniform(-1.0, 1.0),
            (iz - grid / 2) * 1.2 + rng.uniform(-0.2, 0.2),
        )
        for ix in range(grid)
        for iz in range(grid)
    ][:n_instances]
    spins = rng.uniform(0.2, 1.5, size=n_instances)
    ntris = sum(
        (len(cube_i) if k % 2 == 0 else len(sph_i)) // 3 for k in range(n_instances)
    )

    def fill(scene, t):
        cam = _camera(resolution, [0, 5.0, 9.0], [0, 0, 0], fov=55.0)
        for k, (ox, oy, oz) in enumerate(offsets):
            v, i = (vc, ic) if k % 2 == 0 else (vs, is_)
            model = np.asarray(
                math3d.compose(
                    math3d.translation([ox, oy, oz]),
                    math3d.rotation_y(spins[k] * t),
                ),
                np.float32,
            )
            cam.mesh_renderers.append(
                MeshRenderer(v, i, textures[k % len(textures)], model)
            )
        scene.add_camera(cam)

    return SceneRig(f"instances_{n_instances}_1080p", resolution, ntris, fill)


def config5_sponza(device, resolution=(1920, 1080), grid_n=420) -> SceneRig:
    """Sponza-scale scene: a displaced heightfield with ~2*(n-1)^2 triangles
    (420 -> ~351k tris per grid; three stacked grids ~1.05M) at 1080p
    (BASELINE config 5)."""
    layers = []
    for li in range(3):
        verts, idx = prim.displaced_grid(grid_n, extent=14.0, seed=li)
        verts[:, 1] += (li - 1) * 2.0
        v, i = _upload(device, verts, idx)
        layers.append((v, i))
    tex = _upload_texture(device, prim.checkerboard_texture(128, 16))
    ntris = 3 * 2 * (grid_n - 1) ** 2

    def fill(scene, t):
        eye = [6.5 * np.sin(0.1 * t), 4.0, 6.5 * np.cos(0.1 * t)]
        cam = _camera(resolution, eye, [0, 0, 0], fov=60.0)
        for v, i in layers:
            cam.mesh_renderers.append(MeshRenderer(v, i, tex))
        scene.add_camera(cam)

    return SceneRig(f"sponza_{ntris // 1000}k_1080p", resolution, ntris, fill)
