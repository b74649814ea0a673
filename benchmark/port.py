"""The system under test: tyleri_tpu_torch's public API, driven as an
application drives it.  The benchmark's scene data is uploaded through the
render device, each frame is filled into the window's scene and rendered
by ``RenderWindow.render()``, and frames come back through the window's
present target.  Nothing else of the program is used here, apart from the
module attributes the stage files name (``tracing.py``)."""

from __future__ import annotations

import numpy as np


def build_device(device_type: str, messages: list):
    import tyleri_tpu_torch as tt

    builder = (tt.RenderDeviceBuilder()
               .validation_level(tt.ValidationLevel.ERROR)
               .debug_callback(messages.append))
    if device_type != "cuda":
        builder = builder.device(device_type)
    return builder.build()


def _fill_writer(a):
    return lambda buf: buf.__setitem__(slice(None), a)


class Uploaded:
    """A scene (and overlay) uploaded to a render device: arena handles of
    every mesh and texture."""

    def __init__(self, device, scene, overlay=None):
        self.scene = scene
        self.meshes = []
        for m in scene.meshes:
            aos = np.concatenate([m.positions, m.uvs], axis=1).astype(
                np.float32)
            (v,) = device.create_vertices([(len(aos), _fill_writer(aos))])
            (i,) = device.create_indices([(len(m.indices),
                                           _fill_writer(m.indices))])
            self.meshes.append((v, i))
        self.textures = device.create_textures(
            [((t.shape[1], t.shape[0]), _fill_writer(t))
             for t in scene.textures])
        self.ui = []
        if overlay is not None:
            ui_tex = device.create_textures(
                [((t.shape[1], t.shape[0]), _fill_writer(t))
                 for t in overlay.textures])
            self.ui = [(v, i, ui_tex[k]) for v, i, k in overlay.elements]
        self.scale_factor = overlay.scale_factor if overlay else 1.0

    def fill(self, render_scene, t: float, with_ui: bool = True) -> None:
        """The application's per-frame scene assembly for frame time t."""
        from tyleri_tpu_torch.scene.camera import Camera
        from tyleri_tpu_torch.scene.mesh_renderer import MeshRenderer
        from tyleri_tpu_torch.utils.math3d import Rect2D, Viewport

        view = self.scene.frame(t)
        w, h = self.scene.resolution
        cam = Camera()
        cam.view_matrix = view.view
        cam.fov = view.fov_deg
        cam.z_near, cam.z_far = view.z_near, view.z_far
        cam.viewport = Viewport(0, 0, float(w), float(h), 0.0, 1.0)
        cam.scissor = Rect2D(0, 0, int(w), int(h))
        for d in view.draws:
            v, i = self.meshes[d.mesh]
            cam.mesh_renderers.append(
                MeshRenderer(v, i, self.textures[d.texture], d.model))
        render_scene.add_camera(cam)
        if self.ui and with_ui:
            render_scene.add_ui(self.ui)


def window(device, resolution, scale_factor, present_target):
    import tyleri_tpu_torch as tt

    return tt.RenderWindow(device, resolution=tuple(resolution),
                           scale_factor=scale_factor,
                           present_mode="immediate",
                           present_target=present_target)
