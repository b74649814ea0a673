"""BASELINE config 5 (the renderer's ``config5_sponza``): three displaced
heightfield grids stacked 2 units apart, one checkerboard texture, a camera
orbiting the origin.  The grids are the configuration's, whatever the seed:
grid ``li`` takes its wave phases and frequencies from a generator seeded
with ``li``, as the renderer's scene does.  The traffic's seed picks where
the camera starts, so every seed renders the same frames in another
order."""

from __future__ import annotations

import numpy as np

from benchmark import math3d
from benchmark.scene import Draw, Mesh, Scene, View
from benchmark.scenes import primitives as prim


def build(params: dict, seed: int) -> Scene:
    n, extent = params["grid_n"], params["extent"]
    meshes = []
    for li in range(params["layers"]):
        # the frequencies of the configuration's grid li; the phases seeded
        rng = np.random.default_rng(li)
        phases = rng.uniform(0, 2 * np.pi, size=(4,))
        freqs = rng.uniform(1.0, 4.0, size=(4,))
        pos, uv, idx = prim.displaced_grid(n, extent, phases, freqs,
                                           params["amplitude"])
        pos[:, 1] += (li - (params["layers"] - 1) / 2) * params["spacing"]
        meshes.append(Mesh(pos, uv, idx))
    tex = prim.checkerboard(params["texture"], params["texture_cells"])
    cam = params["camera"]
    draws = [Draw(k, 0, np.eye(4, dtype=np.float32))
             for k in range(len(meshes))]

    def frame(t: float) -> View:
        th = cam["orbit_rate"] * t
        eye = [cam["radius"] * np.sin(th), cam["height"],
               cam["radius"] * np.cos(th)]
        return View(math3d.look_at_rh(eye, [0, 0, 0]), cam["fov"],
                    cam["z_near"], cam["z_far"], draws)

    return Scene(tuple(params["resolution"]), meshes, [tex], frame)
