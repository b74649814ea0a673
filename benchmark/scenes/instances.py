"""BASELINE config 4 (the renderer's ``config4_instances``): cubes and UV
spheres alternating on a jittered grid, each spinning about y, three
textures in turn, a fixed camera.  The seed picks the offsets and the spin
rates."""

from __future__ import annotations

import numpy as np

from benchmark import math3d
from benchmark.scene import Draw, Mesh, Scene, View
from benchmark.scenes import primitives as prim


def build(params: dict, seed: int) -> Scene:
    n = params["instances"]
    meshes = [Mesh(*prim.cube(params["cube_size"])),
              Mesh(*prim.uv_sphere(*params["sphere"]))]
    t = params["texture"]
    textures = [prim.checkerboard(t, 4), prim.gradient(t),
                prim.checkerboard(t, 8, (1, 0.6, 0.2, 1), (0.1, 0.2, 0.8, 1))]
    rng = np.random.default_rng(seed)
    grid = int(np.ceil(np.sqrt(n)))
    sp = params["spacing"]
    offsets = [((ix - grid / 2) * sp + rng.uniform(-0.2, 0.2),
                rng.uniform(-1.0, 1.0),
                (iz - grid / 2) * sp + rng.uniform(-0.2, 0.2))
               for ix in range(grid) for iz in range(grid)][:n]
    spins = rng.uniform(0.2, 1.5, size=n)
    cam = params["camera"]
    view = math3d.look_at_rh(cam["eye"], [0, 0, 0])
    moves = [math3d.translation(o) for o in offsets]

    def frame(t: float) -> View:
        draws = [Draw(k % 2, k % len(textures),
                      moves[k] @ math3d.rotation_y(spins[k] * t))
                 for k in range(n)]
        return View(view, cam["fov"], cam["z_near"], cam["z_far"], draws)

    return Scene(tuple(params["resolution"]), meshes, textures, frame)
