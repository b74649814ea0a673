"""A seeded stand-in for the Stanford 3D Scanning Repository's Lucy, a
scanned statue: one closed, watertight surface about 2 units tall, of
near-uniform triangles, folded by multi-octave displacement, with one
texture mapped by a linear projection of the surface, and a camera
orbiting it.  The surface and the texture are the configuration's,
whatever the seed (their noise is drawn from the configuration's own
``shape_seed``); the traffic's seed picks where the camera starts.

The surface: a box of ``cells`` = (nx, ny, nz) square cells along x, y and
z, 2 (nx ny + ny nz + nz nx) quads and two vertices more (Euler's
V - E + F = 2 for a closed surface), each quad two triangles wound
outward; its edges and corners rounded; displaced along
the rounded box's normal by a sum of sine waves in seeded directions,
octave by octave; then swayed, twisted and scaled in x and z with the
height, as a figure's pose and profile.
"""

from __future__ import annotations

import numpy as np

from benchmark import math3d
from benchmark.scene import Draw, Mesh, Scene, View


def box_surface(cells):
    """The closed lattice surface of a box of ``cells`` = (nx, ny, nz):
    (lattice points i64 [V, 3], triangles u32 [F, 3] wound outward)."""
    n = [int(c) for c in cells]
    keys, tris, base = [], [], 0
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3        # b x c = +a
        for side in (0, n[a]):
            lat = np.empty((n[b] + 1, n[c] + 1, 3), np.int64)
            lat[..., a] = side
            lat[..., b] = np.arange(n[b] + 1)[:, None]
            lat[..., c] = np.arange(n[c] + 1)[None, :]
            keys.append(((lat[..., 0] * (n[1] + 1) + lat[..., 1])
                         * (n[2] + 1) + lat[..., 2]).reshape(-1))
            ids = base + np.arange((n[b] + 1) * (n[c] + 1)).reshape(
                n[b] + 1, n[c] + 1)
            v00, v10 = ids[:-1, :-1], ids[1:, :-1]
            v11, v01 = ids[1:, 1:], ids[:-1, 1:]
            if side:   # outward +a: counter-clockwise seen from outside
                quad = [v00, v10, v11, v00, v11, v01]
            else:
                quad = [v00, v11, v10, v00, v01, v11]
            tris.append(np.stack(quad, axis=-1).reshape(-1, 3))
            base += ids.size
    # the faces share their edge and corner points: one vertex each
    uniq, inv = np.unique(np.concatenate(keys), return_inverse=True)
    del keys
    lat = np.stack([uniq // ((n[1] + 1) * (n[2] + 1)),
                    uniq // (n[2] + 1) % (n[1] + 1),
                    uniq % (n[2] + 1)], axis=1)
    faces = inv.astype(np.uint32)[np.concatenate(tris)]
    return lat, faces


def _waves(p, spec, rng):
    """The displacement at points p f32 [V, 3]: per octave o, ``waves``
    sines of amplitude amplitude * gain^o and frequency frequency * 2^o
    along seeded unit directions, at seeded phases."""
    out = np.zeros(len(p), np.float32)
    for o in range(spec["octaves"]):
        amp = spec["amplitude"] * spec["gain"] ** o
        freq = spec["frequency"] * 2.0 ** o
        for _ in range(spec["waves"]):
            d = rng.normal(size=3)
            d = (d / np.linalg.norm(d) * freq).astype(np.float32)
            phase = np.float32(rng.uniform(0.0, 2.0 * np.pi))
            out += np.float32(amp) * np.sin(p @ d + phase)
    return out


def statue(params):
    """(positions f32 [V, 3], uvs f32 [V, 2], triangles u32 [F, 3])."""
    cells = params["cells"]
    h = params["height"] / cells[1]               # a cell's side
    lat, faces = box_surface(cells)
    half = np.asarray(cells, np.float32) * np.float32(h / 2)
    p = lat.astype(np.float32) * np.float32(h) - half
    del lat
    # round the edges and corners: the last ``band`` units of each face
    # bend onto a cylinder (a sphere at a corner) of radius 4 band / pi,
    # the angle linear in the distance, so an edge keeps its arc length
    band = np.float32(params["band"])
    core = np.clip(p, -(half - band), half - band)
    nrm = np.sign(p) * np.tan((np.abs(p - core) / band) * np.float32(
        np.pi / 4))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p = core + np.float32(4 / np.pi) * band * nrm
    del core
    rng = np.random.default_rng(params["shape_seed"])
    p += nrm * _waves(p, params["displacement"], rng)[:, None]
    del nrm
    y = p[:, 1]
    pose = params["pose"]
    # the profile, a sway and a twist with the height
    s = np.ones_like(y)
    for amp, freq in pose["profile"]:
        s += np.float32(amp) * np.sin(np.float32(freq) * y
                                      + np.float32(rng.uniform(0, 6.3)))
    p[:, 0] *= s
    p[:, 2] *= s
    amp, freq = pose["sway"]
    p[:, 0] += np.float32(amp) * np.sin(np.float32(freq) * y
                                        + np.float32(rng.uniform(0, 6.3)))
    a = np.float32(pose["twist"]) * y
    x, z = p[:, 0].copy(), p[:, 2].copy()
    p[:, 0] = np.cos(a) * x - np.sin(a) * z
    p[:, 2] = np.sin(a) * x + np.cos(a) * z
    # uvs: a linear projection of the surface (no seam), about the origin
    k = np.float32(params["uv_scale"])
    c = np.float32(np.sqrt(0.5))
    uv = np.stack([(p[:, 0] + p[:, 2]) * c * k,
                   (p[:, 1] + (p[:, 0] - p[:, 2]) * c * 0.5) * k], axis=1)
    return p.astype(np.float32), uv.astype(np.float32), faces


def stone(n: int, spec, rng) -> np.ndarray:
    """A seeded n x n RGBA texture: smooth value noise (random grids of
    ``cells`` cells each, smoothstep-interpolated, weighted by ``weights``)
    between two stone tints."""
    x = np.linspace(0.0, 1.0, n)
    acc = np.zeros((n, n))
    for g, w in zip(spec["cells"], spec["weights"]):
        grid = rng.random((g + 1, g + 1))
        t = x * g
        i0 = np.minimum(np.floor(t).astype(int), g - 1)
        f = t - i0
        f = f * f * (3.0 - 2.0 * f)
        m = np.zeros((n, g + 1))
        m[np.arange(n), i0] = 1.0 - f
        m[np.arange(n), i0 + 1] = f
        acc += w * (m @ grid @ m.T)
    acc = (acc - acc.min()) / (acc.max() - acc.min())
    a, b = (np.asarray(c, np.float64) for c in spec["tints"])
    rgb = a + acc[..., None] * (b - a)
    return np.concatenate([rgb, np.ones((n, n, 1))], axis=-1).astype(
        np.float32)


def build(params: dict, seed: int) -> Scene:
    pos, uv, faces = statue(params)
    rng = np.random.default_rng([params["shape_seed"], 1])
    tex = stone(params["texture"], params["stone"], rng)
    cam = params["camera"]
    draws = [Draw(0, 0, np.eye(4, dtype=np.float32))]

    def frame(t: float) -> View:
        th = cam["orbit_rate"] * t
        eye = [cam["radius"] * np.sin(th), cam["height"],
               cam["radius"] * np.cos(th)]
        return View(math3d.look_at_rh(eye, [0.0, cam["target_y"], 0.0]),
                    cam["fov"], cam["z_near"], cam["z_far"], draws)

    return Scene(tuple(params["resolution"]),
                 [Mesh(pos, uv, faces.reshape(-1))], [tex], frame)
