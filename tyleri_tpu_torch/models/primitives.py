"""Procedural geometry generators for the built-in test/benchmark scenes.

The reference ships no geometry (meshes come from the engine); these
generators produce the meshes the BASELINE configs name (triangle, cube,
Suzanne-scale blob, Sponza-scale walls) as (vertices [N, 5] AoS pos+uv,
indices [M] u32) ready for RenderDevice.create_vertices/create_indices.

The port's own copy of ``tyleri_tpu/models/primitives.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import numpy as np


def triangle(z: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    verts = np.array(
        [
            [-0.8, 0.8, z, 0.0, 1.0],
            [0.8, 0.8, z, 1.0, 1.0],
            [0.0, -0.8, z, 0.5, 0.0],
        ],
        np.float32,
    )
    return verts, np.array([0, 1, 2], np.uint32)


def quad(size: float = 1.0, z: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    s = size / 2
    verts = np.array(
        [
            [-s, -s, z, 0.0, 0.0],
            [s, -s, z, 1.0, 0.0],
            [s, s, z, 1.0, 1.0],
            [-s, s, z, 0.0, 1.0],
        ],
        np.float32,
    )
    return verts, np.array([0, 1, 2, 0, 2, 3], np.uint32)


def cube(size: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Unit cube, 24 vertices (per-face uvs), 12 triangles."""
    s = size / 2
    faces = [
        # (normal axis, sign, u axis, v axis)
        (0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1),
    ]
    verts = []
    idx = []
    for f, (axis, sign) in enumerate(faces):
        u_axis = (axis + 1) % 3
        v_axis = (axis + 2) % 3
        base = len(verts)
        for (u, v), (tu, tv) in zip(
            [(-s, -s), (s, -s), (s, s), (-s, s)],
            [(0, 0), (1, 0), (1, 1), (0, 1)],
        ):
            p = [0.0, 0.0, 0.0]
            p[axis] = s * sign
            p[u_axis] = u
            p[v_axis] = v
            verts.append([*p, tu, tv])
        if sign > 0:
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
        else:
            idx += [base, base + 2, base + 1, base, base + 3, base + 2]
    return np.asarray(verts, np.float32), np.asarray(idx, np.uint32)


def uv_sphere(n_lat: int = 16, n_lon: int = 24, radius: float = 1.0):
    """UV sphere — ~2*n_lat*n_lon triangles (the "Suzanne-scale" organic
    mesh stand-in: BASELINE config 3 wants ~1k tris; 16x24 gives 768)."""
    verts = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * np.pi * j / n_lon
            x = radius * np.sin(theta) * np.cos(phi)
            y = radius * np.cos(theta)
            z = radius * np.sin(theta) * np.sin(phi)
            verts.append([x, y, z, j / n_lon, i / n_lat])
    idx = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + stride
            if i > 0:
                idx += [a, b, a + 1]
            if i < n_lat - 1:
                idx += [a + 1, b, b + 1]
    return np.asarray(verts, np.float32), np.asarray(idx, np.uint32)


def uv_sphere_lit(n_lat: int = 16, n_lon: int = 24, radius: float = 1.0):
    """uv_sphere with per-vertex normals (pos/radius) in the LitVertex AoS
    layout [N, 8] = pos + normal + uv (BASELINE config 3 lit mesh)."""
    verts, idx = uv_sphere(n_lat, n_lon, radius)
    out = np.zeros((len(verts), 8), np.float32)
    out[:, :3] = verts[:, :3]
    out[:, 3:6] = verts[:, :3] / radius
    out[:, 6:8] = verts[:, 3:5]
    return out, idx


def checkerboard_texture(n: int = 64, cells: int = 8,
                         color_a=(1.0, 1.0, 1.0, 1.0),
                         color_b=(0.2, 0.2, 0.2, 1.0)) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx * cells // n + yy * cells // n) % 2).astype(np.float32)[..., None]
    a = np.asarray(color_a, np.float32)
    b = np.asarray(color_b, np.float32)
    return c * a + (1 - c) * b


def gradient_texture(n: int = 64) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n]
    r = (xx / (n - 1)).astype(np.float32)
    g = (yy / (n - 1)).astype(np.float32)
    b = np.full_like(r, 0.5)
    return np.stack([r, g, b, np.ones_like(r)], axis=-1)


def displaced_grid(n: int = 64, extent: float = 10.0, seed: int = 0,
                   amplitude: float = 0.6):
    """A large displaced heightfield grid — 2*(n-1)^2 triangles. Used to
    build Sponza-scale triangle counts procedurally (config 5)."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 2 * np.pi, size=(4,))
    freqs = rng.uniform(1.0, 4.0, size=(4,))
    xs = np.linspace(-extent / 2, extent / 2, n, dtype=np.float32)
    zs = np.linspace(-extent / 2, extent / 2, n, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs)
    yy = sum(
        amplitude / (k + 1) * np.sin(freqs[k] * (xx * (k % 2 + 1) + zz) + phases[k])
        for k in range(4)
    ).astype(np.float32)
    u = (xx / extent + 0.5).astype(np.float32)
    v = (zz / extent + 0.5).astype(np.float32)
    verts = np.stack([xx, yy, zz, u, v], axis=-1).reshape(-1, 5)
    idx = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = a + n
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return verts.astype(np.float32), np.asarray(idx, np.uint32)
