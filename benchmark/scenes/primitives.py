"""Geometry and textures of the benchmark's scenes, vectorized: the shapes
of the renderer's BASELINE scenes (a cube with per-face uvs, a UV sphere,
a displaced heightfield grid, checkerboard and gradient textures)."""

from __future__ import annotations

import numpy as np


def cube(size: float = 1.0):
    """24 vertices (per-face uvs), 12 triangles."""
    s = size / 2
    verts, idx = [], []
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
        u_axis, v_axis = (axis + 1) % 3, (axis + 2) % 3
        base = len(verts)
        for (u, v), (tu, tv) in zip(((-s, -s), (s, -s), (s, s), (-s, s)),
                                    ((0, 0), (1, 0), (1, 1), (0, 1))):
            p = [0.0, 0.0, 0.0]
            p[axis], p[u_axis], p[v_axis] = s * sign, u, v
            verts.append([*p, tu, tv])
        quad = (0, 1, 2, 0, 2, 3) if sign > 0 else (0, 2, 1, 0, 3, 2)
        idx += [base + k for k in quad]
    v = np.asarray(verts, np.float32)
    return v[:, :3].copy(), v[:, 3:].copy(), np.asarray(idx, np.uint32)


def uv_sphere(n_lat: int, n_lon: int, radius: float):
    """(n_lat + 1) x (n_lon + 1) vertices; the pole rows drop their
    degenerate halves."""
    verts = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * np.pi * j / n_lon
            verts.append([radius * np.sin(theta) * np.cos(phi),
                          radius * np.cos(theta),
                          radius * np.sin(theta) * np.sin(phi),
                          j / n_lon, i / n_lat])
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
    v = np.asarray(verts, np.float32)
    return v[:, :3].copy(), v[:, 3:].copy(), np.asarray(idx, np.uint32)


def displaced_grid(n: int, extent: float, phases, freqs,
                   amplitude: float = 0.6):
    """An n x n heightfield, 2 (n - 1)^2 triangles: four sine waves of the
    given phases and frequencies."""
    xs = np.linspace(-extent / 2, extent / 2, n, dtype=np.float32)
    xx, zz = np.meshgrid(xs, xs)
    yy = sum(amplitude / (k + 1)
             * np.sin(freqs[k] * (xx * (k % 2 + 1) + zz) + phases[k])
             for k in range(4)).astype(np.float32)
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    uv = np.stack([(xx / extent + 0.5).astype(np.float32),
                   (zz / extent + 0.5).astype(np.float32)],
                  axis=-1).reshape(-1, 2)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).reshape(-1)
    b = a + n
    idx = np.stack([a, b, a + 1, a + 1, b, b + 1], axis=-1).reshape(-1)
    return pos, uv, idx.astype(np.uint32)


def checkerboard(n: int, cells: int, color_a=(1.0, 1.0, 1.0, 1.0),
                 color_b=(0.2, 0.2, 0.2, 1.0)) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx * cells // n + yy * cells // n) % 2).astype(np.float32)[..., None]
    a = np.asarray(color_a, np.float32)
    b = np.asarray(color_b, np.float32)
    return c * a + (1 - c) * b


def gradient(n: int) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n]
    r = (xx / (n - 1)).astype(np.float32)
    g = (yy / (n - 1)).astype(np.float32)
    return np.stack([r, g, np.full_like(r, 0.5), np.ones_like(r)], axis=-1)
