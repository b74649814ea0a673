"""Matrix helpers for the benchmark's scenes: glam's conventions (column
vectors, right-handed, depth in [0, 1]), row-major f32 4x4 arrays.

A frozen copy of the formulas the renderer's camera and scenes use
(glam ``Mat4::perspective_rh`` and ``look_at_rh``), so that the scenes and
the reference do not depend on the program under test.
"""

from __future__ import annotations

import numpy as np


def perspective_rh(fov_y_radians, aspect_ratio, z_near, z_far):
    """glam ``Mat4::perspective_rh`` in f32: z = -z_near maps to depth 0,
    z = -z_far to 1."""
    fov = np.float32(fov_y_radians)
    h = np.float32(np.cos(fov * 0.5) / np.sin(fov * 0.5))
    w = np.float32(h / np.float32(aspect_ratio))
    zn = np.float32(z_near)
    zf = np.float32(z_far)
    r = np.float32(zf / (zn - zf))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * zn
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up=(0.0, 1.0, 0.0)):
    """glam ``Mat4::look_at_rh`` in f32."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def translation(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def rotation_y(angle):
    a = np.float32(angle)
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m
