"""Directional light — the lit-path extension (BASELINE config 3).

The reference renders unlit (its fragment shader is a plain texture fetch,
ref: src/pipeline/glsl/common_pipeline.frag:5-13) and its scene has no light
objects; the BASELINE config-3 target names Blinn-Phong lit rendering, so
the light is an additive extension: a Camera with ``light = None`` (the
default) renders exactly the reference path.

Shading model (implemented identically in ops/shade.py::blinn_phong and the
oracle, testing/oracle.py):

    n = normalize(interpolated world normal)     (zero normal -> ambient only)
    l = normalize(-direction)                    (direction = travel of light)
    v = normalize(eye - p_world)
    h = normalize(l + v)
    rgb = tex.rgb * (ambient + color * max(n.l, 0))
          + color * specular * max(n.h, 0)^shininess
    a   = tex.a

The port's own copy of ``tyleri_tpu/scene/light.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DirectionalLight:
    direction: tuple = (0.0, -1.0, -1.0)  # travel direction, world space
    color: tuple = (1.0, 1.0, 1.0)
    ambient: float = 0.15
    specular: float = 0.4
    shininess: float = 32.0

    def as_array(self) -> np.ndarray:
        """Pack into the f32 [12] uniform row the frame program consumes:
        [l.xyz (normalized, toward the light), color.rgb, ambient,
        specular, shininess, enabled, pad, pad]."""
        d = np.asarray(self.direction, np.float64)
        n = np.linalg.norm(d)
        l = (-d / n if n > 0 else np.array([0.0, 1.0, 0.0]))
        return np.asarray(
            [*l, *self.color, self.ambient, self.specular, self.shininess,
             1.0, 0.0, 0.0],
            np.float32,
        )


def no_light_array() -> np.ndarray:
    return np.zeros((12,), np.float32)
