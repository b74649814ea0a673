"""The benchmark's scene data: what its generators make from ``--seed`` and
hand both to the program (``port.py`` uploads it) and to the reference
(``reference.py``).  Plain numpy, f32, as an application would hold it.

A configuration file names its generator (``scenes/<generator>.py``, whose
``build(params, seed)`` returns a ``Scene``); a traffic mix may name an
overlay generator (``build(params, seed)`` returning an ``Overlay``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray   # f32 [N, 3]
    uvs: np.ndarray         # f32 [N, 2]
    indices: np.ndarray     # u32 [M], M % 3 == 0

    @property
    def triangle_count(self) -> int:
        return len(self.indices) // 3


@dataclasses.dataclass
class Draw:
    mesh: int               # index into Scene.meshes
    texture: int            # index into Scene.textures
    model: np.ndarray       # f32 [4, 4]


@dataclasses.dataclass
class View:
    """One frame's camera and draw list."""

    view: np.ndarray        # f32 [4, 4] (look_at_rh)
    fov_deg: float
    z_near: float
    z_far: float
    draws: list             # [Draw], in submission order


@dataclasses.dataclass
class Scene:
    resolution: tuple       # (width, height)
    meshes: list            # [Mesh]
    textures: list          # [f32 [h, w, 4]]
    frame: Callable         # frame(t: float) -> View

    @property
    def triangle_count(self) -> int:
        return sum(self.meshes[d.mesh].triangle_count
                   for d in self.frame(0.0).draws)


@dataclasses.dataclass
class Overlay:
    """A UI overlay in window points: elements drawn in order, each
    (vertices f32 [V, 8] = x, y, u, v, r, g, b, a; indices u32 [M];
    texture index into ``textures``)."""

    elements: list
    textures: list
    scale_factor: float = 1.0

    @property
    def triangle_count(self) -> int:
        return sum(len(i) for _, i, _ in self.elements) // 3


def generator(name: str):
    """The generator module ``benchmark.scenes.<name>``."""
    return importlib.import_module(f"benchmark.scenes.{name}")
