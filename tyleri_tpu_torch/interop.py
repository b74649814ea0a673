"""State carried from the JAX package into the port.

The parity tests build a scene once, through the JAX package's upload API,
and render it with both packages.  These helpers copy what that upload
wrote (numpy staging arrays, the allocators' slot and offset tables) into a
port ``RenderDevice``, so both packages render from the same bytes, carry a
``RasterPlan`` across so both run with the same capacities, and rebuild the
JAX package's pipeline states and scenes with the port's classes
(``from_jax``): the port's enums are its own, and a lookup keyed by one
raises on the JAX package's member of the same name.

Nothing here imports the JAX package: its objects are read only through
their attributes, numpy arrays and class names.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from tyleri_tpu_torch.pipeline import state
from tyleri_tpu_torch.rendering.passes import RasterPlan
from tyleri_tpu_torch.resource.arenas import (
    BindlessBufferAllocator,
    VariableLengthBuffer,
)
from tyleri_tpu_torch.resource.textures import TextureArena
from tyleri_tpu_torch.scene import (
    camera,
    light,
    mesh_renderer,
    render_scene,
    ui,
)
from tyleri_tpu_torch.utils import math3d


def classes_of(*modules) -> dict:
    """Class name -> class, for every class the modules define."""
    return {name: c for m in modules for name, c in vars(m).items()
            if isinstance(c, type) and c.__module__ == m.__name__}


# what ``from_jax`` rebuilds: pipeline state, scene objects, viewports
PORT_CLASSES = {**classes_of(state, camera, light, mesh_renderer,
                             render_scene, ui, math3d),
                "VariableLengthBuffer": VariableLengthBuffer}


def convert(obj, classes: dict):
    """``obj`` rebuilt with the classes of ``classes`` (name -> class), by
    class name and value: an enum member by its name (its value must
    match), a dataclass by its fields, any other instance of a named class
    by its attributes, lists and tuples item by item.  Objects of other
    classes (numpy arrays, numbers, arena handles) are shared as they are.
    An enum with no counterpart in ``classes`` raises."""
    cls = classes.get(type(obj).__name__)
    if isinstance(obj, enum.Enum):
        if cls is None or obj.name not in cls.__members__:
            raise ValueError(f"no counterpart for {obj!r}")
        member = cls[obj.name]
        if member.value != obj.value:
            raise ValueError(f"{obj!r} and {member!r} differ in value")
        return member
    if type(obj) in (list, tuple):
        return type(obj)(convert(v, classes) for v in obj)
    if cls is None:
        return obj
    if dataclasses.is_dataclass(obj):
        return cls(**{f.name: convert(getattr(obj, f.name), classes)
                      for f in dataclasses.fields(obj)})
    new = cls.__new__(cls)
    new.__dict__.update({k: convert(v, classes)
                         for k, v in vars(obj).items()})
    return new


def from_jax(obj):
    """A JAX pipeline state (``PipelineState``, ``DepthState``,
    ``BlendState``, an enum member) or ``RenderScene`` rebuilt with the
    port's classes."""
    return convert(obj, PORT_CLASSES)


def _load_arena(arena: BindlessBufferAllocator, staging: dict,
                version: int) -> None:
    """Make ``arena`` hold a copy of ``staging`` (name -> [cap, ...])."""
    cap = len(next(iter(staging.values())))
    with arena._lock:
        arena._ensure(cap)
        for name, a in staging.items():
            dst = arena._staging[name]
            dst[:len(a)] = a
            dst[len(a):] = 0
        # the copied extent is in use: later uploads go after it
        arena._allocator.allocate(arena.capacity)
        arena.version = max(arena.version, version) + 1
        arena._dirty = True


def device_state_from_numpy(render_device, *, vertices: dict, indices: dict,
                            texels: np.ndarray, tex_offsets, tex_widths,
                            tex_heights, texels_used: int,
                            version: int = 0) -> None:
    """Fill a fresh port ``render_device``'s arenas from numpy arrays.

    vertices: {"pos": [V, 3], "uv": [V, 2], "nrm": [V, 3]} and indices:
    {"idx": [I] u32} (arena staging, including unused capacity);
    texels: [N, 4] rgba with the slot table (offsets, widths, heights)."""
    alloc = render_device.memory_allocator
    _load_arena(alloc.static_vertices_buffer, vertices, version)
    _load_arena(alloc.static_indices_buffer, indices, version)
    tex: TextureArena = alloc.texture_arena
    with tex._lock:
        tex._texels = np.array(texels, np.float32)
        tex._used = int(texels_used)
        tex._offsets = [int(v) for v in tex_offsets]
        tex._widths = [int(v) for v in tex_widths]
        tex._heights = [int(v) for v in tex_heights]
        tex._free_extents = []
        tex._free_slots = []
        tex._dirty = True


def load_render_device(port_device, jax_render_device) -> None:
    """Copy a JAX ``RenderDevice``'s uploaded geometry and textures into a
    port ``RenderDevice``.  Arena handles (MeshRenderer vertices, indices,
    texture slots) made on the JAX device then address the same data on
    the port device."""
    src = jax_render_device.memory_allocator
    varena = src.static_vertices_buffer
    iarena = src.static_indices_buffer
    tarena = src.texture_arena
    device_state_from_numpy(
        port_device,
        vertices={n: varena.staging(n) for n in varena.fields},
        indices={n: iarena.staging(n) for n in iarena.fields},
        texels=tarena._texels,
        tex_offsets=tarena._offsets,
        tex_widths=tarena._widths,
        tex_heights=tarena._heights,
        texels_used=tarena._used,
        version=max(varena.version, iarena.version),
    )


def raster_plan_from_jax(plan) -> RasterPlan:
    """The port's ``RasterPlan`` with every field the two plans share taken
    from a JAX ``RasterPlan`` (tile geometry, capacities, clip state)."""
    names = {f.name for f in dataclasses.fields(RasterPlan)}
    return RasterPlan(**{n: getattr(plan, n) for n in names})
