"""State carried from the JAX package into the port.

The parity tests build a scene once, through the JAX package's upload API,
and render it with both packages.  These helpers copy what that upload
wrote (numpy staging arrays, the allocators' slot and offset tables) into a
port ``RenderDevice``, so both packages render from the same bytes, and
carry a ``RasterPlan`` across so both run with the same capacities.

Nothing here imports JAX: a JAX ``RenderDevice`` is read only through its
numpy state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tyleri_tpu.resource.arenas import BindlessBufferAllocator
from tyleri_tpu.resource.textures import TextureArena
from tyleri_tpu_torch.rendering.passes import RasterPlan


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
