"""Device meshes for multi-device rendering (counterpart of
``tyleri_tpu/parallel/mesh.py``).

The reference is strictly single-GPU; its only parallelism is threads over
draw recording.  The port has two scaling axes, as the JAX package does:

* ``tiles``: sort-first image parallelism, each device renders one
  horizontal band of the framebuffer;
* ``draws``: sort-last object parallelism, each device renders the
  round-robin share of the draws that the reference's ParallelGroup gives a
  thread (ref: src/render_objects/mod.rs:5-30), over its whole band, and
  the devices of a band composite by depth.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
``(draws, tiles)`` over the ranks of the process group the caller
initialised, one process a rank (torchrun, or ``torch.multiprocessing``
plus ``init_process_group``).  The backend is the caller's choice: NCCL with
one card a rank, gloo on the CPU or for ranks that share a card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXIS_DRAWS = "draws"
AXIS_TILES = "tiles"


def make_render_mesh(n_draw_shards: int = 1, device_type: str | None = None):
    """The (draws, tiles) mesh over every rank of the initialised process
    group: ``n_draw_shards`` rows of ``world // n_draw_shards`` tile bands,
    rank ``r`` at (r // tiles, r % tiles).  ``device_type`` is "cuda" (the
    default: each rank renders on ``cuda:(rank % device_count)``, which
    becomes its current device) or "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_render_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n_draw_shards < 1 or n % n_draw_shards != 0:
        raise ValueError(
            f"{n} ranks not divisible by {n_draw_shards} draw shards")
    device_type = device_type or "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a cuda mesh (ask for "
                               "device_type='cpu' explicitly)")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}")
    ranks = torch.arange(n).reshape(n_draw_shards, n // n_draw_shards)
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=(AXIS_DRAWS, AXIS_TILES))
