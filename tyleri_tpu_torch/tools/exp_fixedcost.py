"""P6: K3's empty-segment fixed cost and the launch probe (counterpart of
``tools/exp_fixedcost.py``: ``_kernel`` and ``probe_launch``'s ``k``).

``run``: per tile, the state is the depth block and ``n_out - 1`` zero
maps; for each of the tile's chunks, counted from the ``chunk``-aligned
base at or below its segment's start, the chunk at that base is staged in
shared memory and ``table[base, 0]`` is added to every map.  Like the TPU
probe, every chunk re-reads the same base rows.  The tool times it with
empty segments, on the full [1,179,648, 24] table and on a one-chunk table
(``_tiny``): K3's cost with nothing to resolve.  Tiles are the port's 16x16
(the TPU's were 16 x 128); the output is the same [1088, 1920] per map.
The TPU probe's lane pad of the table ([E, 24] -> [E, 128], ``do_pad``,
``pad_only``) exists only for its layout and has no counterpart.

``probe_launch``: a kernel fills a (grid_h * tile_h) x (grid_w * tile_w)
grid with 1.0, one block per tile, and the caller adds a scalar, as the TPU
probe's jit does: per-launch against per-block against per-pixel cost.  The
tool times ``torch.ones`` of the same shape beside the fill kernel, in turns
(library, fill, fill, library), as the library call that computes it.

Kernels: ``csrc/probes.cu`` ``fixed_cost_kernel`` (16-byte loads and
stores along the frame's rows, each trip's chunk one bulk copy) and
``fill_kernel``, bit-equal to ``fixed_cost_reference`` and
``fill_reference``.

    python3 -m tyleri_tpu_torch.tools.exp_fixedcost [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common

FB_W, FB_H = 1920, 1080
TILE = 16                      # the kernel's tiles: 16x16, as K3
CHUNK = 128                    # the TPU probe's chunk rows
E_FULL = 1_179_648             # sponza's entry capacity scale
NUM_CHANNELS = 24

launches = {"fixed_cost": 0, "fill": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def grid_of(tile_w: int, tile_h: int) -> tuple[int, int]:
    return -(-FB_H // tile_h), -(-FB_W // tile_w)


def fixed_cost_reference(table, tile_start, depth0, *, n_out: int,
                         chunk: int = CHUNK, tile_w: int = TILE,
                         tile_h: int = TILE) -> list[torch.Tensor]:
    """n_out f32 maps [grid_h * tile_h, grid_w * tile_w] for tiles of
    ``tile_w`` x ``tile_h`` (``tile_start`` has one segment per tile, row
    by row)."""
    grid_h, grid_w = grid_of(tile_w, tile_h)
    pad_h, pad_w = grid_h * tile_h, grid_w * tile_w
    start, end = tile_start[:-1].long(), tile_start[1:].long()
    base = start - start % chunk
    nchunks = torch.where(end > start, -(-(end - base) // chunk), 0)
    c = table[torch.where(nchunks > 0, base, 0), 0]

    def per_pixel(v):
        return v.view(grid_h, grid_w).repeat_interleave(
            tile_h, 0).repeat_interleave(tile_w, 1)

    n, c = per_pixel(nchunks), per_pixel(c)
    s0 = torch.nn.functional.pad(depth0.to(torch.float32),
                                 (0, pad_w - FB_W, 0, pad_h - FB_H))
    s = torch.zeros_like(s0)
    for k in range(int(nchunks.max()) if nchunks.numel() else 0):
        s0 = torch.where(k < n, s0 + c, s0)
        s = torch.where(k < n, s + c, s)
    return [s0] + [s.clone() for _ in range(n_out - 1)]


def check_kernel_inputs(table, tile_start, depth0, n_out: int) -> None:
    """Raises ValueError on what the kernel does not take: table f32
    [E, C] with C a multiple of 4, tile_start i32 [8161], depth0 f32
    [1080, 1920], all contiguous on one device, the table and the depth
    16-byte aligned (the kernel copies chunks of the table in bulk and
    reads the depth in 16-byte loads)."""
    dev = table.device
    grid_h, grid_w = grid_of(TILE, TILE)
    for name, t, dt, shape in (
            ("table", table, torch.float32, (table.shape[0], table.shape[-1])),
            ("tile_start", tile_start, torch.int32, (grid_h * grid_w + 1,)),
            ("depth0", depth0, torch.float32, (FB_H, FB_W))):
        if (t.dtype != dt or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"fixed_cost: {name} must be a contiguous {dt} "
                             f"{shape} on {dev}")
    if table.shape[1] % 4:
        raise ValueError(f"fixed_cost: table rows must be a multiple of 4 "
                         f"floats, got {tuple(table.shape)}")
    for name, t in (("table", table), ("depth0", depth0)):
        if t.data_ptr() % 16:
            raise ValueError(f"fixed_cost: {name} must be 16-byte aligned")
    if not 1 <= n_out <= 7:
        raise ValueError(f"fixed_cost: n_out {n_out}")


def fixed_cost(table, tile_start, depth0, *, n_out: int
               ) -> list[torch.Tensor]:
    """The maps of ``fixed_cost_reference`` at 16x16 tiles and chunks of
    ``CHUNK`` rows: the kernel for CUDA tensors (``check_kernel_inputs``;
    segments inside the table), the plain version for CPU ones."""
    dev = table.device
    if dev.type == "cpu":
        return fixed_cost_reference(table, tile_start, depth0, n_out=n_out)
    if dev.type != "cuda":
        raise ValueError(f"fixed_cost: unsupported device {dev}")
    check_kernel_inputs(table, tile_start, depth0, n_out)
    grid_h, grid_w = grid_of(TILE, TILE)
    maps = [torch.empty((grid_h * TILE, grid_w * TILE), device=dev)
            for _ in range(n_out)]
    lib = _build.load()
    launches["fixed_cost"] += 1
    err = lib.ty_fixed_cost(
        tile_start.data_ptr(), table.data_ptr(), table.shape[0],
        table.shape[1], depth0.data_ptr(), n_out,
        *(m.data_ptr() for m in maps), *(None,) * (7 - n_out),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fixed_cost")
    return maps


def fill_reference(grid_h, grid_w, tile_h, tile_w, device) -> torch.Tensor:
    return torch.ones((grid_h * tile_h, grid_w * tile_w), device=device)


def fill(grid_h, grid_w, tile_h, tile_w, device) -> torch.Tensor:
    """1.0 over the grid: the kernel on the card, one block per tile."""
    device = torch.device(device)
    if device.type == "cpu":
        return fill_reference(grid_h, grid_w, tile_h, tile_w, device)
    if device.type != "cuda":
        raise ValueError(f"fill: unsupported device {device}")
    out = torch.empty((grid_h * tile_h, grid_w * tile_w), device=device)
    lib = _build.load()
    launches["fill"] += 1
    err = lib.ty_fill(out.data_ptr(), grid_h, grid_w, tile_h, tile_w,
                      torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "fill")
    return out


def probe_launch_fn(grid_h, grid_w, tile_h, tile_w):
    """The launch probe's function of a scalar tensor x: fill, then + x."""
    return lambda x: fill(grid_h, grid_w, tile_h, tile_w, x.device) + x


def fixed_cost_bound(table, tile_start, n_out: int) -> dict:
    """The depth and tile starts read once, the maps written once, and one
    4-byte value read per distinct chunk base; one add per pixel, map and
    chunk."""
    start, end = tile_start[:-1].long(), tile_start[1:].long()
    base = start - start % CHUNK
    nchunks = torch.where(end > start, -(-(end - base) // CHUNK), 0)
    grid_h, grid_w = grid_of(TILE, TILE)
    pad = grid_h * TILE * grid_w * TILE
    bases = int(torch.unique(base[nchunks > 0]).numel())
    nbytes = 4 * (FB_H * FB_W + tile_start.numel() + n_out * pad + bases)
    return _common.bound(nbytes, n_out * TILE * TILE * int(nchunks.sum()))


def fill_bound(grid_h, grid_w, tile_h, tile_w) -> dict:
    """The fill kernel's bound: the grid written once."""
    return _common.bound(4 * grid_h * tile_h * grid_w * tile_w, 0)


def tool_inputs(device, seed=0):
    """(full table f32 [1,179,648, 24], one-chunk table, depth0, empty
    segments ts_empty i32 [8161])."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((E_FULL, NUM_CHANNELS),
                                        dtype=np.float32)).to(device)
    depth0 = torch.ones((FB_H, FB_W), device=device)
    grid_h, grid_w = grid_of(TILE, TILE)
    ts_empty = torch.zeros((grid_h * grid_w + 1,), dtype=torch.int32,
                           device=device)
    return table, table[:CHUNK].contiguous(), depth0, ts_empty


def segment_starts(device, seed=5) -> torch.Tensor:
    """i32 [8161]: 70 % of the tiles hold 1 to 299 rows, the rest none,
    from row 3 on (starts off the chunk grid), inside the full table."""
    rng = np.random.default_rng(seed)
    grid_h, grid_w = grid_of(TILE, TILE)
    n = grid_h * grid_w
    lens = rng.integers(0, 300, n) * (rng.random(n) < 0.7)
    return torch.from_numpy(np.concatenate([[3], 3 + np.cumsum(lens)])
                            .astype(np.int32)).to(device)


SHORT_E = 1000   # 7 chunks and a short one of 104 rows


def jumbled_starts(device, E=SHORT_E, seed=0) -> torch.Tensor:
    """i32 [8161] in no order, each in [0, E]: a tile's segment [ts[t],
    ts[t + 1]) is empty where ts[t + 1] <= ts[t], so the tiles of a CTA
    take different trip counts, some none; starts lie off the chunk grid,
    and bases in the last chunk copy the E % 128 rows up to E."""
    rng = np.random.default_rng(seed)
    grid_h, grid_w = grid_of(TILE, TILE)
    return torch.from_numpy(rng.integers(0, E + 1, grid_h * grid_w + 1)
                            .astype(np.int32)).to(device)


VARIANTS = {
    "empty_full": dict(tiny=False, n_out=7),
    "empty_tiny": dict(tiny=True, n_out=7),
    "outs1_tiny": dict(tiny=True, n_out=1),
    "outs3_tiny": dict(tiny=True, n_out=3),
}
LAUNCH_VARIANTS = {
    "launch_1x1_8x128": (1, 1, 8, 128),        # 1 block, 4 KB
    "launch_68x15_16x128": (68, 15, 16, 128),  # 1020 blocks, full frame
    "launch_17x15_64x128": (17, 15, 64, 128),  # 255 blocks, full frame
    "launch_1020x1_8x128": (1020, 1, 8, 128),  # 1020 blocks, tiny frame
    "launch_68x15_8x128": (68, 15, 8, 128),    # 1020 blocks, half frame
}


def run_variants(device: torch.device, reps: int, card=None) -> list[dict]:
    table, tiny, depth0, ts_empty = tool_inputs(device)
    out = []
    for name, kw in VARIANTS.items():
        tab = tiny if kw["tiny"] else table
        t = _common.timing(lambda: fixed_cost(tab, ts_empty, depth0,
                                              n_out=kw["n_out"]),
                           device, reps)
        out.append(_common.emit("exp_fixedcost", name, device, card, **t,
                                **fixed_cost_bound(tab, ts_empty,
                                                   kw["n_out"])))
    # the fill kernel alone (its bound), and the probe's fill + add
    x = torch.zeros((), device=device)
    for name, shape in LAUNCH_VARIANTS.items():
        f = probe_launch_fn(*shape)

        def kernel():
            fill(*shape, device)

        def library():
            grid_h, grid_w, tile_h, tile_w = shape
            torch.ones((grid_h * tile_h, grid_w * tile_w), device=device)

        t = [_common.timing(g, device, reps)
             for g in (library, kernel, kernel, library)]
        key = next(iter(t[0]))
        probe = _common.timing(lambda: f(x), device, reps)
        out.append(_common.emit(
            "exp_fixedcost", name, device, card,
            **{key: (t[1][key] + t[2][key]) / 2,
               f"library_{key}": (t[0][key] + t[3][key]) / 2},
            **{f"probe_{k}": v for k, v in probe.items()},
            **fill_bound(*shape)))
    return out


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__)
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    run_variants(device, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
