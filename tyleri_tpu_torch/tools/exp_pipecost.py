"""P1: K3's empty-workload floor, stage by stage (counterpart of
``tools/exp_pipecost.py``, ``_kernel``).

Over the probe's 1088 x 1920 frame (the TPU's 68 x 15 grid of 16 x 128
blocks) the kernel writes ``nout`` f32 maps, stripped to a level:

* level 0: map i holds the constant i;
* level 1: adds the pixel-centre iotas, the 1920x1080 scissor mask and a
  7-map state (map i = i): on the card it compiles to level 0's stores,
  since nothing reads them;
* level 2: adds the tile's chunk loop: for each chunk of the tile's
  segment, map i += c0 * xf * (1/(i+1)) + yf * 0 + (0 inside the scissor,
  1 outside), c0 the chunk's first scalar, chunk rows at
  ``min(start + k * chunk, e_cap - chunk)``.

The kernel (``csrc/probes.cu`` ``pipe_cost_kernel``) takes the port's 16x16
tiles, ``tpb`` tile rows per CTA (the tool's ``tpp``), and the port's K3
chunk: 64 rows of 24 f32, double-buffered in shared memory, each window
one bulk copy (not the TPU's 128 x 128 f32 entry buffer).  Each line also
gives ``staged_bytes``, the windows the probe copies beside its bound, and
``staged_floor_ms``, the least time of the bound's bytes and those.  It is
bit-equal to ``pipe_cost_reference``, which takes any tile shape, so it can
also read a tile-start table laid out for the TPU's 16 x 128 tiles.  Maps
come back in the tool's layout, [68, 15, 16, 128] per map (views of the
row-major frame).

    python3 -m tyleri_tpu_torch.tools.exp_pipecost [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common

FRAME_H, FRAME_W = 1088, 1920        # the probe's padded frame
SCISSOR_W, SCISSOR_H = 1920, 1080
GRID_H, GRID_W = 68, 15              # the tool's output blocks of
BLOCK_H, BLOCK_W = 16, 128           # 16 x 128 pixels
TILE = 16                            # the kernel's tiles
CHUNK = 64                           # the port's K3 chunk rows
NUM_CHANNELS = 24
E_CAP = 1 << 19          # >= 8160 tiles x 64 rows: ts_one gives each a chunk
NSTATE = 7

launches = {"pipe_cost": 0}


def reset_launches() -> None:
    launches["pipe_cost"] = 0


def tool_layout(frame: torch.Tensor) -> torch.Tensor:
    """A [1088, 1920] map as the tool's [68, 15, 16, 128] blocks (a view)."""
    return frame.view(GRID_H, BLOCK_H, GRID_W, BLOCK_W).permute(0, 2, 1, 3)


def pipe_cost_reference(entries, tile_start, *, nout: int, level: int,
                        chunk: int = CHUNK, tile_w: int = TILE,
                        tile_h: int = TILE) -> list[torch.Tensor]:
    """nout f32 maps in the tool's layout, for a tile-start table of tiles
    of ``tile_w`` x ``tile_h`` over the frame, row by row."""
    dev = entries.device
    y = torch.arange(FRAME_H, device=dev)[:, None].expand(FRAME_H, FRAME_W)
    x = torch.arange(FRAME_W, device=dev)[None, :].expand(FRAME_H, FRAME_W)
    state = [torch.full((FRAME_H, FRAME_W), float(i), device=dev)
             for i in range(NSTATE)]
    if level == 2:
        xf = x.to(torch.float32) + 0.5
        yf = y.to(torch.float32) + 0.5
        outside = torch.where((x < SCISSOR_W) & (y < SCISSOR_H), 0.0, 1.0)
        t = (y // tile_h) * (FRAME_W // tile_w) + x // tile_w
        start, end = tile_start[t].long(), tile_start[t + 1].long()
        nchunks = torch.where(end > start, -(-(end - start) // chunk), 0)
        e_cap = entries.shape[0]
        for k in range(int(nchunks.max())):
            c0 = entries[torch.clamp(start + k * chunk, max=e_cap - chunk), 0]
            live = k < nchunks
            for i in range(NSTATE):
                r = torch.tensor(1.0 / (i + 1.0), dtype=torch.float32)
                state[i] = torch.where(
                    live, state[i] + c0 * xf * r + yf * 0.0 + outside,
                    state[i])
    return [tool_layout(s) for s in state[:nout]]


def check_kernel_inputs(entries, tile_start, *, nout: int, level: int,
                        tpp: int = 1) -> None:
    """Raises ValueError on what the kernel does not take: entries f32
    [E, C], C a multiple of 4, E >= ``CHUNK``, contiguous and 16-byte
    aligned (each window is one bulk copy of 64 rows), tile_start i32
    [8161] on the same device, 1 <= nout <= 7, level 0, 1 or 2, and
    ``tpp`` tile rows per CTA dividing the frame's 68."""
    dev = entries.device
    ntiles = (FRAME_H // TILE) * (FRAME_W // TILE)
    if (entries.dtype != torch.float32 or entries.dim() != 2
            or entries.shape[1] % 4 or not entries.is_contiguous()
            or entries.data_ptr() % 16 or entries.shape[0] < CHUNK):
        raise ValueError("pipe_cost: entries must be a contiguous, 16-byte "
                         f"aligned f32 [E, C], C a multiple of 4, E >= {CHUNK}")
    if (tile_start.dtype != torch.int32 or tuple(tile_start.shape)
            != (ntiles + 1,) or not tile_start.is_contiguous()
            or tile_start.device != dev):
        raise ValueError(f"pipe_cost: tile_start must be a contiguous i32 "
                         f"[{ntiles + 1}] on {dev}")
    if not (1 <= nout <= NSTATE and level in (0, 1, 2) and tpp > 0
            and (FRAME_H // TILE) % tpp == 0):
        raise ValueError(f"pipe_cost: nout {nout}, level {level}, tpp {tpp}")


def run(entries, tile_start, *, nout: int, level: int,
        tpp: int = 1) -> list[torch.Tensor]:
    """The maps of ``pipe_cost_reference`` at 16x16 tiles (tile_start i32
    [8161]) and chunks of ``CHUNK`` rows: the kernel for CUDA tensors
    (``check_kernel_inputs``), ``tpp`` tile rows per CTA; the plain version
    for CPU ones."""
    dev = entries.device
    if dev.type == "cpu":
        return pipe_cost_reference(entries, tile_start, nout=nout,
                                   level=level)
    if dev.type != "cuda":
        raise ValueError(f"pipe_cost: unsupported device {dev}")
    check_kernel_inputs(entries, tile_start, nout=nout, level=level, tpp=tpp)
    maps = [torch.empty((FRAME_H, FRAME_W), device=dev) for _ in range(nout)]
    lib = _build.load()
    launches["pipe_cost"] += 1
    err = lib.ty_pipe_cost(
        tile_start.data_ptr(), entries.data_ptr(), entries.shape[0],
        entries.shape[1], level, nout, tpp,
        *(m.data_ptr() for m in maps), *(None,) * (7 - nout),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pipe_cost")
    return [tool_layout(m) for m in maps]


def chunks_of(tile_start) -> torch.Tensor:
    """Each 16x16 tile's chunk count."""
    start, end = tile_start[:-1].long(), tile_start[1:].long()
    return torch.where(end > start, -(-(end - start) // CHUNK), 0)


def pipe_cost_bound(tile_start, nout: int, level: int) -> dict:
    """The maps written once, the tile starts and each chunk's first scalar
    read once (level 2); five operations per pixel, map and chunk."""
    nbytes = 4 * nout * FRAME_H * FRAME_W
    nops = 0
    if level == 2:
        nchunks = int(chunks_of(tile_start).sum())
        nbytes += 4 * (tile_start.numel() + nchunks)
        nops = 5 * NSTATE * TILE * TILE * nchunks
    return _common.bound(nbytes, nops)


def staged(tile_start, nout: int, level: int, channels: int = NUM_CHANNELS
           ) -> dict:
    """What the probe stages beside its bound: every chunk's window of
    ``CHUNK`` x ``channels`` f32 (level 2), and the floor that the bound's
    bytes plus those set at the card's memory rate."""
    nbytes = 4 * CHUNK * channels * int(chunks_of(tile_start).sum()) \
        if level == 2 else 0
    total = pipe_cost_bound(tile_start, nout, level)["bytes"] + nbytes
    return dict(staged_bytes=nbytes,
                staged_floor_ms=total / _common.HBM_BYTES_PER_S * 1e3)


def tool_inputs(device, seed=0):
    """(entries f32 [2^18, 24], ts_zero, ts_one i32 [8161]): no chunk per
    tile, and one chunk per tile."""
    rng = np.random.default_rng(seed)
    entries = torch.from_numpy(rng.standard_normal(
        (E_CAP, NUM_CHANNELS), dtype=np.float32)).to(device)
    ntiles = (FRAME_H // TILE) * (FRAME_W // TILE)
    ts_zero = torch.zeros((ntiles + 1,), dtype=torch.int32, device=device)
    ts_one = torch.clamp(torch.arange(ntiles + 1, device=device) * CHUNK,
                         max=E_CAP).to(torch.int32)
    return entries, ts_zero, ts_one


SHORT_E = 1000   # a table of 15 windows and a clamped last one


def jumbled_starts(device, e_cap=SHORT_E, seed=0) -> torch.Tensor:
    """i32 [8161] in no order, each in [0, e_cap]: a tile's segment is
    empty where ts[t + 1] <= ts[t], so neighbouring tiles take 0 to 16
    trips, and every window that would run past the table clamps at
    ``e_cap - CHUNK``."""
    rng = np.random.default_rng(seed)
    ntiles = (FRAME_H // TILE) * (FRAME_W // TILE)
    return torch.from_numpy(rng.integers(0, e_cap + 1, ntiles + 1)
                            .astype(np.int32)).to(device)


VARIANTS = {
    "v_out1": dict(ts="zero", nout=1, level=0, tpp=1),
    "v_out7": dict(ts="zero", nout=7, level=0, tpp=1),
    "v_out7_tpp4": dict(ts="zero", nout=7, level=0, tpp=4),
    "v_state": dict(ts="zero", nout=7, level=1, tpp=1),
    "v_loop0": dict(ts="zero", nout=7, level=2, tpp=1),
    "v_loop1": dict(ts="one", nout=7, level=2, tpp=1),
    "v_loop1_tpp4": dict(ts="one", nout=7, level=2, tpp=4),
}


def run_variants(device: torch.device, reps: int, card=None) -> list[dict]:
    entries, ts_zero, ts_one = tool_inputs(device)
    out = []
    for name, kw in VARIANTS.items():
        ts = ts_one if kw["ts"] == "one" else ts_zero
        args = dict(nout=kw["nout"], level=kw["level"])
        t = _common.timing(lambda: run(entries, ts, tpp=kw["tpp"], **args),
                           device, reps)
        out.append(_common.emit("exp_pipecost", name, device, card, **t,
                                **pipe_cost_bound(ts, **args),
                                **staged(ts, **args,
                                         channels=entries.shape[1])))
    return out


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__)
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    run_variants(device, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
