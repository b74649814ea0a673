"""P4: the binning row gather (counterpart of ``tools/exp_binning.py``,
part (c), ``gather_kernel``).

The TPU kernel streams, for each chunk of 1,024 sorted ids into a [T, 32]
f32 table, the chunk's rows through an 8-deep ring of DMAs and sums
``table[id, 0]`` over them; every grid step writes the same [8, 128] block,
so the TPU keeps only the last chunk's sum, broadcast.  Here
``gather_rows`` writes what such a gather is for, the gathered rows
``table[ids]`` ([E, C], C = 32 for the tool, 24 for the port's binning
gather ``setup.channels[entry_tri]``, ops/binning.py:187), and the sum of
every chunk in id order; ``run_gather`` returns the TPU tool's [8, 128]
output from them.  The tool's [T/32, 8, 128] and [E/1024, 8, 128] reshapes
exist only for the TPU's layout and have no counterpart.

Kernel: ``csrc/probes.cu`` ``gather_rows_kernel``, bit-equal to
``gather_rows_reference``: rows are copies, and each chunk's sum is taken
in id order in one thread, as the plain version and the TPU kernel take it.

    python3 -m tyleri_tpu_torch.tools.exp_binning [--device cpu] [--reps N]

times the tool's shapes (T = 2^20, E = 1.25 T sorted ids, [T, 32]) and the
port's binning shapes (T = 1,114,112 rows of 24 f32, 1,572,785 unsorted
ids) beside ``torch.index_select`` on the same inputs, the yardstick the
port never calls.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common

CHUNK = 1024   # ids per chunk, as the TPU kernel's grid step
WIDTHS = (24, 32)   # row widths the kernel takes (f32)


def chunk_sums(v: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """f32 sums of ``v`` over consecutive chunks, each taken in order from
    0.0, one add at a time (the kernel's and the TPU kernel's rounding)."""
    n = -(-v.shape[0] // chunk)
    blocks = torch.nn.functional.pad(v, (0, n * chunk - v.shape[0]))
    blocks = blocks.view(n, chunk)
    s = torch.zeros(n, dtype=torch.float32, device=v.device)
    for j in range(chunk):
        s = s + blocks[:, j]
    return s


def gather_rows_reference(ids: torch.Tensor, table: torch.Tensor,
                          chunk: int = CHUNK):
    """(table[ids] f32 [E, C], per-chunk sums of table[ids, 0] f32
    [ceil(E / chunk)])."""
    rows = table[ids.long()]
    return rows, chunk_sums(rows[:, 0].contiguous(), chunk)


def gather_rows(ids: torch.Tensor, table: torch.Tensor):
    """The gather of ``gather_rows_reference`` in chunks of ``CHUNK`` ids:
    the kernel for CUDA tensors (ids i32 [E], table f32 [T, 24 or 32], both
    contiguous), the plain version for CPU ones.  The two differ on an id
    outside [0, T): the kernel gathers a zero row for it, the plain version
    raises.  The kernel does not check the ids, as that would cost a read
    of them back to the host."""
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_reference(ids, table)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    _build.check_args("gather_rows", dev, (
        ("ids", ids, torch.int32, (ids.numel(),)),
        ("table", table, torch.float32, None)))
    if (table.dim() != 2 or table.shape[1] not in WIDTHS
            or table.data_ptr() % 16):
        raise ValueError(f"gather_rows: table must be 16-byte aligned f32 "
                         f"[T, C], C in {WIDTHS}")
    E, (T, C) = ids.shape[0], table.shape
    rows = torch.empty((E, C), dtype=torch.float32, device=dev)
    sums = torch.empty((-(-E // CHUNK),), dtype=torch.float32, device=dev)
    _build.launcher("gather_rows", "ty_gather_rows", dev, (
        ids.data_ptr(), table.data_ptr(), T, C, E, rows.data_ptr(),
        sums.data_ptr()))()
    return rows, sums


def run_gather(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The TPU tool's output: the last chunk's sum of table[id, 0],
    broadcast to f32 [8, 128]."""
    _, sums = gather_rows(ids, table)
    return sums[-1:].expand(8, 128).contiguous()


def gather_bound(ids: torch.Tensor, table: torch.Tensor) -> dict:
    """The gather's bound: the distinct rows read once, the rows, sums and
    ids written or read once; one add per id."""
    E, C = ids.shape[0], table.shape[1]
    distinct = int(torch.unique(ids).numel())
    nbytes = 4 * (distinct * C + E * C + E + -(-E // CHUNK))
    return _common.bound(nbytes, E)


def tool_inputs(device, T=1 << 20, C=32, E=None, sort=True, seed=0):
    """(ids i32 [E], table f32 [T, C]) from a seed: the tool's shapes by
    default (E = 1.25 T sorted ids)."""
    rng = np.random.default_rng(seed)
    E = T + (T >> 2) if E is None else E
    ids = rng.integers(0, T, E).astype(np.int32)
    if sort:
        ids = np.sort(ids)
    table = rng.random((T, C), dtype=np.float32)
    return torch.from_numpy(ids).to(device), torch.from_numpy(table).to(device)


VARIANTS = {
    # the tool's shapes: sorted ids into [2^20, 32]
    "sorted_t1m_c32": dict(T=1 << 20, C=32, sort=True),
    # the port's binning gather: 1,572,785 ids (sponza at 1080p) into
    # 1,114,112 rows of 24, not sorted by id
    "unsorted_t1114112_c24": dict(T=1_114_112, C=24, E=1_572_785, sort=False),
}


def run_variants(device: torch.device, reps: int, card=None) -> list[dict]:
    """Time every variant: the gather, and ``torch.index_select`` on the
    same inputs, in turns (library, gather, gather, library)."""
    out = []
    for name, kw in VARIANTS.items():
        ids, table = tool_inputs(device, **kw)
        ids64 = ids.long()

        def gather():
            gather_rows(ids, table)

        def library():
            torch.index_select(table, 0, ids64)

        t = [_common.timing(f, device, reps)
             for f in (library, gather, gather, library)]
        key = next(iter(t[0]))
        out.append(_common.emit(
            "exp_binning", name, device, card, E=ids.shape[0],
            T=table.shape[0], C=table.shape[1],
            **{key: (t[1][key] + t[2][key]) / 2,
               f"library_{key}": (t[0][key] + t[3][key]) / 2},
            **gather_bound(ids, table)))
    return out


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__)
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    run_variants(device, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
