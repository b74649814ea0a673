"""P5: the fused setup's layout probes (counterpart of
``tools/exp_mosaic_probe.py``: ``transpose_kernel`` and ``compute_kernel``).

* transpose: x f32 [24, N] -> [N, 24], the field-major setup rows emitted
  row-major; the TPU kernel transposes [24, 1024] blocks in VMEM.
* compute: out[n, c] = x[c % 16, n // 128, n % 128] * 2 + c for x f32 [16,
  N / 128, 128], emitted row-major [N, 24]: 24 values computed field-major
  from 16 input fields, then written as rows.

Both at the tool's N = 2^20, on its inputs (``arange(24 N) % 1000`` and
ones), and checked by its own asserts.  The kernels (``csrc/probes.cu``
``rows_to_cols_kernel``) stage 256 columns in shared memory; they are
bit-equal to ``transpose_reference`` and ``compute_reference``.  The
transpose is timed beside ``x.t().contiguous()``, one PyTorch call that
computes it; no single call computes the compute probe.

    python3 -m tyleri_tpu_torch.tools.exp_mosaic_probe [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common

N = 1 << 20
ROWS = 24
FIELDS = 16
LANES = 128


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def compute_reference(x: torch.Tensor) -> torch.Tensor:
    """x f32 [16, N / 128, 128] -> [N, 24]."""
    f = x.reshape(FIELDS, -1)
    c = torch.arange(ROWS, device=x.device)
    out = f[c % FIELDS] * 2.0 + c[:, None].to(torch.float32)
    return out.t().contiguous()


def _launch(name, x, rows, compute):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n = x.numel() // rows
    _build.check_args(name, dev, (("x", x, torch.float32, None),))
    if n == 0 or x.numel() != rows * n:
        raise ValueError(f"{name}: x must hold {rows} rows of N > 0 floats, "
                         f"got {tuple(x.shape)}")
    out = torch.empty((n, ROWS), device=dev)
    _build.launcher(name, "ty_transpose_rows", dev, (
        x.data_ptr(), n, int(compute), out.data_ptr()))()
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """[24, N] -> [N, 24]: the kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if x.device.type == "cpu":
        return transpose_reference(x)
    if x.dim() != 2 or x.shape[0] != ROWS:
        raise ValueError(f"transpose_rows: x must be [{ROWS}, N]")
    return _launch("transpose_rows", x, ROWS, False)


def compute(x: torch.Tensor) -> torch.Tensor:
    """[16, N / 128, 128] -> [N, 24]: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    if x.device.type == "cpu":
        return compute_reference(x)
    if x.dim() != 3 or x.shape[0] != FIELDS or x.shape[2] != LANES:
        raise ValueError(f"field_compute: x must be [{FIELDS}, N/128, 128]")
    return _launch("field_compute", x, FIELDS, True)


def tool_inputs(device, n=N):
    """The tool's inputs: x_t = arange(24 n) % 1000 as [24, n] and x_c =
    ones [16, n / 128, 128]."""
    x_t = (torch.arange(ROWS * n, dtype=torch.float32, device=device)
           % 1000).reshape(ROWS, n)
    return x_t, torch.ones((FIELDS, n // LANES, LANES), device=device)


def check_tool_asserts(x_t, out_t, out_c) -> None:
    """The tool's own checks (tools/exp_mosaic_probe.py:42-43, :84)."""
    if not torch.equal(out_t[:2048], x_t[:, :2048].t()):
        raise AssertionError("transpose: out[:2048] != x[:, :2048].T")
    if float(out_c[5, 3]) != 1.0 * 2.0 + 3:
        raise AssertionError("compute: out[5, 3] != 5.0")


def transpose_bound(n=N) -> dict:
    return _common.bound(2 * 4 * ROWS * n, 0)


def compute_bound(n=N) -> dict:
    """16 fields read, 24 values written; one multiply and one add each."""
    return _common.bound(4 * (FIELDS + ROWS) * n, 2 * ROWS * n)


VARIANTS = ("transpose", "compute")


def run_variants(device: torch.device, reps: int, card=None) -> list[dict]:
    x_t, x_c = tool_inputs(device)
    check_tool_asserts(x_t, transpose(x_t), compute(x_c))
    t = _common.timing(lambda: transpose(x_t), device, reps)
    lib = _common.timing(lambda: x_t.t().contiguous(), device, reps)
    out = [_common.emit("exp_mosaic_probe", "transpose", device, card, **t,
                        **{f"library_{k}": v for k, v in lib.items()},
                        **transpose_bound())]
    t = _common.timing(lambda: compute(x_c), device, reps)
    out.append(_common.emit("exp_mosaic_probe", "compute", device, card, **t,
                            **compute_bound()))
    return out


def main(argv=None) -> int:
    args = _common.parse(argv, __doc__)
    device = _common.device_for(args)
    card = _common.card_line() if device.type == "cuda" else None
    run_variants(device, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
