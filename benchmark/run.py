"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``tyleri_tpu_torch``)
and ``BENCHMARK.json``, on a machine with as many CUDA cards as the cell
asks for; without them it names what is missing and exits 2, printing no
result.  The kernels build once into ``build/tyleri_tpu_torch/`` in the
checkout (the program's own fixed build directory) and load from there in
every later run.

Standard output's last line is one JSON object: ``correct``, ``attempted``
(frames presented in the window), ``failed`` (those that reported dropped
work), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the check compared beside its limit, which
also end standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T_IMPORT = time.perf_counter()


def _since_spawn() -> float:
    """Seconds since this process was spawned (its start time in
    /proc/self/stat against /proc/uptime), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def _environment(root: str) -> None:
    """Caches inside the checkout, at fixed paths; no JAX pulled in by a
    library the port uses."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    spawn_s = _since_spawn()
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import spec

    root = spec.ROOT
    _environment(root)
    cell = spec.cell(args.workload, root)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "false); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    from benchmark import harness

    out = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                          spawn_s=spawn_s + time.perf_counter() - t_main)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; nothing it "
              f"runs may import JAX or the JAX package", file=sys.stderr)
        return 1
    notes = out["notes"]
    notes["nvcc_builds"] = _builds()
    print("benchmark: " + json.dumps(notes), file=sys.stderr)
    result = out["result"]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _builds() -> int:
    from tyleri_tpu_torch import _build

    return _build.compiles


if __name__ == "__main__":
    sys.exit(main())
