"""What the probe tools share: the device choice, the card line, timing by
CUDA events around a CUDA graph of the calls (host clock for the plain
versions on the CPU) and one JSON line per variant."""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def parse(argv, doc: str, extra=None) -> argparse.Namespace:
    """--device and --reps; ``extra(parser)`` adds a tool's own options."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the kernels, the default) or cpu (the plain "
                         "versions)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per variant")
    if extra is not None:
        extra(ap)
    return ap.parse_args(argv)


def device_for(args) -> torch.device:
    """The card, or the CPU only when asked for: never a silent fallback."""
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch versions")
    return torch.device("cuda")


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s line for card 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms: ``reps`` calls captured in one CUDA
    graph, and one replay of it timed by CUDA events.  The host's cost of a
    call (argument checks, allocation, the ctypes call) drops out, which
    back-to-back calls (``cuda_ms``) measure instead of a kernel shorter
    than it.  ``fn`` must not synchronize; each launch in it is counted once,
    at the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timing(fn, device: torch.device, reps: int) -> dict:
    """{"ms": device time, by ``graph_ms``} on the card, {"host_ms": host
    time} on the CPU (a CPU time is no device metric)."""
    if device.type == "cuda":
        return {"ms": graph_ms(fn, reps)}
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return {"host_ms": (time.perf_counter() - t0) * 1e3 / reps}


def emit(tool: str, variant: str, device: torch.device, card, **fields
         ) -> dict:
    record = dict(tool=tool, variant=variant, device=str(device), card=card,
                  **fields)
    print(json.dumps(record), flush=True)
    return record


def bytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# NVIDIA H100 SXM, published peaks (data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# f32 outside the tensor cores: 67 TFLOP/s counts a fused multiply-add as two
# operations.  The kernels build with -fmad=false, so each add, multiply and
# compare is an instruction of its own, and the card issues half as many
# of those a second.
F32_INSTR_PER_S = 67e12 / 2
# tensor cores, dense: bf16 (and fp16) and TF32 products
TC_BF16_FLOPS = 989e12
TC_TF32_FLOPS = 495e12


def bound(nbytes: float, nops: float, tc_flops: float = 0.0,
          tc_peak: float = TC_BF16_FLOPS) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once), does ``nops`` f32
    operations on the CUDA cores, each one instruction, and ``tc_flops``
    tensor-core flops at ``tc_peak`` a second: the largest of the three
    times, and which one it is ("bytes", "operations" or "tensor")."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / F32_INSTR_PER_S * 1e3,
             "tensor": tc_flops / tc_peak * 1e3}
    by = max(times, key=times.get)
    out = dict(bound_ms=times[by], bound_by=by, bytes=int(nbytes),
               ops=int(nops))
    if tc_flops:
        out["tc_flops"] = int(tc_flops)
    return out
