"""Profile the port's steady frame on one CUDA card: host time per span,
device kernel time per frame, the largest kernels and the eager op count.

    python3 -m tyleri_tpu_torch.testing.profile_frame [--frames N]
        [--scene sponza|instances]

Config 5 (sponza, 1.05M triangles) at 1920x1080 by default, or config 4
(100 instances, peel2 under the "auto" blend policy).  The sponza camera
orbits across the near plane and then stands still until the capacity plan
has converged (as in chip_smoke.py); config 4 stands still throughout.
Then N frames run unprofiled (CUDA events on the frame stream; the frame
loop's spans, ``utils/profiling.tracing``, give the host time of each
layer) and N more under torch.profiler (device time of every kernel and
copy).  The report's first line is the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time

import torch

from tyleri_tpu_torch.utils.profiling import RANGE, tracing


def span_ms(records, n: int) -> list:
    """(span name, host ms a frame, self ms a frame: less what its child
    spans cover), the longest first."""
    total = collections.defaultdict(float)
    own = collections.defaultdict(float)
    for s in records.spans:
        d = (s.end_ns - s.start_ns) * 1e-6 / n
        total[s.name] += d
        own[s.name] += d
        if s.parent >= 0:
            own[records.spans[s.parent].name] -= d
    return sorted(((k, v, own[k]) for k, v in total.items()),
                  key=lambda r: -r[1])


def render(win, rig, times):
    for t in times:
        rig.fill(win.get_render_scene(), t)
        win.render()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--grid-n", type=int, default=420,
                    help="sponza heightfield size (420: 1.05M triangles)")
    ap.add_argument("--scene", choices=("sponza", "instances"),
                    default="sponza", help="config 5 or config 4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 2
    import tyleri_tpu_torch as tt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0])
    res, n = (args.width, args.height), args.frames
    messages = []   # overflows while the plan converges are expected
    dev = tt.RenderDeviceBuilder().validation_level(
        tt.ValidationLevel.ERROR).debug_callback(messages.append).build()
    if args.scene == "sponza":
        rig = tt.scenes.config5_sponza(dev, res, grid_n=args.grid_n)
        t, warm = 0.0, [0.25 * k for k in range(1, 25)] + [0.0] * 40
    else:
        rig = tt.scenes.config4_instances(dev, res)
        t, warm = 0.5, [0.5] * 40
    win = tt.RenderWindow(dev, resolution=res, present_mode="immediate")
    render(win, rig, warm)
    win.flush()
    converged = len(messages)

    with tracing() as records:
        # events ordered through the device's queue pool
        start = dev.present_queues.event(enable_timing=True)
        t0 = time.perf_counter()
        render(win, rig, [t] * n)
        end = dev.present_queues.event(enable_timing=True)
        win.flush()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    end.synchronize()
    frame_ms = start.elapsed_time(end) / n
    print(f"{rig.triangle_count} triangles at {res[0]}x{res[1]}, {n} frames,"
          f" peel2 {win.rendering_function.plan.raster.peel2}")
    print(f"unprofiled: {frame_ms:.3f} ms/frame by CUDA events, "
          f"{host_ms:.3f} ms/frame by host clock")
    for name, ms, own in span_ms(records, n):
        print(f"  host {name:24s} {ms:8.3f} ms/frame, self {own:8.3f}")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        render(win, rig, [t] * n)
        win.flush()
    rows = prof.key_averages()
    device = sorted(
        ((r.self_device_time_total, r.count, r.key) for r in rows
         if r.device_type == torch.autograd.DeviceType.CUDA
         and not r.key.startswith(RANGE)), reverse=True)
    busy_ms = sum(us for us, _, _ in device) / 1e3 / n
    aten = sum(r.count for r in rows if r.key.startswith("aten::")) / n
    print(f"profiled: device kernels and copies {busy_ms:.3f} ms/frame "
          f"({busy_ms / frame_ms:.1%} of the unprofiled frame); "
          f"{sum(c for _, c, _ in device) / n:.0f} kernels and copies, "
          f"{aten:.0f} aten ops per frame")
    for us, count, key in device[:15]:
        print(f"  {us / 1e3 / n:8.4f} ms  {count / n:6.1f}/frame  {key[:90]}")
    overflow = [m for m in messages[converged:]
                if m.message_id == "capacity-overflow"]
    if overflow:
        print(f"profile_frame: the profiled frames overflowed: {overflow[0]}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
