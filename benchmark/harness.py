"""One run of one cell: set-up, warm-up, the measured window of the port's
frame loop, the traced slices (``--trace 1``), then the check of the frames
the window presented against the plain reference.

Every frame is the application's: the traffic's frame time ``t``, the
scene filled for it (``port.Uploaded.fill``) and ``RenderWindow.render()``.
The loop is closed: the next frame is filled as soon as ``render`` returns.
The window presents each frame through its present target once the
frame's fence has passed; the harness notes the time of each present and
keeps the images of the frames its check will judge (references only: the
window hands every frame a buffer of its own).
"""

from __future__ import annotations

import functools
import gc
import sys
import time

import numpy as np

from benchmark import compare, port, tracing
from benchmark.scene import generator
from benchmark.spec import Cell, metric_module, stages

FORBIDDEN = ("jax", "jaxlib", "flax", "tyleri_tpu")


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


class Clock:
    """The traffic's frame times.  The warm-up renders frame k at
    t = step * (k mod period), the same for every seed, so that every seed
    leaves it with the same plan.  From the window's first frame ``first``
    on, frame k renders at t = start + step * ((k - first) mod period),
    the start drawn from the seed (``start_pick``: one of ``choices``
    points ``spacing`` apart; ``start_uniform``: uniform in a range) or 0."""

    def __init__(self, time_spec: dict, seed: int):
        r = rng(seed, 1)
        start = 0.0
        pick = time_spec.get("start_pick")
        if pick:
            start += pick["spacing"] * int(r.integers(pick["choices"]))
        uniform = time_spec.get("start_uniform")
        if uniform:
            start += float(r.uniform(*uniform))
        self.start = start
        self.step = float(time_spec.get("step", 0.0))
        self.period = time_spec.get("period")
        self.first = None

    def __call__(self, k: int) -> float:
        start = 0.0
        if self.first is not None and k >= self.first:
            k -= self.first
            start = self.start
        if self.period:
            k %= self.period
        return start + self.step * k


def forbidden_modules() -> list[str]:
    """Top-level module names of JAX or the JAX package in this process,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """The state one run builds: the program's device and window, and the
    harness's records of every frame."""

    def __init__(self, cell: Cell, seed: int, device_type: str):
        self.cell, self.seed = cell, seed
        cfg, trf = cell.config, cell.traffic
        self.messages = []
        self.device = port.build_device(device_type, self.messages)
        self.scene = generator(cfg["generator"]).build(cfg["params"], seed)
        ov = trf.get("overlay")
        self.overlay = (generator(ov["generator"]).build(ov["params"], seed)
                        if ov else None)
        self.uploaded = port.Uploaded(self.device, self.scene, self.overlay)
        self.clock = Clock(trf["time"], seed)
        self.fill_t, self.present_t = [], []
        self.keep, self.kept = set(), {}
        self.last_image = None
        self.stats = []           # per presented frame: (overflow, crossings)
        self.window = port.window(self.device, self.scene.resolution,
                                  self.uploaded.scale_factor, self._present)
        report = self.window._report_stats

        def report_stats(device, stats, current):
            self.stats.append((int(stats[0]) + int(stats[1])
                               + int(stats[2]), int(stats[3])))
            return report(device, stats, current)

        self.window._report_stats = report_stats
        self.frames = 0
        self.plan = self.window.rendering_function.plan
        self.plan_changes = 0

    def _present(self, image) -> None:
        j = len(self.present_t)
        self.present_t.append(time.perf_counter())
        self.last_image = image
        if j in self.keep:
            self.kept[j] = image

    def frame(self, with_ui: bool = True) -> None:
        self.fill_t.append(time.perf_counter())
        self.uploaded.fill(self.window.get_render_scene(),
                           self.clock(self.frames), with_ui)
        self.window.render()
        self.frames += 1
        plan = self.window.rendering_function.plan
        if plan != self.plan:
            self.plan = plan
            self.plan_changes += 1

    def _converge(self, rule: dict, with_ui: bool) -> tuple[int, list]:
        """Frames until the plan has stood for ``stable_frames`` and at
        least ``min_frames`` ran, or ``max_frames`` ran; returns the run of
        frames the plan stood for and the time each frame ended."""
        stable, marks = 0, []
        while True:
            changes = self.plan_changes
            self.frame(with_ui)
            marks.append(time.perf_counter())
            stable = stable + 1 if self.plan_changes == changes else 0
            if ((len(marks) >= rule["min_frames"]
                 and stable >= rule["stable_frames"])
                    or len(marks) >= rule["max_frames"]):
                return stable, marks

    def warm_up(self) -> dict:
        """The traffic's warm-up: first, where it has a ``mesh_only`` rule,
        frames without the overlay until that rule holds (the mesh path's
        capacities converge at the mesh path's pace, and the overlay
        changes none of them); then the cell's full path until the
        warm-up's own rule holds.  The frame time that places the check's
        frames is taken from the full path's last frames."""
        w = self.cell.traffic["warmup"]
        if "mesh_only" in w:
            self._converge(w["mesh_only"], False)
        stable, marks = self._converge(w, True)
        tail = marks[-32:]
        per_frame = (tail[-1] - tail[0]) / max(len(tail) - 1, 1)
        return dict(frames=self.frames, stable=stable,
                    per_frame_s=per_frame)


def _choose_checks(run: Run, first: int, expected: int, n: int) -> None:
    """The frames the check judges: ``n - 1`` drawn from the seed among the
    first four fifths of the frames the window should present, and the
    last frame it presents."""
    span = max(int(0.8 * expected), 1)
    picks = rng(run.seed, 2).choice(span, size=min(n - 1, span),
                                    replace=False)
    run.keep = {first + int(p) for p in picks}


def measure(cell: Cell, seed: int, seconds: float, trace: bool, *,
            device_type: str = "cuda", spawn_s: float = 0.0) -> dict:
    """One run; returns the result line's fields and the check's numbers.
    ``spawn_s`` is how long before this call the process started."""
    import torch

    t_spawn = time.perf_counter() - spawn_s
    cuda = device_type == "cuda"
    run = Run(cell, seed, device_type)
    warm = run.warm_up()
    rf = run.window.rendering_function
    layers = cell.config["pipeline"]["blend_layers"]
    departures = []
    if rf.plan.raster.peel2 != (layers == 2):
        departures.append(f"the program blends {2 if rf.plan.raster.peel2 else 1}"
                          f" layer(s); the configuration states {layers}")

    readers = {m["name"]: metric_module(m["name"], cell.root)
               for m in (cell.per_layer if trace else cell.end_to_end)}
    timers = tracing.StageTimers(stages(cell.root)) if trace else None
    stores = {}
    if trace:
        for name, mod in readers.items():
            if hasattr(mod, "capture"):
                stores[name] = []
                for stage in mod.CAPTURE:
                    timers.hooks[stage].append(
                        functools.partial(mod.capture, stores[name]))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    spec = cell.traffic["trace"]
    slices, profs = spec["slices"], []
    # slices spread over the window; the stages' host times count the
    # frames between them
    starts = [(s + 0.25) * seconds / slices for s in range(slices)]
    active, active_frames, host_frames = None, 0, 0
    if trace:
        # a process's first profiler start takes seconds: it happens here,
        # in set-up, on two frames that are thrown away
        with torch.profiler.profile(activities=activities) as prof:
            run.frame()
            run.frame()
        prof.events()
        del prof
    slice_s = []
    run.clock.first = first = run.frames
    expected = int(seconds / max(warm["per_frame_s"], 1e-6))
    _choose_checks(run, first, expected, cell.traffic["check"]["frames"])
    if timers:
        timers.__enter__()
    try:
        n0, c0 = len(run.present_t), run.plan_changes
        st0 = len(run.stats)
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if trace and active is None and starts and now >= starts[0]:
                starts.pop(0)
                active = torch.profiler.profile(activities=activities)
                active.start()
                active_frames = 0
            if timers:
                timers.counting = active is None
                # a slice's last frame: its kernels close the slice
                timers.capturing = (len(profs) if active is not None
                                    and active_frames == spec["frames"] - 1
                                    else None)
            run.frame()
            if active is not None:
                active_frames += 1
            elif trace:
                host_frames += 1
            done = time.perf_counter() - t0 >= seconds
            if active is not None and (active_frames >= spec["frames"]
                                       or done):
                if cuda:
                    torch.cuda.synchronize()
                t_stop = time.perf_counter()
                active.stop()
                slice_s.append(time.perf_counter() - t_stop)
                profs.append((active, active_frames))
                active = None
            if done:
                break
        t1 = time.perf_counter()
        cpu_s = time.process_time() - cpu0
        n1, changes = len(run.present_t), run.plan_changes - c0
    finally:
        if timers:
            timers.__exit__()
    run.kept[n1 - 1] = run.last_image
    st1 = len(run.stats)
    run.window.flush()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    rec = dict(
        setup_s=t0 - t_spawn, window_s=t1 - t0, frames=n1 - n0,
        intervals_s=list(np.diff(run.present_t[n0:n1])),
        latencies_s=[run.present_t[j] - run.fill_t[j] for j in range(n0, n1)],
        plan_changes=changes,
        crossings=[c for _, c in run.stats[st0:st1]],
        overflow_frames=sum(1 for o, _ in run.stats[st0:st1] if o > 0),
        warmup=warm, stores=stores)
    if trace:
        t_reduce = time.perf_counter()
        rec["stage_host_s"] = dict(timers.host)
        rec["host_frames"] = host_frames
        rec["trace"] = tracing.merge([tracing.reduce_slice(p, n)
                                      for p, n in profs])
        for name, mod in readers.items():
            if hasattr(mod, "after"):
                mod.after(stores[name], rec)
        rec["trace_s"] = dict(stops=slice_s,
                              reduce=time.perf_counter() - t_reduce)
    del profs, timers

    # the check: the program's state goes first, then the reference
    checked = {j: run.kept[j] for j in sorted(run.kept) if n0 <= j < n1}
    frames_t = {j: run.clock(j) for j in checked}
    scene, overlay = run.scene, run.overlay
    run_present = run.present_t
    # picks the window ended before: not due in it
    missing = sorted(j for j in run.keep if j not in checked)
    del run, rf
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare.check(scene, overlay, cell.config, checked, frames_t,
                            device_type)
    check_s = time.perf_counter() - t_check
    limits = cell.limits["limits"]
    correct = (not departures
               and all(numbers[k] <= limits[k] for k in limits))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(platform="gpu" if cuda else device_type,
                  kind=(torch.cuda.get_device_name(0) if cuda
                        else device_type),
                  count=torch.cuda.device_count() if cuda else 1,
                  memory_peak_bytes=int(memory_peak))
    out = dict(correct=correct, attempted=rec["frames"],
               failed=rec["overflow_frames"], metrics=metrics, device=device)
    if trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["span_s"]
        out["breakdown"] = tracing.breakdown(rec["trace"])
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    notes = dict(departures=departures, not_presented_in_window=missing,
                 checked_frames=sorted(checked), check_s=check_s,
                 warmup=warm, window_frames=rec["frames"],
                 plan_changes=changes, window_cpu_s=cpu_s,
                 frames_each_s=np.bincount(
                     (np.asarray(run_present[n0:n1]) - t0).astype(int)
                 ).tolist())
    if trace:
        notes["stage_source"] = rec["trace"]["stage_source"]
        notes["profiled_frames"] = rec["trace"]["frames"]
        notes["trace_s"] = rec["trace_s"]
    return dict(result=out, notes=notes, rec=rec)
