"""Drive the PyTorch / CUDA port (tyleri_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each; any failure exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: the hand-written kernels of tyleri_tpu_torch/csrc/ with nvcc;
3. K1+K2 (fused setup) against its plain PyTorch version on a 1M-triangle
   random table (crossers, back faces, degenerate and off-screen rows) and
   on the sponza table: bit-equal;
4. K3 (visibility resolve) against its plain version on the binned table of
   one sponza frame at 1920x1080: equal maps;
5. configs 1 and 2 through RenderWindow against the numpy oracle, within
   the golden budget;
6. config 5 (sponza, 1.05M triangles) at 1920x1080 through RenderWindow
   until the near clip, the clip skip and both capacity-fit stages have
   engaged; then no overflow, one launch of each kernel per frame,
   identical images for the same frame time, and the steady frame time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

BUDGET = 0.005   # golden pixel budget (tests/test_raster_golden.py)
SPONZA_RES = (1920, 1080)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_table(rng, T, D):
    """The fused setup's test generator at scale: random corners with some
    rows fully behind the near plane, some crossing it, some degenerate;
    random windings (back faces) and positions past the screen."""
    corner = rng.uniform(-1.5, 1.5, (T, 3, 5)).astype(np.float32)
    corner[..., 2] = rng.uniform(-0.5, 3.0, (T, 3))
    k = T // 10
    corner[:k, :, 2] = rng.uniform(-4.0, -2.5, (k, 3))
    corner[k:2 * k, 0, 2] = -3.0
    corner[2 * k:2 * k + k // 10, 1] = corner[2 * k:2 * k + k // 10, 0]
    draw = rng.integers(0, D, T).astype(np.int32)
    tex = rng.integers(0, 3, T).astype(np.int32)
    valid = rng.random(T) > 0.15
    mvps = np.stack([np.eye(4, dtype=np.float32) + 0.01 * d
                     for d in range(D)])
    mvps[:, 3, 2] = -0.4
    mvps[:, 3, 3] = 2.0
    return corner, draw, tex, valid, mvps.reshape(D, 16)


def setup_equal(a, b) -> bool:
    (su_a, n_a, x_a), (su_b, n_b, x_b) = a, b
    return (torch.equal(su_a.channels.view(torch.int32),
                        su_b.channels.view(torch.int32))
            and torch.equal(su_a.valid, su_b.valid)
            and torch.equal(su_a.tile_lo, su_b.tile_lo)
            and torch.equal(su_a.tile_hi, su_b.tile_hi)
            and torch.equal(x_a, x_b) and int(n_a) == int(n_b))


def max_abs_err(pairs) -> float:
    """Largest |a - b| over float tensor pairs (NaN where either is NaN
    counts as equal only if both are)."""
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def maps_equal(a, b) -> bool:
    return torch.equal(a.owner >= 0, b.owner >= 0) and all(
        torch.equal(getattr(a, f), getattr(b, f))
        for f in ("depth", "order", "uw", "vw", "iw", "tex"))


def sponza_rig(device, resolution, grid_n=420):
    import tyleri_tpu_torch as tt

    return tt.scenes.config5_sponza(device, resolution, grid_n=grid_n)


def sponza_pass_inputs(device, resolution, grid_n=420, t=1.0):
    """The first pass of one sponza frame as the main path feeds it: the
    cached triangle tables, the MVPs, viewport and scissor."""
    import tyleri_tpu_torch as tt

    rig = sponza_rig(device, resolution, grid_n)
    rf = tt.ForwardRenderingFunction(device, tt.ImageViewSwapchain(resolution))
    scene = tt.RenderScene()
    rig.fill(scene, t)
    inputs = rf.build_frame_inputs(device, scene.render_resources, 1.0,
                                   resolution)
    (texels, toff, tw, th, _, _, viewports, scissors, mvps, corners,
     tri_draw, tri_valid0, tri_tex) = inputs
    return rf, dict(corners=corners[0], tri_draw=tri_draw[0],
                    tri_tex=tri_tex[0], tri_valid=tri_valid0[0],
                    mvps=mvps[0], viewport=viewports[0], scissor=scissors[0])


def phase_setup(device, T, resolution, records, grid_n=420):
    """K1+K2 against its plain version: bit-equal on a random table with
    every kind of row and on the sponza table; times at the sponza shape."""
    from tyleri_tpu_torch.ops import setup_cuda
    from tyleri_tpu_torch.rendering.passes import setup_dims

    W, H = resolution
    viewport = np.asarray([0, 0, W, H, 0, 1], np.float32)
    scissor = np.asarray([0, 0, W, H], np.int32)
    rf, sp = sponza_pass_inputs(device, resolution, grid_n)
    dims = setup_dims(rf.plan.raster)
    rng = np.random.default_rng(0)
    rand = [torch.from_numpy(a).to(device.device)
            for a in random_table(rng, T, 7)]
    got = setup_cuda.fused_setup(*rand, True, viewport, scissor, **dims)
    want = setup_cuda.fused_setup_reference(*rand, True, viewport, scissor,
                                            **dims)
    err = max_abs_err([(got[0].channels, want[0].channels)])
    if not setup_equal(got, want):
        raise AssertionError("fused_setup differs from its plain version on "
                             "the random table")
    args = (sp["corners"], sp["tri_draw"], sp["tri_tex"], sp["tri_valid"],
            sp["mvps"], True, sp["viewport"], sp["scissor"])
    got = setup_cuda.fused_setup(*args, **dims)
    want = setup_cuda.fused_setup_reference(*args, **dims)
    err = max(err, max_abs_err([(got[0].channels, want[0].channels)]))
    if not setup_equal(got, want):
        raise AssertionError("fused_setup differs from its plain version on "
                             "the sponza table")
    ms = cuda_ms(lambda: setup_cuda.fused_setup(*args, **dims), reps=20)
    plain_ms = cuda_ms(
        lambda: setup_cuda.fused_setup_reference(*args, **dims), reps=5)
    n_live = int(got[0].valid.sum())
    records["fused_setup"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log("k1k2", f"bit-equal on {T} random rows and {args[0].shape[0]} sponza "
        f"rows ({n_live} live, {int(got[1])} crossers); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return rf, sp


def phase_visibility(device, rf, sp, resolution, records):
    """K3 against its plain version on one sponza frame's binned table."""
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.ops.binning import bin_triangles
    from tyleri_tpu_torch.rendering.passes import (
        _fused_clip_subset,
        setup_dims,
    )

    plan = rf.plan.raster
    dims = setup_dims(plan)
    state = rf.mesh_state
    su, _, crossed = setup_cuda.fused_setup(
        sp["corners"], sp["tri_draw"], sp["tri_tex"], sp["tri_valid"],
        sp["mvps"], True, sp["viewport"], sp["scissor"], **dims)
    su, _ = _fused_clip_subset(
        su, crossed, (sp["corners"], sp["tri_draw"], sp["tri_tex"]),
        sp["mvps"], sp["viewport"], sp["scissor"], state, plan.clip_cap,
        dims)
    binned = bin_triangles(
        su, grid_w=plan.grid_w, grid_h=plan.grid_h,
        entry_cap=plan.entry_cap, max_tiles_per_tri=plan.max_tiles_per_tri,
        broad_cap=plan.broad_cap, spill_cap=plan.spill_cap)
    W, H = resolution
    depth0 = torch.ones((H, W), device=device)
    kw = dict(fb_w=W, fb_h=H, depth_state=state.depth, **dims)
    got = raster_cuda.rasterize_visibility(binned, depth0, sp["scissor"],
                                           chunk=plan.chunk, **kw)
    want = raster_cuda.rasterize_visibility_reference(
        binned, depth0, sp["scissor"], **kw)
    err = max_abs_err([(getattr(got, f), getattr(want, f))
                       for f in ("depth", "order", "uw", "vw", "iw")])
    if not maps_equal(got, want):
        bad = (got.depth != want.depth) | (got.tex != want.tex)
        raise AssertionError(
            f"rasterize_visibility differs from its plain version at "
            f"{int(bad.sum())} pixels")
    ms = cuda_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], chunk=plan.chunk, **kw), reps=20)
    plain_ms = cuda_ms(lambda: raster_cuda.rasterize_visibility_reference(
        binned, depth0, sp["scissor"], **kw), reps=2, warmup=0)
    records["rasterize_visibility"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms)
    log("k3", f"maps equal on the full {W}x{H} frame ({int(binned.num_entries)}"
        f" entries, {int(binned.num_broad)} broad, "
        f"{int((got.owner >= 0).sum())} covered px); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")


def render_frames(win, rig, times):
    for t in times:
        rig.fill(win.get_render_scene(), t)
        win.render()
    return win.flush()


def phase_small_configs(build_device):
    """Configs 1 and 2 through RenderWindow against the oracle."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.testing.scene_oracle import (
        mismatch_fraction,
        scene_oracle_u8,
    )

    for name, make, t in (("config1", tt.scenes.config1_triangle, 0.0),
                          ("config2", tt.scenes.config2_cube, 0.9)):
        dev = build_device()
        rig = make(dev)
        win = tt.RenderWindow(dev, resolution=rig.resolution,
                              present_mode="immediate")
        img = render_frames(win, rig, [t])
        scene = tt.RenderScene()
        rig.fill(scene, t)
        want = scene_oracle_u8(dev, scene.render_resources,
                               win.rendering_function.mesh_state,
                               rig.resolution)
        bad = mismatch_fraction(img, want)
        if img.shape != want.shape or bad > BUDGET:
            raise AssertionError(f"{name}: {bad:.4%} pixels differ from the "
                                 f"oracle (budget {BUDGET:.2%})")
        log(name, f"{rig.resolution[0]}x{rig.resolution[1]}: {bad:.4%} px "
            f"differ from the oracle (budget {BUDGET:.2%})")


def phase_sponza(build_device, resolution, grid_n=420):
    """Config 5 through RenderWindow until every adaptive stage engaged,
    then the steady frame time."""
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.window.render_window import RenderWindow

    messages = []
    dev = build_device(callback=messages.append)
    rig = sponza_rig(dev, resolution, grid_n)
    win = RenderWindow(dev, resolution=resolution, present_mode="immediate")
    rf = win.rendering_function
    # orbit frames cross the near plane (hybrid clip); then a still camera
    # with no crossers for the clip skip and the fit stages
    orbit = [0.25 * k for k in range(1, 25)]
    setup_cuda.reset_launches()
    raster_cuda.reset_launches()
    seen = dict(clip_cap=rf.plan.raster.clip_cap, near_clip_off=False,
                fit_stage=0)
    frames = 0
    t0 = time.perf_counter()
    for t in orbit + [0.0] * 96:
        rig.fill(win.get_render_scene(), t)
        win.render()
        frames += 1
        seen["clip_cap"] = max(seen["clip_cap"], rf.plan.raster.clip_cap)
        seen["near_clip_off"] |= not rf.plan.raster.near_clip
        seen["fit_stage"] = max(seen["fit_stage"], rf._fit_stage)
        if (frames > len(orbit) and seen["near_clip_off"]
                and seen["fit_stage"] == 2):
            break
    win.flush()
    warm_s = time.perf_counter() - t0
    launches = (setup_cuda.launches, raster_cuda.launches)
    if launches != (frames, frames):
        raise AssertionError(f"kernel launches {launches} for {frames} "
                             "frames of one pass each")
    if not (seen["near_clip_off"] and seen["fit_stage"] == 2):
        raise AssertionError(f"adaptive stages did not all engage: {seen}")
    log("config5", f"{frames} frames to converge ({warm_s:.1f} s): clip_cap "
        f"grew to {seen['clip_cap']}, clip skip engaged, fit stage 2; plan "
        f"entry_cap {rf.plan.raster.entry_cap}, valid_cap "
        f"{rf.plan.raster.valid_cap}, launches {launches}")

    # steady state: the converged plan, timed with CUDA events on the
    # frame loop's stream and with the host clock
    n_overflow = len(messages)
    stream = dev.queue.stream
    steady = 30
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    plan_before = rf.plan
    render_frames(win, rig, [0.0] * 3)
    # the frame loop must not wait on its own stream: a synchronizing op
    # (a blocking host<->device copy, a value read) would serialize host
    # and card
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        start.record(stream)
        h0 = time.perf_counter()
        for _ in range(steady):
            rig.fill(win.get_render_scene(), 0.0)
            win.render()
        end.record(stream)
        img_a = win.flush()
        host_ms = (time.perf_counter() - h0) * 1e3 / steady
    torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in syncs if "synchroniz" in str(w.message)]
    end.synchronize()
    ms = start.elapsed_time(end) / steady
    img_b = render_frames(win, rig, [0.0])
    overflow = [m for m in messages[n_overflow:]
                if m.message_id == "capacity-overflow"]
    if overflow:
        raise AssertionError(f"overflow after convergence: {overflow[0]}")
    if syncs:
        raise AssertionError(f"the frame loop synchronized: {syncs[0].message}")
    if rf.plan != plan_before:
        raise AssertionError("the plan changed during the steady window")
    if not np.array_equal(img_a, img_b):
        raise AssertionError("two renders of the same frame differ")
    if img_a.shape != (resolution[1], resolution[0], 4):
        raise AssertionError(f"image shape {img_a.shape}")
    covered = float((img_a[..., :3] > 0).any(axis=-1).mean())
    if covered < 0.5:
        raise AssertionError(f"only {covered:.1%} of the frame covered")
    mtris = rig.triangle_count / (ms * 1e-3) / 1e6
    log("config5", f"{resolution[0]}x{resolution[1]}, {rig.triangle_count} "
        f"tris: steady {ms:.3f} ms/frame by CUDA events ({1e3 / ms:.2f} FPS,"
        f" {mtris:.1f} Mtris/s), {host_ms:.3f} ms/frame by host clock; "
        f"{len(syncs)} synchronizing calls in {steady} frames"
        f"{' (' + str(syncs[0].message)[:200] + ')' if syncs else ''}; no "
        f"overflow; identical images; {covered:.1%} px covered")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tyleri_tpu_torch import _build
    from tyleri_tpu_torch.device.builders import (
        RenderDeviceBuilder,
        ValidationLevel,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.load()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.1f}"
        f" s ({_build.library_path()})")

    def build_device(callback=None):
        b = RenderDeviceBuilder().validation_level(ValidationLevel.WARNING)
        return b.debug_callback(callback).build()

    device = build_device().device
    records = {}
    rf, sp = phase_setup(build_device(), 1 << 20, SPONZA_RES, records)
    phase_visibility(device, rf, sp, SPONZA_RES, records)
    del rf, sp
    torch.cuda.empty_cache()
    phase_small_configs(build_device)
    launches = phase_sponza(build_device, SPONZA_RES)

    kernels = [
        dict(name="fused_setup", route="cuda",
             source="tyleri_tpu_torch/csrc/fused_setup.cu",
             replaces="tyleri_tpu/ops/setup_pallas.py:71,163",
             launches=launches[0], **records["fused_setup"]),
        dict(name="rasterize_visibility", route="cuda",
             source="tyleri_tpu_torch/csrc/visibility.cu",
             replaces="tyleri_tpu/ops/raster_pallas.py:78",
             launches=launches[1], **records["rasterize_visibility"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
