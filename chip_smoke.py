"""Drive the PyTorch / CUDA port (tyleri_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each or more; any failure exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: the hand-written kernels of tyleri_tpu_torch/csrc/ with nvcc,
   and each kernel's registers and spill stores from ptxas's report;
3. k1k2: K1+K2 (fused setup) against its plain PyTorch version on a
   1M-triangle random table (crossers, back faces, degenerate and
   off-screen rows) and on the sponza table: bit-equal;
4. k3: K3 (visibility resolve, base variant) against its plain version on
   the binned table of one sponza frame at 1920x1080: bit-equal; and the
   pixels its early exit moved off the no-exit resolve, at most
   EXIT_MOVED_MAX of the frame;
5. k3-counts: K3's visit counter on the same table, against the stream
   plain version: equal maps and equal counts per tile; the share of narrow
   entries the early exit skipped;
6. k3-peel2: K3's two-layer variant against the stream plain version, all
   14 maps bit-equal (owner ids included), on the binned table of one
   config-4 frame at 1920x1080 and on an adversarial overdraw table under
   LESS_OR_EQUAL and LESS, D16 and D32;
7. configs 1, 2 and 3 (lit) through RenderWindow with the "auto" blend
   policy, peel2 engaged, against the sequential numpy oracle (every
   fragment blended in draw order): configs 1 and 2 within the golden
   budget, config 3 within the lit golden tolerance;
8. config 4 (100 draws) at 1920x1080 through RenderWindow, "auto" (peel2)
   and "fast" (one layer): convergence, then no overflow, one K3 launch per
   frame, no synchronizing call and the steady frame time of each, timed
   in turns (auto, fast, fast, auto); both against the sequential oracle,
   peel2 strictly closer;
9. config 5 (sponza, 1.05M triangles) at 1920x1080 through RenderWindow
   until the near clip, the clip skip and both capacity-fit stages have
   engaged; peel2 not engaged (above the policy's triangle bound); then no
   overflow, one launch of each kernel per frame, identical images for the
   same frame time, and the steady frame time;
10. probes: the probe tools' entry points (tyleri_tpu_torch/tools/, the
   port of the TPU tools P4, P7, P6, P1, P3, P2 and P5) time their
   variants at full width, each over a CUDA graph of 20 calls, with its
   bound (P4 beside torch.index_select, P5's transpose beside
   x.t().contiguous()); then each probe kernel against its plain version
   at the tools' shapes: bit-equal (P4 also at the port's binning gather of
   the sponza frame, timed beside torch.index_select and table[ids]; P3 on
   the sponza 1080p tables of every tile height, for every variant whose
   maps differ); P2 equal on tables whose products are exact, and on the
   tool's table within exp_mxu.compare's tolerance, the share of pixels
   with another winner printed.

Every path (7, 8, 9, 10 and the counter's measurement in 5) runs with the
kernels' launch counts set to 0 just before it and read just after.  Each
kernel's bound is the largest of its bytes (each input read once, each
output written once, what this run's data needs) over 3.35 TB/s, its f32
operations on the CUDA cores, each one instruction (the kernels build with
-fmad=false), over 33.5 T/s, half the 67 TFLOP/s that counts an FMA as
two, and its tensor-core flops over 989 TFLOP/s (bf16) or a third of 495
(TF32, three passes for f32 accuracy) (NVIDIA H100 SXM); the kernels line
says "operations" for either kind of operation, and its bound_kind says
which of the three ("bytes", "operations" or "tensor") the bound is.
Each phase prints its time.  The last three lines are the card (nvidia-smi's name and power
limit), the kernels' JSON record (each kernel's share is its bound over
its time) and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script fails before printing any of them.
"""

from __future__ import annotations

import json
import sys
import time
import warnings

import numpy as np
import torch

from tyleri_tpu_torch.tools._common import (
    bound,
    bytes_of,
    card_line,
    cuda_ms,
    graph_ms,
)

BUDGET = 0.005   # golden pixel budget (tests/test_raster_golden.py)
# the share of pixels K3's early exit may move off the no-exit resolve: it
# skips a sliver whose z plane dips below its CH_ZMIN bound (ROADMAP Queue
# 3, R7), which the JAX kernel does too (tests/test_torch_visibility.py)
EXIT_MOVED_MAX = 1e-5
SPONZA_RES = (1920, 1080)
K3 = "tyleri_tpu/ops/raster_pallas.py:78"
# operations per unit of work, counted from the kernels' sources, for the
# bounds: K1+K2 per triangle (csrc/fused_setup.cu's note); K3's resolve()
# per pixel and entry: 19 f32 operations (three planes, e2, clamp, D16
# rounding) and 10 compares, and 6 more compares for peel2's layer 2
K1K2_OPS_PER_ROW = 300
K3_OPS = {"base": 29, "counts": 29, "peel2": 35}
K3_MAPS = 7        # owner, z, order, uw, vw, iw, tex: 4 bytes a pixel each
ENTRY_BYTES = 96   # 24 f32 channels


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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


def bound_fields(b) -> dict:
    """The kernels line's fields of a bound (``tools/_common.bound``):
    bound_ms, bound_by ("bytes" or "operations") and bound_kind, which says
    which operations ("bytes", "operations" on the CUDA cores or "tensor"
    core flops)."""
    return dict(bound_ms=b["bound_ms"], bound_kind=b["bound_by"],
                bound_by="bytes" if b["bound_by"] == "bytes" else
                "operations")


def k3_bound(binned, depth0, visited, variant, tile_px) -> dict:
    """K3's bound on one table: the visited narrow rows, the live broad rows
    and their tile boxes, the tile starts and the depth buffer read once;
    the maps (and the counter) written once; the resolve's operations for
    every visited entry and pixel of its tile, and every broad entry and
    pixel of its box."""
    nb = int(binned.num_broad)
    box = binned.broad_tiles[:nb].long()
    broad_px = int(((box[:, 2] - box[:, 0] + 1).clamp(min=0)
                    * (box[:, 3] - box[:, 1] + 1).clamp(min=0)).sum()) * tile_px
    maps = K3_MAPS * (2 if variant == "peel2" else 1)
    b = (visited * ENTRY_BYTES + nb * (ENTRY_BYTES + 16)
         + bytes_of(binned.tile_start, depth0) + maps * depth0.numel() * 4)
    if variant == "counts":
        b += 4 * (binned.tile_start.numel() - 1)
    return bound_fields(bound(b, K3_OPS[variant]
                              * (visited * tile_px + broad_px)))


def share(rec) -> str:
    by = rec.get("bound_kind", rec["bound_by"])
    return (f"bound {rec['bound_ms']:.4f} ms by {by}, share "
            f"{rec['bound_ms'] / rec['ms']:.1%}")


def layers_bit_equal(a, b) -> bool:
    """Every map of a VisibilityBuffer bit for bit, owner ids included."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


FLOAT_MAPS = ("depth", "order", "uw", "vw", "iw")


def sponza_rig(device, resolution, grid_n=420):
    import tyleri_tpu_torch as tt

    return tt.scenes.config5_sponza(device, resolution, grid_n=grid_n)


def config4_rig(device, resolution, n_instances=100):
    import tyleri_tpu_torch as tt

    return tt.scenes.config4_instances(device, resolution,
                                       n_instances=n_instances)


def pass_inputs(device, rig, resolution, t):
    """The first pass of one frame as the main path feeds it: the cached
    triangle tables, the MVPs, viewport and scissor."""
    import tyleri_tpu_torch as tt

    rf = tt.ForwardRenderingFunction(device, tt.ImageViewSwapchain(resolution))
    scene = tt.RenderScene()
    rig.fill(scene, t)
    inputs = rf.build_frame_inputs(device, scene.render_resources, 1.0,
                                   resolution)
    (texels, toff, tw, th, _, _, viewports, scissors, mvps, corners,
     tri_draw, tri_valid0, tri_tex) = inputs[:13]
    return rf, dict(corners=corners[0], tri_draw=tri_draw[0],
                    tri_tex=tri_tex[0], tri_valid=tri_valid0[0],
                    mvps=mvps[0], viewport=viewports[0], scissor=scissors[0])


def binned_pass(rf, sp):
    """Setup, near clip and binning of one pass, as mesh_pass_fused runs
    them, with the spill and broad capacities grown as the frame loop
    grows them on overflow until nothing is dropped.  Returns the table,
    the tile dims and the setup rows the table was gathered from."""
    from tyleri_tpu_torch.ops import setup_cuda
    from tyleri_tpu_torch.ops.binning import bin_triangles, spill_rows
    from tyleri_tpu_torch.rendering.passes import (
        _fused_clip_subset,
        setup_dims,
    )

    plan = rf.plan.raster
    dims = setup_dims(plan)
    su, _, crossed = setup_cuda.fused_setup(
        sp["corners"], sp["tri_draw"], sp["tri_tex"], sp["tri_valid"],
        sp["mvps"], True, sp["viewport"], sp["scissor"], **dims)
    su, _ = _fused_clip_subset(
        su, crossed, (sp["corners"], sp["tri_draw"], sp["tri_tex"]),
        sp["mvps"], sp["viewport"], sp["scissor"], rf.mesh_state,
        plan.clip_cap, dims)
    spill_cap, broad_cap = plan.spill_cap, plan.broad_cap
    for _ in range(8):
        binned = bin_triangles(
            su, grid_w=plan.grid_w, grid_h=plan.grid_h,
            entry_cap=(rf.plan.tri_cap + plan.clip_cap + spill_rows(
                spill_cap, plan.max_tiles_per_tri)),
            max_tiles_per_tri=plan.max_tiles_per_tri, broad_cap=broad_cap,
            spill_cap=spill_cap)
        if not int(binned.overflow):
            return binned, dims, su
        spill_cap, broad_cap = 2 * spill_cap, 4 * broad_cap
    raise AssertionError(f"binning overflow {int(binned.overflow)}")


def phase_setup(device, T, resolution, records, grid_n=420):
    """K1+K2 against its plain version: bit-equal on a random table with
    every kind of row and on the sponza table; times at the sponza shape."""
    from tyleri_tpu_torch.ops import setup_cuda
    from tyleri_tpu_torch.rendering.passes import setup_dims

    W, H = resolution
    viewport = np.asarray([0, 0, W, H, 0, 1], np.float32)
    scissor = np.asarray([0, 0, W, H], np.int32)
    rf, sp = pass_inputs(device, sponza_rig(device, resolution, grid_n),
                         resolution, 1.0)
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
    su, _, crossed = got
    rows = args[0].shape[0]
    records["fused_setup"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound_fields(bound(
            bytes_of(*args[:5], su.channels, su.valid, su.tile_lo,
                     su.tile_hi, crossed), K1K2_OPS_PER_ROW * rows)))
    log("k1k2", f"bit-equal on {T} random rows and {rows} sponza "
        f"rows ({n_live} live, {int(got[1])} crossers); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms; {share(records['fused_setup'])}; no "
        f"single PyTorch call computes it")
    return rf, sp


def phase_visibility(device, rf, sp, resolution, records):
    """K3 (base) against its plain version on one sponza frame's binned
    table; how many pixels its early exit changed against the no-exit
    resolve.  Returns the table for the counter's phase."""
    from tyleri_tpu_torch.ops import raster_cuda

    binned, dims, su = binned_pass(rf, sp)
    W, H = resolution
    depth0 = torch.ones((H, W), device=device)
    kw = dict(fb_w=W, fb_h=H, depth_state=rf.mesh_state.depth, **dims)
    chunk = rf.plan.raster.chunk
    got = raster_cuda.rasterize_visibility(binned, depth0, sp["scissor"],
                                           chunk=chunk, **kw)
    want = raster_cuda.rasterize_visibility_stream_reference(
        binned, depth0, sp["scissor"], chunk=chunk, **kw)
    err = max_abs_err([(getattr(got, f), getattr(want, f))
                       for f in FLOAT_MAPS])
    if not layers_bit_equal(got, want):
        bad = (got.depth != want.depth) | (got.owner != want.owner)
        raise AssertionError(
            f"rasterize_visibility differs from its plain version at "
            f"{int(bad.sum())} pixels")
    exact = raster_cuda.rasterize_visibility_reference(
        binned, depth0, sp["scissor"], **kw)
    moved = int(((got.depth != exact.depth) | (got.tex != exact.tex)).sum())
    if moved > EXIT_MOVED_MAX * W * H:
        raise AssertionError(f"the early exit moved {moved} px off the "
                             f"no-exit resolve (bound {EXIT_MOVED_MAX:.3%})")
    ms = cuda_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], chunk=chunk, **kw), reps=20)
    plain_ms = cuda_ms(
        lambda: raster_cuda.rasterize_visibility_stream_reference(
            binned, depth0, sp["scissor"], chunk=chunk, **kw), reps=1,
        warmup=0)
    records["rasterize_visibility"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms, library_ms=None)
    # the probes' yardstick: K3 timed as they are, over a CUDA graph
    records["k3_graph_ms"] = graph_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], chunk=chunk, **kw), reps=20)
    log("k3", f"bit-equal on the full {W}x{H} frame ({int(binned.num_entries)}"
        f" entries, {int(binned.num_broad)} broad, "
        f"{int((got.owner >= 0).sum())} covered px); kernel {ms:.4f} ms "
        f"({records['k3_graph_ms']:.4f} ms by CUDA graph), plain "
        f"{plain_ms:.4f} ms; the early exit moved {moved} px off the "
        f"no-exit resolve (bound {EXIT_MOVED_MAX * W * H:.0f})")
    return binned, kw, depth0, su


def phase_counts(binned, kw, depth0, scissor, chunk, records, launches):
    """The early-exit measurement: K3's visit counter on the sponza table
    (its own path, counted), then against the stream plain version."""
    from tyleri_tpu_torch.ops import raster_cuda

    raster_cuda.reset_launches()
    vis, nvis = raster_cuda.rasterize_visibility(
        binned, depth0, scissor, chunk=chunk, counts=True, **kw)
    launches["counts"] = dict(raster_cuda.variant_launches)
    want, want_nvis = raster_cuda.rasterize_visibility_stream_reference(
        binned, depth0, scissor, chunk=chunk, counts=True, **kw)
    if not (layers_bit_equal(vis, want) and torch.equal(nvis, want_nvis)):
        bad = int((nvis != want_nvis).sum())
        raise AssertionError(f"the visit counter differs from its plain "
                             f"version ({bad} tiles' counts differ)")
    ms = cuda_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, scissor, chunk=chunk, counts=True, **kw), reps=20)
    plain_ms = cuda_ms(
        lambda: raster_cuda.rasterize_visibility_stream_reference(
            binned, depth0, scissor, chunk=chunk, counts=True, **kw),
        reps=1, warmup=0)
    err = max_abs_err([(getattr(vis, f), getattr(want, f))
                       for f in FLOAT_MAPS])
    n = int(binned.num_entries)
    visited = int(nvis.sum())
    tile_px = kw["tile_w"] * kw["tile_h"]
    records["rasterize_visibility_counts"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **k3_bound(binned, depth0, visited, "counts", tile_px))
    # the base variant visits the same entries (the same exit)
    records["rasterize_visibility"].update(
        k3_bound(binned, depth0, visited, "base", tile_px))
    seg = binned.tile_start[1:] - binned.tile_start[:-1]
    log("k3-counts", f"maps and per-tile counts equal on the sponza table; "
        f"the early exit skipped {n - visited} of {n} narrow entries "
        f"({(n - visited) / max(n, 1):.2%}) at chunk {chunk}; tiles skipping "
        f"some {int(((seg - nvis.flatten()) > 0).sum())} of {seg.numel()}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"{share(records['rasterize_visibility_counts'])}; base "
        f"{share(records['rasterize_visibility'])}; no single PyTorch call "
        f"computes K3")


def peel2_check(binned, depth0, scissor, kw, what):
    """K3 peel2 against the stream plain version: both layers bit for
    bit.  Returns (vis, vis2, max_abs_err)."""
    from tyleri_tpu_torch.ops import raster_cuda

    got = raster_cuda.rasterize_visibility(binned, depth0, scissor,
                                           peel2=True, **kw)
    want = raster_cuda.rasterize_visibility_stream_reference(
        binned, depth0, scissor, peel2=True, **kw)
    for layer, (g, w) in enumerate(zip(got, want), 1):
        if not layers_bit_equal(g, w):
            bad = int(((g.depth != w.depth) | (g.owner != w.owner)).sum())
            raise AssertionError(f"peel2 layer {layer} differs from its "
                                 f"plain version at {bad} px on {what}")
    err = max_abs_err([(getattr(g, f), getattr(w, f))
                       for g, w in zip(got, want) for f in FLOAT_MAPS])
    return got[0], got[1], err


def phase_peel2(build_device, resolution, records, n_instances=100,
                overdraw_res=(960, 540)):
    """K3 peel2 against its plain version on one config-4 frame's table and
    on the adversarial overdraw table, every depth state."""
    from tyleri_tpu_torch import CompareOp, DepthFormat, DepthState
    from tyleri_tpu_torch.ops import raster_cuda
    from tyleri_tpu_torch.testing.overdraw import overdraw_table

    dev = build_device()
    rf, sp = pass_inputs(dev, config4_rig(dev, resolution, n_instances),
                         resolution, 0.5)
    binned, dims, _ = binned_pass(rf, sp)
    W, H = resolution
    depth0 = torch.ones((H, W), device=dev.device)
    kw = dict(fb_w=W, fb_h=H, depth_state=rf.mesh_state.depth,
              chunk=rf.plan.raster.chunk, **dims)
    vis, vis2, err = peel2_check(binned, depth0, sp["scissor"], kw,
                                 "the config-4 table")
    ms = cuda_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], peel2=True, **kw), reps=20)
    plain_ms = cuda_ms(
        lambda: raster_cuda.rasterize_visibility_stream_reference(
            binned, depth0, sp["scissor"], peel2=True, **kw), reps=1,
        warmup=0)
    base_ms = cuda_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], **kw), reps=20)
    # the entries the layer-1 exit visits: peel2's exit, on the deeper
    # layer, visits at least these, so the bound stays a lower bound
    _, nvis = raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], counts=True, **kw)
    peel2_bound = k3_bound(binned, depth0, int(nvis.sum()), "peel2",
                           dims["tile_w"] * dims["tile_h"])
    log("k3-peel2", f"both layers bit-equal on the config-4 {W}x{H} table "
        f"({int(binned.num_entries)} entries, {int((vis.owner >= 0).sum())} "
        f"px covered, {int((vis2.owner >= 0).sum())} with a layer 2, "
        f"{int(((vis2.owner < 0) & (vis2.order >= 0)).sum())} gated); "
        f"kernel {ms:.4f} ms (base variant on the same table {base_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms; {share(dict(peel2_bound, ms=ms))}")

    OW, OH = overdraw_res
    rng = np.random.default_rng(7)
    table, odims = overdraw_table(dev.device, rng, OW, OH)
    if int(table.overflow):
        raise AssertionError("overdraw table overflowed")
    for op in (CompareOp.LESS_OR_EQUAL, CompareOp.LESS):
        for fmt in (DepthFormat.D16_UNORM, DepthFormat.D32_SFLOAT):
            ds = DepthState(test_enable=True, write_enable=True,
                            compare_op=op, format=fmt)
            v1, v2, e = peel2_check(
                table, torch.ones((OH, OW), device=dev.device), (0, 0, OW, OH),
                dict(depth_state=ds, chunk=16, **odims),
                f"the overdraw table ({op.name}, {fmt.name})")
            err = max(err, e)
            log("k3-peel2", f"overdraw {OW}x{OH} {op.name} {fmt.name}: "
                f"bit-equal; {int(table.num_entries)} entries, "
                f"{int(table.num_broad)} broad, layer 2 at "
                f"{float((v2.owner >= 0).float().mean()):.1%} of px, gated "
                f"at {float(((v2.owner < 0) & (v2.order >= 0)).float().mean()):.1%}")
    records["rasterize_visibility_peel2"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **peel2_bound)


def render_frames(win, rig, times):
    for t in times:
        rig.fill(win.get_render_scene(), t)
        win.render()
    return win.flush()


def phase_small_configs(build_device, launches, res3=(800, 600)):
    """Configs 1, 2 and 3 (lit) through RenderWindow with peel2, against
    the sequential oracle."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.testing.scene_oracle import (
        mismatch_fraction,
        scene_oracle_u8,
    )

    for name, make, t, tol in (
            ("config1", tt.scenes.config1_triangle, 0.0, 0),
            ("config2", tt.scenes.config2_cube, 0.9, 0),
            # lit golden tolerance 6e-3 (tests/test_raster_golden.py:448)
            ("config3", lambda d: tt.scenes.config3_suzanne(d, res3), 0.3,
             1)):
        dev = build_device()
        rig = make(dev)
        win = tt.RenderWindow(dev, resolution=rig.resolution,
                              present_mode="immediate")
        setup_cuda.reset_launches()
        raster_cuda.reset_launches()
        img = render_frames(win, rig, [t])
        launches[name] = dict(raster_cuda.variant_launches,
                              fused_setup=setup_cuda.launches)
        plan = win.rendering_function.plan
        if not plan.raster.peel2 or plan.lit != (name == "config3"):
            raise AssertionError(f"{name}: peel2 {plan.raster.peel2}, lit "
                                 f"{plan.lit}")
        if launches[name]["peel2"] != 1 or launches[name]["base"]:
            raise AssertionError(f"{name}: launches {launches[name]}")
        scene = tt.RenderScene()
        rig.fill(scene, t)
        want = scene_oracle_u8(dev, scene.render_resources,
                               win.rendering_function.mesh_state,
                               rig.resolution, sequential=True)
        bad = mismatch_fraction(img, want, tol)
        if img.shape != want.shape or bad > BUDGET:
            raise AssertionError(f"{name}: {bad:.4%} pixels more than {tol} "
                                 f"u8 off the sequential oracle (budget "
                                 f"{BUDGET:.2%})")
        log(name, f"{rig.resolution[0]}x{rig.resolution[1]}"
            f"{' lit' if plan.lit else ''}, peel2: {bad:.4%} px more than "
            f"{tol} u8 off the sequential oracle (budget {BUDGET:.2%}); "
            f"launches {launches[name]}")


def converge(win, rig, t, max_frames=160, orbit=()):
    """Frames until the clip skip and fit stage 2 engaged."""
    rf = win.rendering_function
    seen = dict(clip_cap=rf.plan.raster.clip_cap, near_clip_off=False,
                fit_stage=0)
    frames = 0
    t0 = time.perf_counter()
    for ft in list(orbit) + [t] * max_frames:
        rig.fill(win.get_render_scene(), ft)
        win.render()
        frames += 1
        seen["clip_cap"] = max(seen["clip_cap"], rf.plan.raster.clip_cap)
        seen["near_clip_off"] |= not rf.plan.raster.near_clip
        seen["fit_stage"] = max(seen["fit_stage"], rf._fit_stage)
        if (frames > len(orbit) and seen["near_clip_off"]
                and seen["fit_stage"] == 2):
            break
    win.flush()
    if not (seen["near_clip_off"] and seen["fit_stage"] == 2):
        raise AssertionError(f"adaptive stages did not all engage: {seen}")
    return frames, time.perf_counter() - t0, seen


def steady(win, rig, t, messages, frames=30):
    """The converged plan's steady frame time: CUDA events on the frame
    loop's stream and the host clock around ``frames`` renders, with the
    card's sync debug mode on.  Returns (ms, host_ms, image)."""
    rf = win.rendering_function
    stream = win.render_device.queue.stream
    n_msgs = len(messages)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    render_frames(win, rig, [t] * 3)   # the last fits reach the plan
    plan_before = rf.plan
    # the frame loop must not wait on its own stream: a synchronizing op
    # (a blocking host<->device copy, a value read) would serialize host
    # and card
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        start.record(stream)
        h0 = time.perf_counter()
        for _ in range(frames):
            rig.fill(win.get_render_scene(), t)
            win.render()
        end.record(stream)
        img_a = win.flush()
        host_ms = (time.perf_counter() - h0) * 1e3 / frames
    torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in syncs if "synchroniz" in str(w.message)]
    end.synchronize()
    ms = start.elapsed_time(end) / frames
    img_b = render_frames(win, rig, [t])
    overflow = [m for m in messages[n_msgs:]
                if m.message_id == "capacity-overflow"]
    if overflow:
        raise AssertionError(f"overflow after convergence: {overflow[0]}")
    if syncs:
        raise AssertionError(f"the frame loop synchronized: {syncs[0].message}")
    if rf.plan != plan_before:
        raise AssertionError("the plan changed during the steady window")
    if not np.array_equal(img_a, img_b):
        raise AssertionError("two renders of the same frame differ")
    return ms, host_ms, img_a


def phase_config4(build_device, resolution, launches, n_instances=100):
    """Config 4 through RenderWindow under "auto" (peel2) and "fast":
    convergence, steady frame times in turns (auto, fast, fast, auto), and
    the deviation from the sequential oracle of each."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.testing.scene_oracle import (
        mismatch_fraction,
        scene_oracle_u8,
    )

    t = 0.5
    msgs = []
    dev = build_device(callback=msgs.append)
    rig = config4_rig(dev, resolution, n_instances)
    wins, frames = {}, {}
    for policy in ("auto", "fast"):
        win = tt.RenderWindow(dev, resolution=resolution,
                              present_mode="immediate", blend_parity=policy)
        setup_cuda.reset_launches()
        raster_cuda.reset_launches()
        n, warm_s, _ = converge(win, rig, t)
        frames[policy] = n
        wins[policy] = win
        plan = win.rendering_function.plan.raster
        log("config4", f"{policy}: {resolution[0]}x{resolution[1]}, "
            f"{rig.triangle_count} tris in {n_instances} draws, peel2 "
            f"{plan.peel2}: {n} frames to converge ({warm_s:.1f} s, fit "
            f"stage 2, clip skip, entry_cap {plan.entry_cap})")
    times = {"auto": [], "fast": []}
    images = {}
    for policy in ("auto", "fast", "fast", "auto"):
        win = wins[policy]
        setup_cuda.reset_launches()
        raster_cuda.reset_launches()
        ms, host_ms, images[policy] = steady(win, rig, t, msgs)
        counted = dict(raster_cuda.variant_launches,
                       fused_setup=setup_cuda.launches)
        n = 3 + 30 + 1
        variant = "peel2" if policy == "auto" else "base"
        if (win.rendering_function.plan.raster.peel2 != (policy == "auto")
                or counted[variant] != n or raster_cuda.launches() != n
                or counted["fused_setup"] != n):
            raise AssertionError(f"config4 {policy}: launches {counted} for "
                                 f"{n} frames")
        key = f"config4_{policy}"
        launches[key] = {k: launches.get(key, {}).get(k, 0) + v
                         for k, v in counted.items()}
        times[policy].append((ms, host_ms))
    for policy in ("auto", "fast"):
        (a, ha), (b, hb) = times[policy]
        covered = float((images[policy][..., :3] > 0).any(axis=-1).mean())
        log("config4", f"{policy} steady, two windows of 30 frames: "
            f"{a:.3f} and {b:.3f} ms/frame by CUDA events (mean "
            f"{(a + b) / 2:.3f}, {2e3 / (a + b):.2f} FPS), {ha:.3f} and "
            f"{hb:.3f} ms/frame by host clock; no overflow, no synchronizing"
            f" call, one K3 launch per frame; {covered:.1%} px covered")

    scene = tt.RenderScene()
    rig.fill(scene, t)
    t0 = time.perf_counter()
    want = scene_oracle_u8(dev, scene.render_resources,
                           wins["auto"].rendering_function.mesh_state,
                           resolution, sequential=True)
    oracle_s = time.perf_counter() - t0
    off = {policy: mismatch_fraction(images[policy], want, 1)
           for policy in ("auto", "fast")}
    if not off["auto"] < off["fast"]:
        raise AssertionError(f"peel2 is not closer to the sequential oracle: "
                             f"{off}")
    log("config4", f"{resolution[0]}x{resolution[1]} against the sequential "
        f"f64 oracle ({oracle_s:.1f} s): {off['auto']:.4%} px more than 1 u8 "
        f"off with peel2, {off['fast']:.4%} with one layer")


def phase_sponza(build_device, resolution, launches, grid_n=420):
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
    frames, warm_s, seen = converge(win, rig, 0.0, max_frames=96,
                                    orbit=orbit)
    counted = (setup_cuda.launches, raster_cuda.variant_launches["base"])
    if counted != (frames, frames) or raster_cuda.launches() != frames:
        raise AssertionError(f"kernel launches {counted} for {frames} "
                             "frames of one pass each")
    if rf.plan.raster.peel2:
        raise AssertionError(f"peel2 engaged at {rig.triangle_count} "
                             "triangles")
    log("config5", f"{frames} frames to converge ({warm_s:.1f} s): clip_cap "
        f"grew to {seen['clip_cap']}, clip skip engaged, fit stage 2; plan "
        f"entry_cap {rf.plan.raster.entry_cap}, valid_cap "
        f"{rf.plan.raster.valid_cap}, peel2 off; launches {counted}")
    ms, host_ms, img_a = steady(win, rig, 0.0, messages)
    launches["config5"] = dict(raster_cuda.variant_launches,
                               fused_setup=setup_cuda.launches)
    if img_a.shape != (resolution[1], resolution[0], 4):
        raise AssertionError(f"image shape {img_a.shape}")
    covered = float((img_a[..., :3] > 0).any(axis=-1).mean())
    if covered < 0.5:
        raise AssertionError(f"only {covered:.1%} of the frame covered")
    mtris = rig.triangle_count / (ms * 1e-3) / 1e6
    log("config5", f"{resolution[0]}x{resolution[1]}, {rig.triangle_count} "
        f"tris: steady {ms:.3f} ms/frame by CUDA events ({1e3 / ms:.2f} FPS,"
        f" {mtris:.1f} Mtris/s), {host_ms:.3f} ms/frame by host clock; "
        f"no synchronizing call in 30 frames; no overflow; identical images; "
        f"{covered:.1%} px covered")


# the probe kernels, the TPU kernels they replace, the tool and variant
# whose time stands in the kernels line, and the kernel's source in csrc/
PROBES = (
    ("gather_rows", "tools/exp_binning.py:108", "exp_binning",
     "sorted_t1m_c32", "probes.cu"),
    ("fixed_grid", "tools/exp_fixed_grid.py:32", "exp_fixed_grid",
     "rows16_outs7_zmax", "probes.cu"),
    ("fixed_cost", "tools/exp_fixedcost.py:43", "exp_fixedcost",
     "empty_full", "probes.cu"),
    ("fill", "tools/exp_fixedcost.py:162", "exp_fixedcost",
     "launch_68x15_16x128", "probes.cu"),
    ("pipe_cost", "tools/exp_pipecost.py:42", "exp_pipecost", "v_loop1",
     "probes.cu"),
    ("visibility_variant", "tools/exp_visibility.py:30", "exp_visibility",
     "base", "probes_visibility.cu"),
    ("visibility_packed", "tools/exp_visibility.py:580", "exp_visibility",
     "packed5", "probes_visibility.cu"),
    ("mxu", "tools/exp_mxu.py:49", "exp_mxu", "fat4_hst", "probes_mxu.cu"),
    ("transpose_rows", "tools/exp_mosaic_probe.py:26", "exp_mosaic_probe",
     "transpose", "probes.cu"),
    ("field_compute", "tools/exp_mosaic_probe.py:53", "exp_mosaic_probe",
     "compute", "probes.cu"),
)


def entry_ids(table, entries):
    """The row of ``table`` that each entry row copies bit for bit (the ids
    binning gathered by), found by hashing the rows' bits."""
    g = torch.Generator().manual_seed(0)
    w = (torch.randint(1, 1 << 62, (table.shape[1],), generator=g)
         | 1).to(table.device)

    def h(x):
        return (x.contiguous().view(torch.int32).to(torch.int64) * w).sum(1)

    ht, order = torch.sort(h(table))
    pos = torch.searchsorted(ht, h(entries)).clamp(max=ht.numel() - 1)
    ids = order[pos].to(torch.int32)
    if not torch.equal(table[ids.long()].view(torch.int32),
                       entries.view(torch.int32)):
        raise AssertionError("entry rows not found in the setup table")
    return ids


def check_bit_equal(what, got, want) -> float:
    """Fails unless every output equals its plain version bit for bit;
    returns their max_abs_err."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g.dtype != w.dtype or not torch.equal(g.view(torch.int32),
                                                 w.view(torch.int32)):
            bad = int((g != w).sum()) if g.shape == w.shape else g.shape
            raise AssertionError(f"{what}: output {i} differs from its "
                                 f"plain version ({bad})")
    return max_abs_err(zip(got, want))


def phase_probes(device, card, records, launches, sponza_gather, reps=20,
                 vis_size=((1920, 1080), 420), mxu_grid=None):
    """The probe tools' entry points (their path, counted), whose times by
    CUDA graph stand in the kernels line; then every probe kernel against
    its plain version at full width, and the plain version's time
    (``vis_size``, P3's frame and sponza grid, and ``mxu_grid``, P2's
    tiles, are smaller in a rehearsal on the CPU).  Returns [(kernel name,
    TPU kernel replaced)]."""
    import contextlib
    import io

    from tyleri_tpu_torch.tools import (
        exp_binning,
        exp_fixed_grid,
        exp_fixedcost,
        exp_mosaic_probe,
        exp_mxu,
        exp_pipecost,
        exp_visibility,
    )

    tools = (exp_binning, exp_fixed_grid, exp_fixedcost, exp_pipecost,
             exp_visibility, exp_mxu, exp_mosaic_probe)
    vis_tables = exp_visibility.Tables(device, *vis_size)  # sponza, binned
    extra = {exp_visibility: dict(tables=vis_tables),
             exp_mxu: dict(grid=mxu_grid)}
    for tool in tools:
        tool.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        timed = {(rec["tool"], rec["variant"]): rec for tool in tools
                 for rec in tool.run_variants(device, reps, card,
                                              **extra.get(tool, {}))}
    launches["probes"] = {k: v for tool in tools
                          for k, v in tool.launches.items()}
    for line in out.getvalue().splitlines():
        log("probes", line.replace('"', "'"))
    err, plain_ms = {}, {}

    # P4: the tool's shapes, then the port's binning gather of sponza
    ids, table = exp_binning.tool_inputs(device)
    err["gather_rows"] = check_bit_equal(
        "gather_rows", exp_binning.gather_rows(ids, table),
        exp_binning.gather_rows_reference(ids, table))
    plain_ms["gather_rows"] = cuda_ms(
        lambda: exp_binning.gather_rows_reference(ids, table), reps=1)
    stable, entries = sponza_gather
    stable = stable.contiguous()
    sids = entry_ids(stable, entries)
    err["gather_rows"] = max(err["gather_rows"], check_bit_equal(
        "gather_rows (sponza)", exp_binning.gather_rows(sids, stable),
        exp_binning.gather_rows_reference(sids, stable)))
    sids64 = sids.long()
    slib_ms, sms, sms2, slib_ms2 = (graph_ms(f, reps) for f in (
        lambda: torch.index_select(stable, 0, sids64),
        lambda: exp_binning.gather_rows(sids, stable),
        lambda: exp_binning.gather_rows(sids, stable),
        lambda: torch.index_select(stable, 0, sids64)))
    # binning's own call (ops/binning.py): advanced indexing
    index_ms = graph_ms(lambda: stable[sids64], reps)
    sb = dict(exp_binning.gather_bound(sids, stable), ms=(sms + sms2) / 2)
    log("probes", f"P4 gather_rows at the sponza 1080p binning gather, "
        f"{sids.numel()} ids in tile order into {tuple(stable.shape)} f32: "
        f"bit-equal; by CUDA graph, kernel {sms:.4f} and {sms2:.4f} ms, "
        f"torch.index_select {slib_ms:.4f} and {slib_ms2:.4f} ms (in turns),"
        f" binning's table[ids] {index_ms:.4f} ms; {share(sb)}")
    del ids, table, stable, entries, sids, sids64

    # P7
    depth = exp_fixed_grid.depth_input(device)
    depth[::97, ::89] = 2.5   # blocks whose max adds 1.0
    err["fixed_grid"] = max(
        check_bit_equal(f"fixed_grid rows {rows}",
                        exp_fixed_grid.fixed_grid(depth, rows, nouts, zmax),
                        exp_fixed_grid.fixed_grid_reference(depth, rows,
                                                            nouts, zmax))
        for rows, nouts, zmax in ((16, 7, True), (128, 7, True),
                                  (32, 3, False), (64, 1, True)))
    plain_ms["fixed_grid"] = cuda_ms(
        lambda: exp_fixed_grid.fixed_grid_reference(depth, 16), 5)

    # P6
    table, tiny, depth0, ts_empty = exp_fixedcost.tool_inputs(device)
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 300, ts_empty.numel() - 1) * (
        rng.random(ts_empty.numel() - 1) < 0.7)
    ts_seg = torch.from_numpy(np.concatenate([[3], 3 + np.cumsum(lens)])
                              .astype(np.int32)).to(device)
    err["fixed_cost"] = max(
        check_bit_equal("fixed_cost",
                        exp_fixedcost.fixed_cost(tab, ts, depth0, n_out=n_out),
                        exp_fixedcost.fixed_cost_reference(tab, ts, depth0,
                                                           n_out=n_out))
        for tab, ts, n_out in ((table, ts_empty, 7), (tiny, ts_empty, 1),
                               (table, ts_seg, 7)))
    plain_ms["fixed_cost"] = cuda_ms(lambda: exp_fixedcost.fixed_cost_reference(
        table, ts_empty, depth0, n_out=7), 5)
    err["fill"] = max(
        check_bit_equal("fill", [exp_fixedcost.fill(*shape, device)],
                        [exp_fixedcost.fill_reference(*shape, device)])
        for shape in exp_fixedcost.LAUNCH_VARIANTS.values())
    shape = exp_fixedcost.LAUNCH_VARIANTS["launch_68x15_16x128"]
    plain_ms["fill"] = cuda_ms(
        lambda: exp_fixedcost.fill_reference(*shape, device), 20)
    del table, tiny, ts_seg

    # P1
    entries, ts_zero, ts_one = exp_pipecost.tool_inputs(device)
    err["pipe_cost"] = 0.0
    for name, kw in exp_pipecost.VARIANTS.items():
        ts = ts_one if kw["ts"] == "one" else ts_zero
        args = dict(nout=kw["nout"], level=kw["level"])
        err["pipe_cost"] = max(err["pipe_cost"], check_bit_equal(
            f"pipe_cost {name}",
            exp_pipecost.run(entries, ts, tpp=kw["tpp"], **args),
            exp_pipecost.pipe_cost_reference(entries, ts, **args)))
    plain_ms["pipe_cost"] = cuda_ms(lambda: exp_pipecost.pipe_cost_reference(
        entries, ts_one, nout=7, level=2), 2)

    # P3: every variant whose maps differ, on the sponza tables
    for name in exp_visibility.RESULT_DISTINCT:
        key = "visibility_packed" if "packed" in name else \
            "visibility_variant"
        table, ts, kw, _, _ = vis_tables.inputs(name)
        got = vis_tables.run(name, table, ts, kw)
        want = vis_tables.reference(name, table, ts, kw)
        err[key] = max(err.get(key, 0.0), check_bit_equal(
            f"P3 {name}", [*got[0], got[1]], [*want[0], want[1]]))
    for name, key in (("base", "visibility_variant"),
                      ("packed5", "visibility_packed")):
        table, ts, kw, _, _ = vis_tables.inputs(name)
        plain_ms[key] = cuda_ms(lambda: vis_tables.reference(
            name, table, ts, kw), reps=1, warmup=0)
    log("probes", f"P3 bit-equal (maps and resolved counts) on the sponza "
        f"1080p tables for {', '.join(exp_visibility.RESULT_DISTINCT)}")
    del vis_tables, table, got, want

    # P2: exact tables (every variant equal), then the tool's table
    ent, ts, grid = exp_mxu.tool_inputs(device, grid=mxu_grid)
    exact = {split: exp_mxu.exact_inputs(device, grid=grid, split=split)
             for split in (False, True)}
    err["mxu"], shares = 0.0, {}
    for name in exp_mxu.VARIANTS:
        opts = exp_mxu.options(name)
        kw = dict(grid=grid, grid_w=exp_mxu.grid_dims(16)[0], chunk=128,
                  **opts)
        e_ent, e_ts = exact[opts["split"]]
        if not torch.equal(exp_mxu.run_mxu(e_ent, e_ts, **kw),
                           exp_mxu.mxu_reference(e_ent, e_ts, **kw)):
            raise AssertionError(f"P2 {name} differs from its plain version "
                                 "on the exact table")
        shares[name], e = exp_mxu.compare(
            exp_mxu.run_mxu(ent, ts, **kw),
            exp_mxu.mxu_reference(ent, ts, **kw), ent, opts, 2)
        if shares[name] > exp_mxu.MAX_DIFFERING:
            raise AssertionError(f"P2 {name}: {shares[name]:.3%} of pixels "
                                 f"beyond the tolerance (limit "
                                 f"{exp_mxu.MAX_DIFFERING:.1%})")
        err["mxu"] = max(err["mxu"], e)
    hst = dict(grid=grid, grid_w=exp_mxu.grid_dims(16)[0], chunk=128,
               **exp_mxu.options("fat4_hst"))
    plain_ms["mxu"] = cuda_ms(lambda: exp_mxu.mxu_reference(ent, ts, **hst),
                              reps=1, warmup=0)
    log("probes", f"P2 equal on the exact tables for every variant; on the "
        f"tool's table the share of pixels with another winner or beyond "
        f"the tolerance: " + ", ".join(f"{k} {v:.4%}"
                                       for k, v in shares.items())
        + f"; max |diff| of the others {err['mxu']:.3g}")
    del ent, ts, exact

    # P5 at the tool's 2^20 rows
    x_t, x_c = exp_mosaic_probe.tool_inputs(device)
    x_r = torch.randn(x_c.shape, device=device)
    err["transpose_rows"] = check_bit_equal(
        "P5 transpose", [exp_mosaic_probe.transpose(x_t)],
        [exp_mosaic_probe.transpose_reference(x_t)])
    err["field_compute"] = check_bit_equal(
        "P5 compute", [exp_mosaic_probe.compute(x_r)],
        [exp_mosaic_probe.compute_reference(x_r)])
    plain_ms["transpose_rows"] = cuda_ms(
        lambda: exp_mosaic_probe.transpose_reference(x_t), 5)
    plain_ms["field_compute"] = cuda_ms(
        lambda: exp_mosaic_probe.compute_reference(x_r), 5)

    k3_ms = records["k3_graph_ms"]
    for name, _, tool, variant, _ in PROBES:
        r = timed[(tool, variant)]
        records[name] = dict(
            max_abs_err=err[name], ms=r["ms"], plain_ms=plain_ms[name],
            library_ms=r.get("library_ms"), **bound_fields(r))
        log("probes", f"{name} ({variant}): checked; kernel "
            f"{r['ms']:.4f} ms by CUDA graph, plain {plain_ms[name]:.4f} ms; "
            f"{share(records[name])}; {r['ms'] / k3_ms:.1%} of K3's "
            f"{k3_ms:.4f} ms by CUDA graph on the sponza table")
    log("probes", f"launches on the tools' path {launches['probes']}")
    return [(name, replaces, source) for name, replaces, _, _, source
            in PROBES]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tyleri_tpu_torch import _build
    from tyleri_tpu_torch.device.builders import (
        RenderDeviceBuilder,
        ValidationLevel,
    )

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.load()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.1f}"
        f" s ({_build.library_path()})")
    log("build", "registers (spill-store bytes) by ptxas: " + "; ".join(
        f"{k} {r} ({s} B)"
        for k, (r, s) in sorted(_build.kernel_resources().items())))

    def build_device(callback=None):
        b = RenderDeviceBuilder().validation_level(ValidationLevel.WARNING)
        return b.debug_callback(callback).build()

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        log("time", f"{name} {time.perf_counter() - t:.1f} s")
        return out

    device = build_device().device
    records, launches = {}, {}
    rf, sp = phase("k1k2", phase_setup, build_device(), 1 << 20, SPONZA_RES,
                   records)
    binned, kw, depth0, su = phase("k3", phase_visibility, device, rf, sp,
                                   SPONZA_RES, records)
    phase("k3-counts", phase_counts, binned, kw, depth0, sp["scissor"],
          rf.plan.raster.chunk, records, launches)
    # the port's binning gather of this frame, for the probes' phase
    n = int(binned.num_entries)
    sponza_gather = (su.channels, binned.entry_channels[:n])
    del rf, sp, binned, depth0, su
    torch.cuda.empty_cache()
    phase("k3-peel2", phase_peel2, build_device, SPONZA_RES, records)
    torch.cuda.empty_cache()
    phase("configs 1-3", phase_small_configs, build_device, launches)
    phase("config4", phase_config4, build_device, SPONZA_RES, launches)
    phase("config5", phase_sponza, build_device, SPONZA_RES, launches)
    torch.cuda.empty_cache()
    probe_kernels = phase("probes", phase_probes, device, card, records,
                          launches, sponza_gather)

    def path_sum(key):
        return sum(c.get(key, 0) for c in launches.values())

    kernels = [
        dict(name="fused_setup", route="cuda",
             source="tyleri_tpu_torch/csrc/fused_setup.cu",
             replaces="tyleri_tpu/ops/setup_pallas.py:71,163",
             launches=path_sum("fused_setup"), **records["fused_setup"]),
        dict(name="rasterize_visibility", route="cuda",
             source="tyleri_tpu_torch/csrc/visibility.cu", replaces=K3,
             launches=path_sum("base"), **records["rasterize_visibility"]),
        dict(name="rasterize_visibility_peel2", route="cuda",
             source="tyleri_tpu_torch/csrc/visibility.cu", replaces=K3,
             launches=path_sum("peel2"),
             **records["rasterize_visibility_peel2"]),
        dict(name="rasterize_visibility_counts", route="cuda",
             source="tyleri_tpu_torch/csrc/visibility.cu", replaces=K3,
             launches=path_sum("counts"),
             **records["rasterize_visibility_counts"]),
    ] + [dict(name=name, route="cuda",
              source=f"tyleri_tpu_torch/csrc/{source}", replaces=replaces,
              launches=launches["probes"][name], **records[name])
         for name, replaces, source in probe_kernels]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel no path launched: {launches}")
    for k in kernels:
        k["share"] = k["bound_ms"] / k["ms"]
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} "
        f"s; launches per path {launches}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
