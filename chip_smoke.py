"""Drive the PyTorch / CUDA port (tyleri_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each or more; any failure exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: the hand-written kernels of tyleri_tpu_torch/csrc/ with nvcc,
   and each kernel's registers and spill stores from ptxas's report;
3. k1k2: K1+K2 (fused setup) against its plain PyTorch version on a
   1M-triangle random table (crossers, back faces, degenerate and
   off-screen rows) and on the sponza table: bit-equal; the same with the
   draw masks (2, 1) and (3, 2) of a mesh's draws axis, timed on sponza
   beside the unmasked kernel;
4. k3: K3 (visibility resolve, base variant) against its plain version on
   the binned table of one sponza frame at 1920x1080: bit-equal; the
   pixels its early exit moved off the no-exit resolve, at most
   EXIT_MOVED_MAX of the frame; its time on the same table emptied (K3's
   floor);
5. k3-counts: K3's visit counter on the same table, against the stream
   plain version: equal maps and equal counts per tile; the share of narrow
   entries the early exit skipped;
5b. bin-emit: binning's entry-emit kernel against its plain version on CPU
   copies of its inputs, key2, triangle ids and placed counts equal at
   every row, on one sponza frame's first sort and at the statue cell's
   sizes (28,055,740 triangles, 32.6M entries, seeded on the card); each
   launch alone by CUDA graph and back to back, beside its byte bound;
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
10. ui: a UI overlay of 128 quads (256 triangles: a 480x270 panel of
   solid quads, two rows of glyph quads on a 16x16 texture) over config 5
   at 1920x1080, on phase 9's converged plan, at scale factors 1 and 2:
   where the UI drew, the frame equals the overlay-only frame (which holds
   to the f64 oracle within the golden budget), elsewhere the UI-free
   frame, bit for bit; the UI pass's exact-raster kernel equal to its
   plain loop on CPU copies of the frame's inputs, color and depth at
   every pixel, and (scale 1) the kernel's time alone; K3 on the frame's
   table with the UI's depth as its incoming depth, bit-equal to its plain
   version; one K1+K2, one K3 and one exact-raster (UI) launch a frame;
   steady frame times with and without the overlay in turns, and the UI
   pass's host time;
11. exact: exact mode (blend_parity="exact") for configs 1 and 2 and for
   config 4 at 1920x1080 against the sequential oracle, one launch of the
   exact-raster kernel a frame and no other; for configs 1 and 2 the
   kernel equal to its plain loop on CPU copies of the frame's inputs, at
   every pixel; config 4's deviation beside peel2's and the single
   layer's from phase 8, and its frame's seconds;
12. depth-states: config 2 at 800x600 under ALWAYS, NEVER, the test off
   and the write off (LESS_OR_EQUAL), resolved by the last-passing
   resolve, against the oracle that blends each pixel's surviving fragment
   once, with one K1+K2 and no K3 launch a frame; then with
   max_sampler_anisotropy(8): 8 taps reach the plan, the frame renders,
   and the 8-tap shade on the card equals the same call on the CPU;
13. probes: the probe tools' entry points (tyleri_tpu_torch/tools/, the
   port of the TPU tools P4, P7, P6, P1, P3, P2 and P5) time their
   variants at full width, each over a CUDA graph of 20 calls, with its
   bound (P4 beside torch.index_select, P5's transpose beside
   x.t().contiguous()); then each probe kernel against its plain version
   at the tools' shapes: bit-equal (P7 at every variant; P4 also at the
   port's binning gather of the sponza frame, timed beside
   torch.index_select and table[ids]; P3 on the sponza 1080p tables of
   every tile height, for every variant whose maps differ); P2 equal on tables whose products are exact, and on the
   tool's table within exp_mxu.compare's tolerance, the share of pixels
   with another winner printed;
14. mesh: (a) a 1x1 (draws, tiles) mesh on NCCL, world size 1: config 2 at
   800x600 through RenderWindow(device_mesh=...), equal to the single-card
   window's frame bit for bit; (b) 4 ranks on the one card over gloo (NCCL
   needs one card a rank) as a 2x2 mesh: config 5 at 1920x1080, draws 0
   and 2 on draws row 0, draw 1 on row 1, bands of 540 rows; K1+K2 (draw
   masks (2, 1) and the rank's) and K3 base on the lower band of draws row
   1, its viewport and scissor moved into the band, bit-equal to their
   plain versions; the gathered frame bit-equal to its bands and draw
   shares rendered and composited on the one card, and within 1 % of the
   single-card frame in winning triangles, in the presented image (more
   than 1 u8 off) and, where the winner is the same, in depth (more than
   SAME_WINNER_STEPS D16 steps off, none more than SAME_WINNER_MAX_DZ),
   its depth and color shares printed beside; one masked K1+K2 and one K3
   a rank a frame, every rank presenting the same image, and each rank's
   steady frame time (4 ranks share the card: no scaling figure); (c) the
   same ranks on config 4 at 1920x1080 under "auto": peel2 remaps the mesh
   to 1x4 with one message a rank; K1+K2 and K3 peel2 bit-equal to their
   plain versions on the 270-row band below the first that the frame
   covers most; bit-equal on one card likewise and within 0.2 % of the
   single-card peel2 frame;
15. host-io: (a) config 2 at 800x600 through RenderWindow with a PNG
   present target (utils/image.py's write_png on the native encoder, which
   must have built): every presented frame written, the last read back
   equal to latest_image; config 5's 1080p frame from phase 9 encoded by
   the native encoder and by the python zlib path, both read back equal,
   their times and whether their bytes are equal; (b) the device's
   pipeline cache as bytes (the kernel library, its ptxas report and the
   host runtime), seeded into a new process
   (tyleri_tpu_torch.testing.seeded_frame) that must load both libraries
   from its seeded directory with no nvcc and no g++ build and render a
   config-2 frame equal to this process's; its seconds from spawn to the
   first presented frame beside phase 2's build seconds; (c) a
   torch.profiler trace (utils/profiling.trace) of three config-2 frames,
   each under annotate("frame"): the trace file must hold the three ranges
   and the CUDA kernel events of K1+K2 and K3 peel2, which the nvcc-built
   library launches through ctypes.

Every path (7 to 15, the counter's measurement in 5, the emit in 5b)
runs with the kernels' launch counts set to 0 just before it and read
just after.  Each kernel's bound is the largest of its bytes (each input
read once, each output written once, what this run's data needs) over
3.35 TB/s, its f32
operations on the CUDA cores, each one instruction (the kernels build with
-fmad=false), over 33.5 T/s, half the 67 TFLOP/s that counts an FMA as
two, and its tensor-core flops over 989 TFLOP/s (bf16) or 495 (TF32: f32
accuracy as 3xTF32, packed into 8 products a plane) (NVIDIA H100 SXM); the
kernels line says "operations" for either kind of operation, and its
bound_kind says which of the three ("bytes", "operations" or "tensor") the
bound is.
Every kernel's time in the record is by CUDA events around a CUDA graph of
20 calls (``graph_ms``), so a wrapper's host cost drops out; K1-K3 are also
timed back to back (``back_to_back_ms``).  Each phase prints its time.  The
last three lines are the card (nvidia-smi's name and power limit), the
kernels' JSON record (each kernel's share is its bound over its time, its
``ptxas`` the registers and spill-store bytes of its instances) and
``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script fails before printing any of them.
"""

from __future__ import annotations

import contextlib
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
DRAW_MODS = ((2, 1), (3, 2))   # K1+K2's draw masks checked in phase 3
# the statue cell's sizes (benchmark/configs/lucy-28m-1080p.json): its
# triangles, and the entries binning places a frame (the binning.entries
# metric's reading)
STATUE_TRIS = 28_055_740
STATUE_ENTRIES = 32_605_000


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


# the exact-raster kernel's operations, counted from csrc/raster_exact.cu,
# for its bound: a tile's cull test of one triangle's draw region (6
# compares, 2 adds); one pixel's visit of a triangle whose region holds it
# (two planes, 4 each; e2, 2; three edge compares); a covered fragment's
# least (z plane 4, range 2, compare 1, inv_w plane and guard 5, vertex
# color 4 x 6, blend 4 x 5)
EXACT_CULL_OPS = 8
EXACT_VISIT_OPS = 13
EXACT_FRAG_OPS = 56
EXACT_TILE = 16
EXACT_PX_BYTES = 40   # a pixel's color and depth, read once, written once


def on_cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def capture(module, name):
    """``module.name`` wrapped while inside: each call's positional and
    keyword arguments (tensors cloned before the call, which may draw into
    them in place) and its result (tensors cloned), in the yielded list."""
    plain = getattr(module, name)
    calls = []

    def copy(v):
        if isinstance(v, tuple):
            return tuple(copy(x) for x in v)
        return v.clone() if isinstance(v, torch.Tensor) else v

    def wrapped(*a, **k):
        args, kw = copy(a), {key: copy(v) for key, v in k.items()}
        out = plain(*a, **k)
        calls.append((args, kw, copy(out)))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, plain)


def twin_equal(what, fn, call) -> float:
    """``fn``, whose CPU path is the exact rasterizer's plain loop, on CPU
    copies of a card call's inputs must give that call's (color, depth),
    bit for bit at every pixel.  Returns the loop's seconds."""
    args, kw, got = call
    t0 = time.perf_counter()
    want = fn(*map(on_cpu, args), **{k: on_cpu(v) for k, v in kw.items()})
    seconds = time.perf_counter() - t0
    gc, gd = (t.cpu() for t in got)
    wc, wd = want
    n_c, n_d = int((gc != wc).any(-1).sum()), int((gd != wd).sum())
    if n_c or n_d or torch.isnan(wc).any() or torch.isnan(wd).any():
        raise AssertionError(f"{what}: the exact-raster kernel differs from "
                             f"its plain loop at {n_c} px in color and "
                             f"{n_d} in depth")
    return seconds


def exact_bound(launch) -> dict:
    """The exact-raster kernel's bound for the inputs of one launch: bytes
    of each pixel of a tile that some draw region meets (its color and
    depth, read and written once), of each triangle's row, draw region and
    vertex-color planes, and of the texels of the slots it samples;
    operations of every tile's cull, every pixel's visit of a triangle
    whose region holds it, and (at least) each covered fragment."""
    from tyleri_tpu_torch.ops import setup as S

    t = launch.tensors
    H, W = t["depth"].shape
    regions = t["regions"].cpu().numpy().astype(np.int64)
    x0, y0, x1, y1 = regions.T
    live = (x0 < x1) & (y0 < y1)
    tiles = np.zeros(((H + EXACT_TILE - 1) // EXACT_TILE,
                      (W + EXACT_TILE - 1) // EXACT_TILE), bool)
    for a, b, c, d in regions[live]:
        tiles[b // EXACT_TILE:(d - 1) // EXACT_TILE + 1,
              a // EXACT_TILE:(c - 1) // EXACT_TILE + 1] = True
    rows = np.minimum(EXACT_TILE, H - EXACT_TILE * np.arange(tiles.shape[0]))
    cols = np.minimum(EXACT_TILE, W - EXACT_TILE * np.arange(tiles.shape[1]))
    pixels = int((tiles * np.outer(rows, cols)).sum())
    visits = int(((x1 - x0) * (y1 - y0))[live].sum())
    ch = t["channels"].cpu()
    area = (ch[:, S.CH_TWOA].abs() / 2).numpy()
    frags = float(np.minimum(area, (x1 - x0) * (y1 - y0))[live].sum())
    T = ch.shape[0]
    slots = np.unique((ch[:, S.CH_META].to(torch.int32)
                       & S.META_TEX_MASK).numpy()[live])
    offs, ws, hs = (x.cpu().numpy() for x in t["tables"])
    slots = np.clip(slots, 0, len(offs) - 1)
    texel_bytes = int(sum(ws[i] * hs[i] for i in slots)) * 64
    row_bytes = bytes_of(ch, t["regions"]) + (
        bytes_of(t["vc"]) if t["vc"] is not None else 0)
    chunks = -(-T // EXACT_TILE ** 2) * EXACT_TILE ** 2
    return bound(EXACT_PX_BYTES * pixels + row_bytes + texel_bytes,
                 EXACT_CULL_OPS * tiles.size * chunks
                 + EXACT_VISIT_OPS * visits + EXACT_FRAG_OPS * frags)


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
    return rf, first_pass(inputs)


def first_pass(inputs, band_y0=0, band_h=None):
    """The first camera's pass of a frame's inputs; with ``band_h``, its
    viewport and scissor moved into the band from row ``band_y0``, as
    ``frame_body`` moves them on a mesh."""
    from tyleri_tpu_torch.rendering.forward import (
        _shift_scissor,
        _shift_viewport,
    )

    (texels, toff, tw, th, _, _, viewports, scissors, mvps, corners,
     tri_draw, tri_valid0, tri_tex) = inputs[:13]
    viewport, scissor = viewports[0], scissors[0]
    if band_h is not None:
        viewport = _shift_viewport(viewport, band_y0)
        scissor = _shift_scissor(scissor, band_y0, band_h)
    return dict(corners=corners[0], tri_draw=tri_draw[0], tri_tex=tri_tex[0],
                tri_valid=tri_valid0[0], mvps=mvps[0], viewport=viewport,
                scissor=scissor)


def binned_pass(rf, sp, plan=None, draw_mod=None):
    """Setup, near clip and binning of one pass, as mesh_pass_fused runs
    them (under ``plan``, else ``rf.plan``, with the draw mask
    ``draw_mod``), with the spill and broad capacities grown as the frame
    loop grows them on overflow until nothing is dropped.  Returns the
    table, the tile dims and the setup rows the table was gathered from."""
    from tyleri_tpu_torch.ops import setup_cuda
    from tyleri_tpu_torch.ops.binning import bin_triangles, spill_rows
    from tyleri_tpu_torch.rendering.passes import (
        _fused_clip_subset,
        setup_dims,
    )

    plan = plan or rf.plan
    raster = plan.raster
    dims = setup_dims(raster)
    su, _, crossed = setup_cuda.fused_setup(
        sp["corners"], sp["tri_draw"], sp["tri_tex"], sp["tri_valid"],
        sp["mvps"], True, sp["viewport"], sp["scissor"], draw_mod=draw_mod,
        **dims)
    su, _ = _fused_clip_subset(
        su, crossed, (sp["corners"], sp["tri_draw"], sp["tri_tex"]),
        sp["mvps"], sp["viewport"], sp["scissor"], rf.mesh_state,
        raster.clip_cap, dims)
    spill_cap, broad_cap = raster.spill_cap, raster.broad_cap
    for _ in range(8):
        binned = bin_triangles(
            su, grid_w=raster.grid_w, grid_h=raster.grid_h,
            entry_cap=(plan.tri_cap + raster.clip_cap + spill_rows(
                spill_cap, raster.max_tiles_per_tri)),
            max_tiles_per_tri=raster.max_tiles_per_tri, broad_cap=broad_cap,
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
    g_ms = graph_ms(lambda: setup_cuda.fused_setup(*args, **dims), reps=20)
    plain_ms = cuda_ms(
        lambda: setup_cuda.fused_setup_reference(*args, **dims), reps=5)
    n_live = int(got[0].valid.sum())
    su, _, crossed = got
    rows = args[0].shape[0]
    # the draw mask of a mesh's draws axis, on both tables; the same bytes
    # and operations, so the same bound
    masked_ms = {}
    for dm in DRAW_MODS:
        for what, a in (("random", (*rand, True, viewport, scissor)),
                        ("sponza", args)):
            m_got = setup_cuda.fused_setup(*a, draw_mod=dm, **dims)
            m_want = setup_cuda.fused_setup_reference(*a, draw_mod=dm,
                                                      **dims)
            err = max(err, max_abs_err([(m_got[0].channels,
                                         m_want[0].channels)]))
            if not setup_equal(m_got, m_want):
                raise AssertionError(f"fused_setup with draw_mod {dm} "
                                     f"differs from its plain version on "
                                     f"the {what} table")
        masked_ms[str(dm)] = graph_ms(
            lambda: setup_cuda.fused_setup(*args, draw_mod=dm, **dims),
            reps=20)
    records["fused_setup"] = dict(
        max_abs_err=err, ms=g_ms, back_to_back_ms=ms, plain_ms=plain_ms,
        library_ms=None, masked_ms=masked_ms,
        **bound_fields(bound(
            bytes_of(*args[:5], su.channels, su.valid, su.tile_lo,
                     su.tile_hi, crossed), K1K2_OPS_PER_ROW * rows)))
    log("k1k2", f"bit-equal on {T} random rows and {rows} sponza "
        f"rows ({n_live} live, {int(got[1])} crossers); kernel {g_ms:.4f} ms "
        f"by CUDA graph ({ms:.4f} ms back to back), plain {plain_ms:.4f} ms; "
        f"{share(records['fused_setup'])}; no single PyTorch call computes "
        f"it")
    log("k1k2", "draw mask: bit-equal on both tables for " + ", ".join(
        f"draw_mod {k}" for k in masked_ms) + "; on sponza by CUDA graph "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in masked_ms.items())
        + f" beside {g_ms:.4f} ms unmasked")
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
    g_ms = graph_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], chunk=chunk, **kw), reps=20)
    records["rasterize_visibility"] = dict(
        max_abs_err=err, ms=g_ms, back_to_back_ms=ms, plain_ms=plain_ms,
        library_ms=None)
    # K3's floor: the same launch with every segment and the broad list
    # empty (depth read, 7 maps written), beside P7, P6 and P1
    empty = binned._replace(tile_start=torch.zeros_like(binned.tile_start),
                            num_broad=torch.zeros_like(binned.num_broad))
    records["k3_floor_ms"] = graph_ms(lambda: raster_cuda.rasterize_visibility(
        empty, depth0, sp["scissor"], chunk=chunk, **kw), reps=20)
    log("k3", f"bit-equal on the full {W}x{H} frame ({int(binned.num_entries)}"
        f" entries, {int(binned.num_broad)} broad, "
        f"{int((got.owner >= 0).sum())} covered px); kernel {g_ms:.4f} ms by "
        f"CUDA graph ({ms:.4f} ms back to back; "
        f"{records['k3_floor_ms']:.4f} ms on the empty table), plain "
        f"{plain_ms:.4f} ms; the early exit moved {moved} px off the "
        f"no-exit resolve (bound {EXIT_MOVED_MAX * W * H:.0f})")
    return binned, kw, depth0, su


def emit_bound(kw) -> dict:
    """The emit kernel's bound: bytes of the key and opA rows each segment
    reads (16 B a row; a level's covers each read the level's prefix), of
    every row of the list written (key2 and the triangle id, 16 B) and of
    the two counts."""
    from tyleri_tpu_torch.ops.binning import emit_segments

    segs = emit_segments(kw["vcap"], kw["caps"], kw["entry_cap"], kw["K"])
    read = sum(rows for _, rows, cover in segs if cover >= 0)
    written = sum(rows for _, rows, _ in segs)
    return bound_fields(bound(16 * read + 16 * written + 16, 0))


def statue_emit_inputs(device, kw, T=STATUE_TRIS, entries=STATUE_ENTRIES):
    """The emit's inputs at the statue's sizes, seeded on the card: T live
    rows whose spill counts give ``entries`` entries (one in eight spills
    once, one in seventy-one three times: 2x1, 1x2 and 2x2 tile boxes),
    random tile origins and zmin; the first sort of their keys; the spill
    levels and entry cap as the frame plan's fits would set them from the
    demands (1.25x, ``forward._fit``), valid_cap off."""
    from tyleri_tpu_torch.ops import binning as B
    from tyleri_tpu_torch.rendering.forward import _GRANULE, _fit

    g = torch.Generator(device=device).manual_seed(0)
    u = torch.rand(T, generator=g, device=device)
    p3 = (entries - T) / T / 3 / 10          # a tenth of the spill's rows
    scount = torch.where(u < p3, 3, torch.where(u < (entries - T) / T
                                                - 2 * p3, 1, 0))
    tw = torch.where(scount == 3, 2, torch.where(
        (scount == 1) & (u < 0.5 * (entries - T) / T), 2, 1))
    gw, gh = kw["grid_w"], kw["ntiles"] // kw["grid_w"]
    tx = torch.randint(0, gw - 1, (T,), generator=g, device=device)
    ty = torch.randint(0, gh - 1, (T,), generator=g, device=device)
    zq = torch.randint(0, 65536, (T,), generator=g, device=device)
    key = B.pack_key(scount, tw, torch.arange(T, device=device))
    key, perm = torch.sort(key)
    opA = ((zq << 16) | (ty << 8) | tx)[perm]
    demand = [int((scount >= (1 << j)).sum()) for j in range(5)]
    caps = [max(_fit(d, 1.25, 512), 512) for d in demand]
    spill = sum(cap * (min(2 * lo, 32) - lo)
                for cap, lo in zip(caps, (1, 2, 4, 8, 16)))
    entry_cap = min(T + spill, _fit(int(scount.sum()) + T, 1.25, _GRANULE))
    return key, opA, dict(kw, T=T, K=32, vcap=T, caps=caps,
                          entry_cap=entry_cap)


def phase_bin_emit(device, rf, sp, records, launches):
    """The entry-emit kernel against its plain version, bit for bit, on
    CPU copies of its inputs: on one sponza frame's first sort (captured
    from ``binned_pass``) and at the statue's sizes (``statue_emit_inputs``);
    each launch alone by CUDA graph and back to back, beside its bound."""
    from tyleri_tpu_torch.ops import binning as B

    with capture(B, "emit_entries") as calls:
        binned_pass(rf, sp)
    (key, opA), kw, _ = calls[-1]
    cases = {"sponza": (key, opA, kw)}
    cases["statue"] = statue_emit_inputs(device, {
        k: kw[k] for k in ("grid_w", "ntiles")})
    B.reset_launches()
    for name, (key, opA, kw) in cases.items():
        got = B.emit_entries(key, opA, **kw)
        t0 = time.perf_counter()
        want = B.emit_entries(key.cpu(), opA.cpu(), **kw)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        for what, g, w in zip(("key2", "tri", "dense", "spill"), got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"bin-emit {name}: {what} differs from "
                                     f"its plain version at "
                                     f"{int((g.cpu() != w).sum())} rows")
        key2, tri, placed = (torch.empty_like(got[0]),
                             torch.empty_like(got[1]),
                             torch.empty(2, dtype=torch.int64, device=device))
        launch = B.kernel_launch(key, opA, key2, tri, placed, **kw)
        ms, b2b_ms = graph_ms(launch, reps=20), cuda_ms(launch, reps=20)
        if not (torch.equal(key2, got[0]) and torch.equal(tri, got[1])):
            raise AssertionError(f"bin-emit {name}: the timed launch wrote "
                                 "another list")
        rec = dict(max_abs_err=0.0, ms=ms, back_to_back_ms=b2b_ms,
                   plain_ms=plain_ms, library_ms=None, rows=key2.numel(),
                   placed=[int(got[2]), int(got[3])], **emit_bound(kw))
        log("bin-emit", f"{name}: {kw['T']} triangles, {key2.numel()} rows "
            f"({rec['placed'][0]} dense and {rec['placed'][1]} spill "
            f"placed): equal to its plain version at every row; "
            f"{ms:.4f} ms by CUDA graph ({b2b_ms:.4f} ms back to back), "
            f"plain {plain_ms:.1f} ms on the host's CPU; {share(rec)}")
        records[f"bin_emit_{name}"] = rec
        del got, want, key2, tri, launch
    # each case: one call, then 21 calls at the graph's capture and warm-up
    # and 21 back to back
    if B.launches != 2 * (1 + 21 + 21):
        raise AssertionError(f"{B.launches} emit launches in the phase")
    launches["bin-emit"] = dict(bin_emit=B.launches)
    del cases
    torch.cuda.empty_cache()


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
    g_ms = graph_ms(lambda: raster_cuda.rasterize_visibility(
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
        max_abs_err=err, ms=g_ms, back_to_back_ms=ms, plain_ms=plain_ms,
        library_ms=None,
        **k3_bound(binned, depth0, visited, "counts", tile_px))
    # the base variant visits the same entries (the same exit)
    records["rasterize_visibility"].update(
        k3_bound(binned, depth0, visited, "base", tile_px))
    seg = binned.tile_start[1:] - binned.tile_start[:-1]
    log("k3-counts", f"maps and per-tile counts equal on the sponza table; "
        f"the early exit skipped {n - visited} of {n} narrow entries "
        f"({(n - visited) / max(n, 1):.2%}) at chunk {chunk}; tiles skipping "
        f"some {int(((seg - nvis.flatten()) > 0).sum())} of {seg.numel()}; "
        f"kernel {g_ms:.4f} ms by CUDA graph ({ms:.4f} ms back to back), "
        f"plain {plain_ms:.4f} ms; "
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
    g_ms = graph_ms(lambda: raster_cuda.rasterize_visibility(
        binned, depth0, sp["scissor"], peel2=True, **kw), reps=20)
    base_ms = graph_ms(lambda: raster_cuda.rasterize_visibility(
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
        f"kernel {g_ms:.4f} ms by CUDA graph ({ms:.4f} ms back to back; base "
        f"variant on the same table {base_ms:.4f} ms by CUDA graph), plain "
        f"{plain_ms:.4f} ms; {share(dict(peel2_bound, ms=g_ms))}")

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
        max_abs_err=err, ms=g_ms, back_to_back_ms=ms, plain_ms=plain_ms,
        library_ms=None,
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
    """The converged plan's steady frame time: CUDA events ordered through
    the device's queue pool and the host clock around ``frames`` renders,
    with the card's sync debug mode on and no synchronizing call.  Returns
    (ms, host_ms, image)."""
    rf = win.rendering_function
    pool = win.render_device.present_queues
    n_msgs = len(messages)
    render_frames(win, rig, [t] * 3)   # the last fits reach the plan
    plan_before = rf.plan
    # the frame loop must not wait on its own stream: a synchronizing op
    # (a blocking host<->device copy, a value read) would serialize host
    # and card
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        # events ordered after every frame submitted through the pool
        start = pool.event(enable_timing=True)
        h0 = time.perf_counter()
        for _ in range(frames):
            rig.fill(win.get_render_scene(), t)
            win.render()
        end = pool.event(enable_timing=True)
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
        raise AssertionError(f"the frame loop synchronized {len(syncs)} times "
                             f"in {frames} frames: {syncs[0].message}")
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
    return off, want


def phase_sponza(build_device, resolution, launches, grid_n=420):
    """Config 5 through RenderWindow until every adaptive stage engaged,
    then the steady frame time."""
    from tyleri_tpu_torch.ops import binning, raster_cuda, setup_cuda
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
    binning.reset_launches()
    frames, warm_s, seen = converge(win, rig, 0.0, max_frames=96,
                                    orbit=orbit)
    counted = (setup_cuda.launches, raster_cuda.variant_launches["base"],
               binning.launches)
    if counted != (frames,) * 3 or raster_cuda.launches() != frames:
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
                               fused_setup=setup_cuda.launches,
                               bin_emit=binning.launches)
    if binning.launches != setup_cuda.launches:
        raise AssertionError(f"config5 launches {launches['config5']}: one "
                             "emit a frame")
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
    return dev, rig, win, messages


class WithOverlay:
    """A scene rig whose frames also carry a UI overlay (``elements``, the
    RenderScene.add_ui list; [] draws none)."""

    def __init__(self, rig, elements):
        self.rig, self.elements = rig, elements
        self.resolution = rig.resolution
        self.triangle_count = rig.triangle_count

    def fill(self, scene, t):
        self.rig.fill(scene, t)
        scene.add_ui(self.elements)


def ui_overlay(device, seed=11):
    """The overlay of the UI phase, in window points: a 480x270 panel of 64
    solid quads (8 x 8 cells) on a 1x1 white texture, per-corner colors,
    alpha 0.5 to 1; two rows of 32 glyph-sized quads (16 to 32 points) on a
    16x16 texture below it.  128 quads, 256 triangles."""
    rng = np.random.default_rng(seed)
    white, glyph = device.create_textures([
        ((1, 1), lambda b: b.__setitem__(slice(None), 1.0)),
        ((16, 16), lambda b: b.__setitem__(
            slice(None), rng.random((16, 16, 4), np.float32)))])

    def quads(boxes):
        verts, idx = [], []
        for q, (x0, y0, x1, y1) in enumerate(boxes):
            for (x, y), uv in zip(((x0, y0), (x1, y0), (x1, y1), (x0, y1)),
                                  ((0, 0), (1, 0), (1, 1), (0, 1))):
                verts.append([x, y, *uv, *rng.uniform(0.2, 1.0, 3),
                              rng.uniform(0.5, 1.0)])
            idx += [4 * q + k for k in (0, 1, 2, 0, 2, 3)]
        return np.asarray(verts, np.float32), np.asarray(idx, np.uint32)

    cw, ch = 480 / 8, 270 / 8
    panel = [(20 + cw * i, 20 + ch * j, 20 + cw * (i + 1) - 2,
              20 + ch * (j + 1) - 2) for j in range(8) for i in range(8)]
    glyphs = []
    for k in range(64):
        w, h = rng.uniform(16, 32, 2)
        x0, y0 = 20 + 28 * (k % 32), 310 + 40 * (k // 32)
        glyphs.append((x0, y0, x0 + w, y0 + h))
    return [(*quads(panel), white), (*quads(glyphs), glyph)]


def phase_ui(sponza, launches, resolution, records):
    """The UI overlay over config 5 at full size, after the plan converged
    (phase 9's window): at scale factors 1 and 2, the frame decomposes into
    the overlay-only frame (where the UI drew; it holds to the oracle) and
    the UI-free frame (elsewhere, bit for bit), and the UI pass's kernel
    equals its plain loop on CPU copies of that frame's inputs; the
    kernel's time alone on the scale-1 overlay; K3 on that frame's table
    with the UI's depth as its incoming depth equals its plain version; the
    steady frame time with and without the overlay, in turns."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, raster_exact, setup_cuda
    from tyleri_tpu_torch.rendering import forward, passes
    from tyleri_tpu_torch.testing.scene_oracle import ui_oracle

    dev, rig, win, messages = sponza
    rf = win.rendering_function
    overlay = ui_overlay(dev)
    W, H = resolution
    n_tris = sum(len(i) for _, i, _ in overlay) // 3
    if n_tris != rf.plan.ui_tri_cap:
        raise AssertionError(f"{n_tris} UI triangles, ui_tri_cap "
                             f"{rf.plan.ui_tri_cap}")

    def record(cameras, ui, scale):
        scene = tt.RenderScene()
        if cameras:
            rig.fill(scene, 0.0)
        scene.add_ui(overlay if ui else [])
        q = dev.present_queues.pop()
        try:
            with q.context():
                frame = rf.record(dev, scene.render_resources, scale,
                                  resolution)
        finally:
            dev.present_queues.push(q)
        return frame, scene

    loop_s = {}
    for scale in (1.0, 2.0):
        setup_cuda.reset_launches()
        raster_cuda.reset_launches()
        raster_exact.reset_launches()
        both, _ = record(True, True, scale)
        counted = dict(raster_cuda.variant_launches,
                       fused_setup=setup_cuda.launches,
                       raster_exact=raster_exact.launches)
        if counted != dict(base=1, peel2=0, counts=0, fused_setup=1,
                           raster_exact=1):
            raise AssertionError(f"UI frame launches {counted}")
        mesh, _ = record(True, False, scale)
        with capture(forward, "ui_pass") as calls, \
                capture(raster_exact, "kernel_launch") as kernel:
            alone, ui_scene = record(False, True, scale)
        loop_s[scale] = twin_equal(f"ui scale {scale:g}", passes.ui_pass,
                                   calls[0])
        if scale == 1.0:
            launch = kernel[0][2]
        drew = both.order == 0
        if not torch.equal(drew, alone.depth < 1.0):
            raise AssertionError("the UI's pixels differ from the overlay's")
        differ = [int((both.color[drew] != alone.color[drew]).any(-1).sum()),
                  int((both.color[~drew] != mesh.color[~drew]).any(-1).sum()),
                  int((both.depth[~drew] != mesh.depth[~drew]).sum())]
        if any(differ):
            raise AssertionError(f"scale {scale}: the UI frame differs from "
                                 f"the overlay-only frame at {differ[0]} UI "
                                 f"px, from the UI-free frame at "
                                 f"{differ[1:]} px elsewhere")
        t0 = time.perf_counter()
        want, want_d = ui_oracle(dev, ui_scene.render_resources, rf.ui_state,
                                 resolution, scale)
        oracle_s = time.perf_counter() - t0
        got = alone.color.cpu().numpy()
        bad = float((np.abs(got - want).max(axis=-1) > 1e-3).mean())
        # f32 and f64 edge decisions of quads off the pixel grid
        cover = float(((alone.depth.cpu().numpy() == 0) != (want_d == 0))
                      .mean())
        if bad > BUDGET or cover > BUDGET:
            raise AssertionError(f"scale {scale}: the overlay is {bad:.4%} "
                                 f"px off the oracle, its coverage "
                                 f"{cover:.4%}")
        log("ui", f"scale {scale:g}: {int(drew.sum())} px of UI "
            f"({float(drew.float().mean()):.2%}) over sponza at {W}x{H}; the "
            f"frame equals the overlay-only frame there and the UI-free frame "
            f"elsewhere, bit for bit; the UI pass's kernel equals its plain "
            f"loop on CPU copies of its inputs at every pixel (the loop "
            f"{loop_s[scale]:.2f} s); the overlay {bad:.4%} px more than "
            f"1e-3 off the f64 oracle, its coverage {cover:.4%} px (budget "
            f"{BUDGET:.2%}; {oracle_s:.1f} s); launches {counted}")

    # the kernel alone on the scale-1 overlay: each call one launch
    raster_exact.reset_launches()
    k_ms = graph_ms(launch, reps=20)
    b2b_ms = cuda_ms(launch, reps=20)
    if raster_exact.launches != 2 * 21:
        raise AssertionError(f"{raster_exact.launches} exact-raster launches "
                             f"in 42 calls")
    records["raster_exact"] = dict(
        max_abs_err=0.0, ms=k_ms, back_to_back_ms=b2b_ms,
        plain_ms=1e3 * loop_s[1.0], library_ms=None,
        **bound_fields(exact_bound(launch)))
    log("ui", f"the exact-raster kernel on the scale-1 overlay ("
        f"{launch.tensors['channels'].shape[0]} triangles): {k_ms:.4f} ms by "
        f"CUDA graph ({b2b_ms:.4f} ms back to back), its plain loop "
        f"{1e3 * loop_s[1.0]:.1f} ms on the host's CPU; "
        f"{share(records['raster_exact'])}")
    del launch

    # K3 resolving against the UI's depth (scale 1) on this frame's table
    _, sp = pass_inputs(dev, rig, resolution, 0.0)
    binned, dims, _ = binned_pass(rf, sp)
    alone, _ = record(False, True, 1.0)
    ui_depth = alone.depth
    kw = dict(fb_w=W, fb_h=H, depth_state=rf.mesh_state.depth,
              chunk=rf.plan.raster.chunk, **dims)
    got = raster_cuda.rasterize_visibility(binned, ui_depth, sp["scissor"],
                                           **kw)
    want = raster_cuda.rasterize_visibility_stream_reference(
        binned, ui_depth, sp["scissor"], **kw)
    if not layers_bit_equal(got, want):
        bad = int(((got.depth != want.depth) | (got.owner != want.owner))
                  .sum())
        raise AssertionError(f"K3 on the UI's depth differs from its plain "
                             f"version at {bad} px")
    ui_px = ui_depth == 0
    th, tw = dims["tile_h"], dims["tile_w"]
    whole = ui_px[:H // th * th, :W // tw * tw].reshape(H // th, th, W // tw,
                                                         tw)
    log("ui", f"K3 on the sponza table with the UI's depth as its incoming "
        f"depth ({int(ui_px.sum())} px at z = 0, "
        f"{int(whole.all(3).all(1).sum())} tiles all UI): bit-equal to its "
        f"plain version; {int(((got.owner >= 0) & ui_px).sum())} UI px won "
        f"by a mesh fragment")
    del binned, sp, got, want

    # steady frames with and without the overlay, in turns; the UI pass's
    # host time
    ui_host = []
    plain_ui_pass = forward.ui_pass

    def timed_ui_pass(*a, **k):
        t = time.perf_counter()
        out = plain_ui_pass(*a, **k)
        ui_host.append(time.perf_counter() - t)
        return out

    times = {"overlay": [], "none": []}
    forward.ui_pass = timed_ui_pass
    try:
        for which in ("overlay", "none", "none", "overlay"):
            frames = WithOverlay(rig, overlay if which == "overlay" else [])
            setup_cuda.reset_launches()
            raster_cuda.reset_launches()
            raster_exact.reset_launches()
            ms, host_ms, _ = steady(win, frames, 0.0, messages)
            n = 3 + 30 + 1
            counted = dict(raster_cuda.variant_launches,
                           fused_setup=setup_cuda.launches,
                           raster_exact=raster_exact.launches)
            if counted != dict(base=n, peel2=0, counts=0, fused_setup=n,
                               raster_exact=n if which == "overlay" else 0):
                raise AssertionError(f"ui {which}: launches {counted} for "
                                     f"{n} frames")
            key = f"ui_{which}"
            launches[key] = {k: launches.get(key, {}).get(k, 0) + v
                             for k, v in counted.items()}
            times[which].append((ms, host_ms))
    finally:
        forward.ui_pass = plain_ui_pass
    for which in ("overlay", "none"):
        (a, ha), (b, hb) = times[which]
        log("ui", f"config 5 {which}: steady {a:.3f} and {b:.3f} ms/frame by "
            f"CUDA events (in turns), {ha:.3f} and {hb:.3f} ms/frame by host "
            f"clock; one K1+K2 and one K3 base launch a frame, and one "
            f"exact-raster launch under the overlay")
    log("ui", f"the UI pass's host time {1e3 * np.mean(ui_host):.3f} ms a "
        f"frame (mean of {len(ui_host)})")


def phase_exact(build_device, launches, resolution, config4, n_instances=100,
                max_seconds=60.0):
    """Exact mode: configs 1 and 2, then config 4 at 1920x1080, against the
    sequential oracle; one launch of the exact kernel a frame, no other
    kernel; for configs 1 and 2 the kernel equal to its plain loop on CPU
    copies of the frame's inputs.  ``config4`` = (deviations of peel2 and
    the single layer, the 1080p sequential oracle image) from phase 8."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, raster_exact, setup_cuda
    from tyleri_tpu_torch.rendering import passes
    from tyleri_tpu_torch.testing.scene_oracle import (
        mismatch_fraction,
        scene_oracle_u8,
    )

    for name, make, t in (("config1", tt.scenes.config1_triangle, 0.0),
                          ("config2", tt.scenes.config2_cube, 0.9)):
        dev = build_device()
        rig = make(dev)
        win = tt.RenderWindow(dev, resolution=rig.resolution,
                              present_mode="immediate", blend_parity="exact")
        setup_cuda.reset_launches()
        raster_cuda.reset_launches()
        raster_exact.reset_launches()
        with capture(passes, "rasterize_exact") as calls:
            img = render_frames(win, rig, [t])
        counted = (setup_cuda.launches, raster_cuda.launches(),
                   raster_exact.launches)
        if counted != (0, 0, 1):
            raise AssertionError(f"exact {name} launched {counted} (K1+K2, "
                                 f"K3, exact)")
        loop_s = twin_equal(f"exact {name}", raster_exact.rasterize_exact,
                            calls[0])
        n_tris = calls[0][0][2].shape[0]
        scene = tt.RenderScene()
        rig.fill(scene, t)
        want = scene_oracle_u8(dev, scene.render_resources,
                               win.rendering_function.mesh_state,
                               rig.resolution, sequential=True)
        bad = mismatch_fraction(img, want)
        if bad > BUDGET:
            raise AssertionError(f"exact {name}: {bad:.4%} px off the "
                                 f"sequential oracle")
        log("exact", f"{name} {rig.resolution[0]}x{rig.resolution[1]}: "
            f"{bad:.4%} px off the sequential oracle (budget {BUDGET:.2%}); "
            f"one exact kernel launch over {n_tris} triangle rows, equal to "
            f"its plain loop on CPU copies at every pixel (the loop "
            f"{loop_s:.2f} s)")

    off, want = config4
    dev = build_device()
    rig = config4_rig(dev, resolution, n_instances)
    win = tt.RenderWindow(dev, resolution=resolution,
                          present_mode="immediate", blend_parity="exact")
    setup_cuda.reset_launches()
    raster_cuda.reset_launches()
    raster_exact.reset_launches()
    t0 = time.perf_counter()
    img = render_frames(win, rig, [0.5])
    seconds = time.perf_counter() - t0
    launches["exact"] = dict(raster_cuda.variant_launches,
                             fused_setup=setup_cuda.launches,
                             raster_exact=raster_exact.launches)
    if (setup_cuda.launches, raster_cuda.launches(),
            raster_exact.launches) != (0, 0, 1):
        raise AssertionError(f"exact config 4 launched {launches['exact']}")
    bad = mismatch_fraction(img, want, 1)
    if bad > BUDGET:
        raise AssertionError(f"exact config 4: {bad:.4%} px more than 1 u8 "
                             f"off the sequential oracle")
    if seconds > max_seconds:
        raise AssertionError(f"exact config 4 took {seconds:.1f} s")
    log("exact", f"config4 {resolution[0]}x{resolution[1]}, "
        f"{rig.triangle_count} tris in {n_instances} draws, one frame in "
        f"{seconds:.2f} s: {bad:.4%} px more than 1 u8 off the sequential "
        f"oracle, against {off['auto']:.4%} with peel2 and {off['fast']:.4%}"
        f" with one layer (phase 8); one exact kernel launch")


DEPTH_STATES = {
    "always": dict(compare_op="ALWAYS"),
    "never": dict(compare_op="NEVER"),
    "test_off": dict(test_enable=False),
    "write_off_le": dict(write_enable=False, compare_op="LESS_OR_EQUAL"),
}
SHADE_TOL = 1e-6   # the shade's CUDA result against the same ops on the CPU


def phase_depth_states(build_device, launches, resolution=(800, 600),
                       frames=2):
    """Config 2 under the depth states K3 does not take (the last-passing
    resolve): against the oracle that blends each pixel's surviving
    fragment once, the visibility path's rule; one K1+K2 and no K3 launch a
    frame.  Then config 2 with max_sampler_anisotropy(8): 8 taps reach the
    plan, the frame renders, and the anisotropic shade on the card equals
    the same call on the CPU."""
    import dataclasses

    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.ops.shade import shade_visibility
    from tyleri_tpu_torch.ops.visibility import VisibilityBuffer
    from tyleri_tpu_torch.resource.textures import texture_tensors
    from tyleri_tpu_torch.testing.scene_oracle import (
        mismatch_fraction,
        scene_oracle_u8,
    )

    for name, change in DEPTH_STATES.items():
        msgs = []
        dev = build_device(callback=msgs.append)
        rig = tt.scenes.config2_cube(dev, resolution)
        win = tt.RenderWindow(dev, resolution=resolution,
                              present_mode="immediate")
        rf = win.rendering_function
        change = {k: (tt.CompareOp[v] if k == "compare_op" else v)
                  for k, v in change.items()}
        rf.mesh_state = dataclasses.replace(rf.mesh_state, depth=(
            dataclasses.replace(rf.mesh_state.depth, **change)))
        setup_cuda.reset_launches()
        raster_cuda.reset_launches()
        img = render_frames(win, rig, [0.9] * frames)
        counted = dict(raster_cuda.variant_launches,
                       fused_setup=setup_cuda.launches)
        launches[f"depth_{name}"] = counted
        if (raster_cuda.launches(), setup_cuda.launches) != (0, frames):
            raise AssertionError(f"{name}: launches {counted} for {frames} "
                                 f"frames")
        if rf.plan.raster.peel2 or not any(m.message_id == "k3-envelope"
                                           for m in msgs):
            raise AssertionError(f"{name}: peel2 {rf.plan.raster.peel2}, "
                                 f"messages {[m.message_id for m in msgs]}")
        scene = tt.RenderScene()
        rig.fill(scene, 0.9)
        want = scene_oracle_u8(dev, scene.render_resources, rf.mesh_state,
                               resolution)
        bad = mismatch_fraction(img, want)
        covered = float((img[..., :3] > 0).any(-1).mean())
        if bad > BUDGET or (covered == 0) != (name == "never"):
            raise AssertionError(f"{name}: {bad:.4%} px off the oracle, "
                                 f"{covered:.1%} covered")
        log("depth-states", f"config2 {resolution[0]}x{resolution[1]} "
            f"{name}: {bad:.4%} px off the oracle (budget {BUDGET:.2%}), "
            f"{covered:.1%} px covered; launches {counted}")

    dev = build_device(anisotropy=8)
    rig = tt.scenes.config2_cube(dev, resolution)
    win = tt.RenderWindow(dev, resolution=resolution,
                          present_mode="immediate")
    taps = win.rendering_function.plan.raster.aniso_taps
    img = render_frames(win, rig, [0.9])
    if taps != 8 or not img[..., :3].any():
        raise AssertionError(f"anisotropy: taps {taps}")
    rf, sp = pass_inputs(dev, rig, resolution, 0.9)
    binned, dims, _ = binned_pass(rf, sp)
    W, H = resolution
    vis = raster_cuda.rasterize_visibility(
        binned, torch.ones((H, W), device=dev.device), sp["scissor"],
        fb_w=W, fb_h=H, depth_state=rf.mesh_state.depth, **dims)
    tex = texture_tensors(dev.memory_allocator.texture_arena, dev.device)
    dst = torch.zeros((H, W, 4), device=dev.device)
    got = shade_visibility(vis, *tex, rf.mesh_state.blend, dst, aniso_taps=8)
    want = shade_visibility(VisibilityBuffer(*(m.cpu() for m in vis)),
                            *(t.cpu() for t in tex), rf.mesh_state.blend,
                            dst.cpu(), aniso_taps=8)
    err = float((got.cpu() - want).abs().max())
    plain = shade_visibility(vis, *tex, rf.mesh_state.blend, dst)
    moved = float((got - plain).abs().amax(-1).gt(1 / 255).float().mean())
    if err > SHADE_TOL:
        raise AssertionError(f"anisotropic shade: card and CPU differ by "
                             f"{err:.3g}")
    log("depth-states", f"config2 with max_sampler_anisotropy(8): "
        f"aniso_taps {taps}, the frame renders; the 8-tap shade on the card "
        f"equals the CPU's within {err:.3g} (tolerance {SHADE_TOL:g}) and "
        f"moves {moved:.2%} px more than 1 u8 off the bilinear shade")


MESH_WORLD = 4          # ranks of phase 14's (b) and (c), on the one card
MESH_CONVERGE = 24      # frames before the checks: past the clip skip (16)
MESH_STEADY = 10        # timed frames a rank
MESH_JOIN_S = 480       # the ranks' deadline
HYBRID_BUDGET = 0.01    # tests/test_parallel.py's budgets
PEEL2_MESH_BUDGET = 0.002
BAND_DEPTH_TOL = 1.6e-5  # a D16 step, tests/test_parallel.py's band tolerance
# where a mesh's pixel keeps the single card's winner, its depth may still
# move: band-local coordinates round a steep plane's constant differently
# in f32.  At most a budget's share of those pixels moves more than
# SAME_WINNER_STEPS D16 steps, and none more than SAME_WINNER_MAX_DZ
# (twice the 0.0197 that sponza's lower band reads on the CPU)
SAME_WINNER_STEPS = 16
SAME_WINNER_MAX_DZ = 0.04


def record_once(dev, rf, rig, t, resolution, mesh=None):
    """One more frame of a converged window's plan, recorded on a queue of
    the pool (``record``, or ``record_sharded`` and gathered on a mesh):
    its depth, color and order maps on the host."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.parallel.sharding import gather_frame

    scene = tt.RenderScene()
    rig.fill(scene, t)
    q = dev.present_queues.pop()
    try:
        with q.context():
            if mesh is None:
                frame = rf.record(dev, scene.render_resources, 1.0,
                                  resolution)
            else:
                frame = gather_frame(rf.record_sharded(
                    dev, scene.render_resources, 1.0, resolution, mesh),
                    rf.frame_mesh, resolution[1])
            stats = frame.stats_vector()[:4].cpu().tolist()
            out = {k: getattr(frame, k).cpu().numpy()
                   for k in ("depth", "color", "order")}
    finally:
        dev.present_queues.push(q)
    if any(stats):
        raise AssertionError(f"overflow or crossers after convergence: "
                             f"{stats}")
    return out


def band_kernels(rf, inputs, bplan, band_y0, draw_mod, what) -> str:
    """K1+K2 and K3 at the shapes one rank's band gives them, against their
    plain versions bit for bit: the band's plan (its height need not be a
    multiple of the tile height), the viewport and scissor moved into the
    band, the rank's draw mask and phase 3's first, and K3's variant (base
    or peel2) as the plan has it.  Returns the line that says so."""
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.rendering.passes import setup_dims

    raster = bplan.raster
    W, H = raster.fb_w, raster.fb_h
    sp = first_pass(inputs, band_y0, H)
    dims = setup_dims(raster)
    args = (sp["corners"], sp["tri_draw"], sp["tri_tex"], sp["tri_valid"],
            sp["mvps"], True, sp["viewport"], sp["scissor"])
    # phase 3's first mask and the rank's, on the band
    mods = tuple(dict.fromkeys((DRAW_MODS[0], draw_mod)))
    for dm in mods:
        got = setup_cuda.fused_setup(*args, draw_mod=dm, **dims)
        want = setup_cuda.fused_setup_reference(*args, draw_mod=dm, **dims)
        if not setup_equal(got, want):
            raise AssertionError(f"{what}: fused_setup with draw_mod {dm} "
                                 f"differs from its plain version on the "
                                 f"band")
    live = int(got[0].valid.sum())
    binned, dims, _ = binned_pass(rf, sp, bplan, draw_mod)
    depth0 = torch.ones((H, W), device=sp["corners"].device)
    kw = dict(fb_w=W, fb_h=H, depth_state=rf.mesh_state.depth,
              chunk=raster.chunk, **dims)
    if raster.peel2:
        vis = peel2_check(binned, depth0, sp["scissor"], kw, what)[0]
    else:
        vis = raster_cuda.rasterize_visibility(binned, depth0, sp["scissor"],
                                               **kw)
        want = raster_cuda.rasterize_visibility_stream_reference(
            binned, depth0, sp["scissor"], **kw)
        if not layers_bit_equal(vis, want):
            bad = int(((vis.depth != want.depth)
                       | (vis.owner != want.owner)).sum())
            raise AssertionError(f"{what}: rasterize_visibility differs from "
                                 f"its plain version at {bad} px")
    if not live or not int((vis.owner >= 0).sum()):
        raise AssertionError(f"{what}: the band drew nothing ({live} live "
                             f"rows)")
    return ("K1+K2 (draw_mod " + ", ".join(str(dm) for dm in mods)
            + f"; {live} live rows under the rank's) and K3 "
            f"{'peel2' if raster.peel2 else 'base'} "
            f"({int(binned.num_entries)} entries, "
            f"{int((vis.owner >= 0).sum())} px covered) bit-equal to their "
            f"plain versions on the {W}x{H} band from row {band_y0} "
            f"({H / dims['tile_h']:g} tile rows), scissor "
            f"{sp['scissor'].tolist()}")


def mesh_on_one_card(dev, rig, t, resolution, plan, shape, check):
    """The plain version of a mesh's frame, on this one card: every band
    and draw share of an (nd, nt) mesh rendered by ``frame_body`` under the
    ranks' plan, composited as ``parallel/sharding.py`` does with its
    collectives (min depth bits, then the order key by the compare op, then
    the lowest draws index), and the bands stacked.  First, the kernels of
    the rank at (draws, tiles) ``check`` against their plain versions on
    its band (``band_kernels``).  Returns the maps and that check's line."""
    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.parallel.sharding import _band_plan
    from tyleri_tpu_torch.rendering.forward import frame_body

    nd, nt = shape
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(resolution))
    rf.plan = plan
    scene = tt.RenderScene()
    rig.fill(scene, t)
    inputs = rf.build_frame_inputs(dev, scene.render_resources, 1.0,
                                   resolution)
    if rf.plan != plan:
        raise AssertionError("the ranks' plan did not hold on one card")
    less = rf.mesh_state.depth.compare_op == tt.CompareOp.LESS
    bplan = _band_plan(plan, nt)
    di, ti = check
    checked = band_kernels(rf, inputs, bplan, ti * bplan.raster.fb_h,
                           (nd, di), f"the band at {check}")
    maps = {"depth": [], "color": [], "order": []}
    for ti in range(nt):
        parts = [frame_body(bplan, rf.mesh_state, *inputs,
                            ui_state=rf.ui_state,
                            band_y0=ti * bplan.raster.fb_h, draw_mod=(nd, di))
                 for di in range(nd)]
        zbits = torch.stack([p.depth.view(torch.int32) for p in parts])
        zmin = zbits.amin(0)
        at_min = zbits == zmin
        okey = torch.where(at_min, torch.stack([p.order for p in parts]),
                           torch.inf if less else -torch.inf)
        owin = okey.amin(0) if less else okey.amax(0)
        owner = torch.argmax((at_min & (okey == owin)).to(torch.int32), 0)
        color = torch.stack([p.color for p in parts]).gather(
            0, owner[None, ..., None].expand(1, *owner.shape, 4))[0]
        for k, v in (("depth", zmin.view(torch.float32)), ("color", color),
                     ("order", owin)):
            maps[k].append(v)
    return {k: torch.cat(v)[:resolution[1]].cpu().numpy()
            for k, v in maps.items()}, checked


def mesh_window_run(dev, rig, mesh, resolution, t, blend_parity="auto"):
    """A RenderWindow on ``mesh``: MESH_CONVERGE frames, then MESH_STEADY
    timed ones (CUDA events through the queue pool, host clock) with the
    kernels' counts from 0, then one more frame recorded and gathered.
    Returns (ms, host_ms, image, counts, frame maps, plan, frame mesh
    shape)."""
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.window.render_window import RenderWindow

    win = RenderWindow(dev, resolution=resolution, present_mode="immediate",
                       blend_parity=blend_parity, device_mesh=mesh)
    render_frames(win, rig, [t] * MESH_CONVERGE)
    rf = win.rendering_function
    plan = rf.plan
    pool = dev.present_queues
    setup_cuda.reset_launches()
    raster_cuda.reset_launches()
    start = pool.event(enable_timing=True)
    h0 = time.perf_counter()
    for _ in range(MESH_STEADY):
        rig.fill(win.get_render_scene(), t)
        win.render()
    end = pool.event(enable_timing=True)
    image = win.flush()
    host_ms = (time.perf_counter() - h0) * 1e3 / MESH_STEADY
    end.synchronize()
    ms = start.elapsed_time(end) / MESH_STEADY
    frame = record_once(dev, rf, rig, t, resolution, mesh)
    counts = dict(raster_cuda.variant_launches,
                  fused_setup=setup_cuda.launches)
    if rf.plan != plan:
        raise AssertionError("the plan changed after convergence")
    return (ms, host_ms, image, counts, frame, plan,
            tuple(rf.frame_mesh.shape))


def mesh_rank(rank, world, store, out_dir, resolution):
    """One rank of phase 14 (b) and (c): a gloo process group that meets
    at the file ``store``, a 2x2 (draws, tiles) mesh on the one card;
    config 5, then config 4 under "auto" (peel2 remaps the mesh to 1x4).
    Rank 0 writes the gathered frames and the plan; every rank writes its
    counts, times and image hash."""
    import datetime
    import hashlib
    import os
    import pickle

    import torch.distributed as dist

    import tyleri_tpu_torch as tt

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = tt.make_render_mesh(2)
        coord = mesh.get_coordinate()
        out = dict(rank=rank, coord=coord)
        for key, make, t in (("config5", sponza_rig, 0.0),
                             ("config4", config4_rig, 0.5)):
            msgs = []
            dev = (tt.RenderDeviceBuilder()
                   .device_id(rank % torch.cuda.device_count())
                   .validation_level(tt.ValidationLevel.INFO)
                   .debug_callback(msgs.append).build())
            rig = make(dev, resolution)
            ms, host_ms, image, counts, frame, plan, shape = mesh_window_run(
                dev, rig, mesh, resolution, t)
            remaps = [m.message_id for m in msgs].count(
                "peel2-mesh-tiles-only")
            out[key] = dict(
                ms=ms, host_ms=host_ms, counts=counts, remaps=remaps,
                peel2=plan.raster.peel2, frames=MESH_STEADY + 1, shape=shape,
                image=hashlib.sha256(image.tobytes()).hexdigest())
            if rank == 0:
                with open(os.path.join(out_dir, f"{key}.pkl"), "wb") as f:
                    pickle.dump((frame, plan, image), f)
            log("mesh", f"rank {rank} at (draws, tiles) {tuple(coord)}, "
                f"{key} {resolution[0]}x{resolution[1]}: steady {ms:.3f} "
                f"ms/frame by CUDA events, {host_ms:.3f} by host clock "
                f"({world} ranks share the card and gloo stages every "
                f"collective through the host: no scaling figure); launches "
                f"{counts} in {MESH_STEADY + 1} frames")
            del dev, rig, image, frame
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_vs_single(got, want, image, want_image) -> dict:
    """How far a mesh's frame is from the single-card frame: the shares of
    pixels whose winning triangle (order map) differs, whose presented u8
    image is more than 1 off, whose depth is more than a D16 step off (the
    1.6e-5 tests/test_parallel.py gives its bands), and whose color is more
    than 1e-3 off; the largest depth difference; and, where the winner is
    the same, the share of pixels whose depth is more than
    SAME_WINNER_STEPS D16 steps off and the largest difference there."""
    dz = np.abs(got["depth"] - want["depth"])
    same = got["order"] == want["order"]
    dz_same = np.where(same, dz, 0.0)
    return dict(
        winner=float(1.0 - same.mean()),
        u8=float((np.abs(image.astype(int) - want_image.astype(int))
                  .max(-1) > 1).mean()),
        depth=float((dz > BAND_DEPTH_TOL).mean()),
        color=float((np.abs(got["color"] - want["color"]).max(-1) > 1e-3)
                    .mean()),
        max_dz=float(dz.max()),
        depth_same=float((dz_same > SAME_WINNER_STEPS / 65535).mean()),
        max_dz_same=float(dz_same.max()))


def phase_mesh(build_device, launches, resolution, res_a=(800, 600)):
    """Multi-device rendering: (a) a 1x1 mesh on NCCL, config 2 through
    RenderWindow(device_mesh=...), equal to the single-card window's frame
    bit for bit; (b) 4 ranks on the one card over gloo as a 2x2 mesh,
    config 5 at full size; (c) the same ranks on config 4 under "auto",
    peel2 remapped to 1x4.  One K1+K2 and one K3 a rank a frame; every rank
    presents the same image; the mesh's frame is bit-equal to the same
    bands and draw shares rendered and composited on one card
    (``mesh_on_one_card``), and within the budget of the single-card frame
    in its winners and its presented image."""
    import datetime
    import os
    import pickle
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda

    # every process group of the phase meets at a file store here, not at
    # a TCP port that another process could take first
    with tempfile.TemporaryDirectory() as tmp:
        # (a) NCCL, world size 1, in this process
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = tt.make_render_mesh(1)
            dev = build_device()
            rig = tt.scenes.config2_cube(dev, res_a)
            images = {}
            for name, m in (("mesh", mesh), ("single", None)):
                win = tt.RenderWindow(dev, resolution=res_a,
                                      present_mode="immediate",
                                      device_mesh=m)
                setup_cuda.reset_launches()
                raster_cuda.reset_launches()
                images[name] = render_frames(win, rig, [0.9] * 3)
                counted = dict(raster_cuda.variant_launches,
                               fused_setup=setup_cuda.launches)
                if name == "mesh":
                    launches["mesh_1x1"] = counted
                if (counted["fused_setup"] != 3
                        or raster_cuda.launches() != 3):
                    raise AssertionError(f"1x1 {name}: launches {counted} "
                                         "in 3 frames")
            if not np.array_equal(images["mesh"], images["single"]):
                raise AssertionError("the 1x1 NCCL mesh's frame differs "
                                     "from the single-card window's")
        finally:
            dist.destroy_process_group()
        log("mesh", f"(a) 1x1 mesh on NCCL, config 2 {res_a[0]}x{res_a[1]}: "
            f"equal to the single-card window's frame bit for bit; launches "
            f"{launches['mesh_1x1']} in 3 frames")
        del dev, rig, win
        torch.cuda.empty_cache()

        # the single-card frames (b) and (c) are held to, on the converged
        # plan
        rigs = {"config5": (sponza_rig, 0.0), "config4": (config4_rig, 0.5)}
        refs = {}
        for key, (make, t) in rigs.items():
            dev = build_device()
            rig = make(dev, resolution)
            win = tt.RenderWindow(dev, resolution=resolution,
                                  present_mode="immediate")
            render_frames(win, rig, [t] * MESH_CONVERGE)
            refs[key] = (record_once(dev, win.rendering_function, rig, t,
                                     resolution), win.flush())
            del dev, rig, win
            torch.cuda.empty_cache()

        # (b) and (c): 4 ranks on the one card; NCCL needs a card a rank, so
        # they share it over gloo, which stages CUDA tensors through the
        # host
        log("mesh", f"(b), (c): {MESH_WORLD} ranks over gloo on the one card "
            f"as a 2x2 mesh (NCCL needs one card a rank)")
        ctx = mp.start_processes(
            mesh_rank, args=(MESH_WORLD, os.path.join(tmp, "gloo_store"),
                             tmp, resolution),
            nprocs=MESH_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise AssertionError(f"the mesh ranks outlasted "
                                     f"{MESH_JOIN_S} s")
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        frames = {}
        for key in rigs:
            with open(os.path.join(tmp, f"{key}.pkl"), "rb") as f:
                frames[key] = pickle.load(f)
    for key, budget, variant, shape in (
            ("config5", HYBRID_BUDGET, "base", (2, 2)),
            ("config4", PEEL2_MESH_BUDGET, "peel2", (1, MESH_WORLD))):
        # the rank whose kernels are held to their plain versions on its
        # band: the last draws row, in the band below the first that the
        # single-card frame covers most
        band_h = -(-resolution[1] // shape[1])
        covered = [int((refs[key][0]["order"][ti * band_h:(ti + 1) * band_h]
                        >= 0).sum()) for ti in range(1, shape[1])]
        check = (shape[0] - 1, 1 + int(np.argmax(covered)))
        got = [r[key] for r in ranks]
        if len({g["image"] for g in got}) != 1:
            raise AssertionError(f"{key}: the ranks presented different "
                                 "images")
        n = got[0]["frames"]
        for g in got:
            if (g["counts"]["fused_setup"] != n or g["counts"][variant] != n
                    or sum(g["counts"].values()) != 2 * n):
                raise AssertionError(f"{key}: rank launches {g['counts']} "
                                     f"in {n} frames")
        peel2 = key == "config4"
        if any(g["peel2"] != peel2 or g["remaps"] != int(peel2)
               or tuple(g["shape"]) != shape for g in got):
            raise AssertionError(
                f"{key}: peel2, remap messages, mesh "
                f"{[(g['peel2'], g['remaps'], g['shape']) for g in got]}")
        launches[f"mesh_2x2_{key}"] = {
            k: sum(g["counts"][k] for g in got) for k in got[0]["counts"]}
        frame, plan, image = frames[key]
        make, t = rigs[key]
        dev = build_device()
        plain, checked = mesh_on_one_card(dev, make(dev, resolution), t,
                                          resolution, plan, shape, check)
        del dev
        torch.cuda.empty_cache()
        log("mesh", f"({'c' if peel2 else 'b'}) {key}, the rank at (draws, "
            f"tiles) {check}: {checked}")
        for k in plain:
            if not np.array_equal(frame[k].view(np.int32),
                                  plain[k].view(np.int32)):
                raise AssertionError(
                    f"{key}: the mesh's {k} map differs from its bands "
                    f"and draw shares composited on one card at "
                    f"{int((frame[k] != plain[k]).sum())} values")
        off = mesh_vs_single(frame, refs[key][0], image, refs[key][1])
        if (max(off["winner"], off["u8"], off["depth_same"]) >= budget
                or off["max_dz_same"] > SAME_WINNER_MAX_DZ):
            raise AssertionError(f"{key}: off the single-card frame {off} "
                                 f"(budget {budget:.2%}, depth at the same "
                                 f"winner at most {SAME_WINNER_MAX_DZ})")
        log("mesh", f"({'c' if peel2 else 'b'}) {key} "
            f"{resolution[0]}x{resolution[1]} on 2x2"
            f"{' remapped to 1x4 (said once a rank)' if peel2 else ''}, "
            f"bands of {band_h} rows: bit-equal to "
            f"its bands and draw shares composited on one card; against the "
            f"single-card frame, another winning triangle at "
            f"{off['winner']:.4%} of px, the image more than 1 u8 off at "
            f"{off['u8']:.4%}, and where the winner is the same, depth more "
            f"than {SAME_WINNER_STEPS} D16 steps off at "
            f"{off['depth_same']:.4%} (budget {budget:.2%} each; max "
            f"{off['max_dz_same']:.4g}, at most {SAME_WINNER_MAX_DZ}); "
            f"depth more than a D16 step off at {off['depth']:.4%} (max "
            f"{off['max_dz']:.4g}), color more than 1e-3 off at "
            f"{off['color']:.4%} (band-local coordinates round the planes "
            f"differently in f32); every rank presents the same image; "
            f"launches a rank {got[0]['counts']} in {n} frames; steady "
            f"ms/frame by CUDA events "
            + ", ".join(f"{g['ms']:.3f}" for g in got) + ", by host clock "
            + ", ".join(f"{g['host_ms']:.3f}" for g in got))


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


# each kernel of the kernels line: the start of its instances' names in
# ptxas's report (variant_kernel's last template argument is PACKED)
KERNEL_SYMBOLS = {
    "fused_setup": "fused_setup_kernel",
    "rasterize_visibility": "visibility_kernel<(bool)0, (bool)0>",
    "rasterize_visibility_peel2": "visibility_kernel<(bool)1, (bool)0>",
    "rasterize_visibility_counts": "visibility_kernel<(bool)0, (bool)1>",
    "raster_exact": "raster_exact_kernel",
    "bin_emit": "binning_emit_kernel",
    "gather_rows": "gather_rows_kernel",
    "fixed_grid": "fixed_grid_kernel",
    "fixed_cost": "fixed_cost_kernel",
    "fill": "fill_kernel",
    "pipe_cost": "pipe_cost_kernel",
    "visibility_variant": "variant_kernel",
    "visibility_packed": "variant_kernel",
    "mxu": "mxu_kernel",
    "transpose_rows": "rows_to_cols_kernel<(int)24",
    "field_compute": "rows_to_cols_kernel<(int)16",
}


def ptxas_of(name, resources) -> dict:
    """{instance: [registers, spill-store bytes]} of a kernel of the
    kernels line, from ptxas's report (``_build.kernel_resources``)."""
    out = {}
    for sym, (regs, spill) in resources.items():
        sym = sym.split("::")[-1]
        if not sym.startswith(KERNEL_SYMBOLS[name]):
            continue
        if sym.startswith("variant_kernel") and sym.endswith(
                "(bool)1>") != (name == "visibility_packed"):
            continue
        out[sym] = [regs, spill]
    if not out:
        raise AssertionError(f"{name}: no instance in ptxas's report")
    return out


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


def poisoned(n, device, call):
    """``call()`` after NaN filled the n blocks of 1088 x 1920 f32 that the
    allocator hands out next: a pixel the kernel misses stays NaN."""
    blocks = [torch.full((1088, 1920), float("nan"), device=device)
              for _ in range(n)]
    del blocks
    return call()


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

    # P7: every variant of the tool, and one more without the block max
    depth = exp_fixed_grid.depth_input(device)
    depth[::97, ::89] = 2.5   # blocks whose max adds 1.0
    depth[1079, 300] = 2.5    # and a padded last block row's
    err["fixed_grid"] = max(
        check_bit_equal(f"fixed_grid {kw}",
                        exp_fixed_grid.fixed_grid(depth, **kw),
                        exp_fixed_grid.fixed_grid_reference(depth, **kw))
        for kw in (*exp_fixed_grid.VARIANTS.values(),
                   dict(rows=32, nouts=3, zmax_reduce=False)))
    plain_ms["fixed_grid"] = cuda_ms(
        lambda: exp_fixed_grid.fixed_grid_reference(depth, 16), 5)

    # P6: the tool's variants, segments from row 3, and tile starts in no
    # order on a short table (a CTA's tiles take 0 to 8 trips, bases in its
    # short last chunk) at every map count; each output NaN before the call
    table, tiny, depth0, ts_empty = exp_fixedcost.tool_inputs(device)
    ts_seg = exp_fixedcost.segment_starts(device)
    short = table[:exp_fixedcost.SHORT_E].contiguous()
    p6_cases = [(table, ts_empty, 7), (tiny, ts_empty, 1), (tiny, ts_empty, 3),
                (table, ts_seg, 7),
                *((short, exp_fixedcost.jumbled_starts(device, seed=n), n)
                  for n in range(1, 8))]
    err["fixed_cost"] = max(
        check_bit_equal(
            "fixed_cost",
            poisoned(n_out, device, lambda: exp_fixedcost.fixed_cost(
                tab, ts, depth0, n_out=n_out)),
            exp_fixedcost.fixed_cost_reference(tab, ts, depth0, n_out=n_out))
        for tab, ts, n_out in p6_cases)
    plain_ms["fixed_cost"] = cuda_ms(lambda: exp_fixedcost.fixed_cost_reference(
        table, ts_empty, depth0, n_out=7), 5)
    # the tool's shapes, and one whose rows take the scalar ends
    err["fill"] = max(
        check_bit_equal("fill", [exp_fixedcost.fill(*shape, device)],
                        [exp_fixedcost.fill_reference(*shape, device)])
        for shape in (*exp_fixedcost.LAUNCH_VARIANTS.values(), (3, 5, 7, 13)))
    shape = exp_fixedcost.LAUNCH_VARIANTS["launch_68x15_16x128"]
    plain_ms["fill"] = cuda_ms(
        lambda: exp_fixedcost.fill_reference(*shape, device), 20)
    del table, tiny, short, ts_seg, p6_cases

    # P1: the tool's variants, then tile starts in no order on a short
    # table (0 to 16 trips a tile, windows clamped at its end) at tpp 1, 4
    # and 17 (16 tile rows side by side, one lane with a second row); each
    # output NaN before the call
    entries, ts_zero, ts_one = exp_pipecost.tool_inputs(device)
    short = entries[:exp_pipecost.SHORT_E].contiguous()
    p1_cases = [(f"pipe_cost {name}", entries,
                 ts_one if kw["ts"] == "one" else ts_zero, kw["tpp"],
                 dict(nout=kw["nout"], level=kw["level"]))
                for name, kw in exp_pipecost.VARIANTS.items()]
    p1_cases += [(f"pipe_cost jumbled tpp {tpp}", short,
                  exp_pipecost.jumbled_starts(device, seed=tpp), tpp,
                  dict(nout=7, level=2)) for tpp in (1, 4, 17)]
    err["pipe_cost"] = max(
        check_bit_equal(
            what, poisoned(args["nout"], device, lambda: exp_pipecost.run(
                ent, ts, tpp=tpp, **args)),
            exp_pipecost.pipe_cost_reference(ent, ts, **args))
        for what, ent, ts, tpp, args in p1_cases)
    del short, p1_cases
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

    k3_ms = records["rasterize_visibility"]["ms"]
    for name, _, tool, variant, _ in PROBES:
        r = timed[(tool, variant)]
        records[name] = dict(
            max_abs_err=err[name], ms=r["ms"], plain_ms=plain_ms[name],
            library_ms=r.get("library_ms"), **bound_fields(r))
        log("probes", f"{name} ({variant}): checked; kernel "
            f"{r['ms']:.4f} ms by CUDA graph, plain {plain_ms[name]:.4f} ms; "
            f"{share(records[name])}; {r['ms'] / k3_ms:.1%} of K3's "
            f"{k3_ms:.4f} ms by CUDA graph on the sponza table")
    r = timed[("exp_pipecost", "v_loop1")]
    log("probes", f"P1 v_loop1 stages {r['staged_bytes']} bytes of windows "
        f"beside its bound's {r['bytes']}: their floor "
        f"{r['staged_floor_ms']:.4f} ms, {r['staged_floor_ms'] / r['ms']:.1%}"
        f" of its time")
    log("probes", f"K3's floor (its launch on the empty table) "
        f"{records['k3_floor_ms']:.4f} ms by CUDA graph, beside P7 "
        f"{records['fixed_grid']['ms']:.4f}, P6 {records['fixed_cost']['ms']:.4f}"
        f" and P1 {records['pipe_cost']['ms']:.4f} ms")
    log("probes", f"launches on the tools' path {launches['probes']}")
    return [(name, replaces, source) for name, replaces, _, _, source
            in PROBES]


HOST_IO_TIMES = (0.9, 0.6, 0.3)   # phase 15's config-2 frames


def kernel_base_names(resources, names) -> list[str]:
    """The kernel function names, without templates, of the kernels line's
    ``names`` in ptxas's report (as CUPTI's kernel events carry them)."""
    syms = [s.split("::")[-1] for s in resources]
    found = []
    for name in names:
        bases = {s.split("<")[0] for s in syms
                 if s.startswith(KERNEL_SYMBOLS[name])}
        if len(bases) != 1:
            raise AssertionError(f"{name}: kernel names {bases} in ptxas's "
                                 "report")
        found += bases
    return found


def phase_host_io(build_device, launches, card, resources, build_s, compiled,
                  image_1080, res=(800, 600)):
    """Phase 15: the PNG present target, the pipeline cache and the
    profiler's trace on the card."""
    import glob
    import io
    import os
    import tempfile
    import zipfile

    import tyleri_tpu_torch as tt
    from tyleri_tpu_torch import _build, native
    from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
    from tyleri_tpu_torch.testing import seeded_frame
    from tyleri_tpu_torch.utils import image
    from tyleri_tpu_torch.utils.profiling import annotate, trace

    if not native.available():
        raise AssertionError(f"native host runtime: {native.build_error()}")
    setup_cuda.reset_launches()
    raster_cuda.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) every presented frame written by write_png's native encoder
        encode = native.png_encode
        encodes, paths = [0], []

        def counted(rgba):
            encodes[0] += 1
            return encode(rgba)

        def present(img):
            paths.append(os.path.join(tmp, f"frame{len(paths)}.png"))
            image.write_png(paths[-1], img)

        dev = build_device()
        rig = tt.scenes.config2_cube(dev, res)
        win = tt.RenderWindow(dev, resolution=res, present_mode="immediate",
                              present_target=present)
        native.png_encode = counted
        try:
            render_frames(win, rig, HOST_IO_TIMES)
        finally:
            native.png_encode = encode
        if len(paths) != len(HOST_IO_TIMES) or encodes[0] != len(paths):
            raise AssertionError(f"{len(paths)} frames written, {encodes[0]} "
                                 "by the native encoder")
        if not np.array_equal(image.read_png(paths[-1]), win.latest_image):
            raise AssertionError("the last PNG differs from latest_image")
        first = image.read_png(paths[0])
        log("host-io", f"config 2 {res[0]}x{res[1]}: {len(paths)} presented "
            "frames written by the native encoder, the last read back equal "
            "to latest_image")

        # config 5's 1080p frame, native encoder against the python path
        def timed_write(path):
            best = float("inf")
            for _ in range(3):
                t = time.perf_counter()
                image.write_png(path, image_1080)
                best = min(best, time.perf_counter() - t)
            with open(path, "rb") as f:
                return best * 1e3, f.read()

        native_ms, native_png = timed_write(os.path.join(tmp, "n.png"))
        available = native.available
        native.available = lambda: False
        try:
            python_ms, python_png = timed_write(os.path.join(tmp, "p.png"))
        finally:
            native.available = available
        for which in ("n.png", "p.png"):
            if not np.array_equal(image.read_png(os.path.join(tmp, which)),
                                  image_1080):
                raise AssertionError(f"{which}: the 1080p PNG reads back "
                                     "another image")
        h, w = image_1080.shape[:2]
        log("host-io", f"config 5 {w}x{h} PNG: native {native_ms:.3f} ms "
            f"({len(native_png)} B), python zlib {python_ms:.3f} ms "
            f"({len(python_png)} B), bytes equal: "
            f"{native_png == python_png} (best of 3, host clock; {card})")

        # (b) a new process seeded from this device's pipeline cache
        blob = dev.pipeline_cache.get_data()
        names = zipfile.ZipFile(io.BytesIO(blob)).namelist()
        lib = os.path.basename(_build.library_path())
        if lib not in names or os.path.basename(
                native.library_path()) not in names:
            raise AssertionError(f"the cache's bytes hold {names}")
        got = seeded_frame.run(blob, config=2, resolution=res)
        if (got["compiles"], got["host_compiles"]) != (0, 0):
            raise AssertionError(f"the seeded process built: {got}")
        for key in ("library", "host_library"):
            if not got[key].startswith(got["directory"] + os.sep):
                raise AssertionError(f"{key} {got[key]} not in the seeded "
                                     f"directory {got['directory']}")
        if got["launches"]["fused_setup"] != 1 or \
                got["launches"]["peel2"] != 1:
            raise AssertionError(f"seeded frame launches {got['launches']}")
        if got["image_sha256"] != seeded_frame.image_digest(first):
            raise AssertionError("the seeded process's config-2 frame differs"
                                 " from this process's")
        log("host-io", f"pipeline cache: {len(blob)} B ({', '.join(names)}); "
            f"seeded process: 0 nvcc and 0 g++ builds, device in "
            f"{got['device_s']:.2f} s and first presented frame in "
            f"{got['first_frame_s']:.2f} s from its spawn, its frame equal to"
            f" this process's; phase 2 {'compiled' if compiled else 'loaded'}"
            f" the kernels in {build_s:.1f} s ({card})")

        # (c) a trace of three frames, each an annotated range
        log_dir = os.path.join(tmp, "trace")
        win = tt.RenderWindow(dev, resolution=res, present_mode="immediate")
        with trace(log_dir):
            for t in HOST_IO_TIMES:
                with annotate("frame"):
                    rig.fill(win.get_render_scene(), t)
                    win.render()
            win.flush()
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        frames = sum(e.get("cat") == "user_annotation"
                     and e.get("name") == "frame" for e in events)
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        wanted = kernel_base_names(resources, (
            "fused_setup", "rasterize_visibility_peel2"))
        counts = {k: sum(k in name for name in kernels) for k in wanted}
        if frames != len(HOST_IO_TIMES) or any(
                c < len(HOST_IO_TIMES) for c in counts.values()):
            raise AssertionError(f"trace: {frames} frame ranges, kernel "
                                 f"events {counts} of {len(kernels)}")
        log("host-io", f"trace: {frames} frame ranges, {len(kernels)} kernel "
            f"events, of them {counts}")
    launches["host-io"] = dict(raster_cuda.variant_launches,
                               fused_setup=setup_cuda.launches)
    want = 2 * len(HOST_IO_TIMES)
    if (launches["host-io"]["fused_setup"], launches["host-io"]["peel2"]) \
            != (want, want):
        raise AssertionError(f"host-io launches {launches['host-io']}")


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
    build_s, compiled = time.perf_counter() - t0, _build.compiles > 0
    log("build", f"kernels {'built and ' if compiled else ''}loaded in "
        f"{build_s:.1f} s ({_build.library_path()})")
    resources = _build.kernel_resources()
    log("build", "registers (spill-store bytes) by ptxas: " + "; ".join(
        f"{k} {r} ({s} B)" for k, (r, s) in sorted(resources.items())))

    def build_device(callback=None, anisotropy=None):
        b = RenderDeviceBuilder().validation_level(ValidationLevel.WARNING)
        if anisotropy:
            b = b.max_sampler_anisotropy(anisotropy)
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
    phase("bin-emit", phase_bin_emit, device, rf, sp, records, launches)
    # the port's binning gather of this frame, for the probes' phase
    n = int(binned.num_entries)
    sponza_gather = (su.channels, binned.entry_channels[:n])
    del rf, sp, binned, depth0, su
    torch.cuda.empty_cache()
    phase("k3-peel2", phase_peel2, build_device, SPONZA_RES, records)
    torch.cuda.empty_cache()
    phase("configs 1-3", phase_small_configs, build_device, launches)
    config4 = phase("config4", phase_config4, build_device, SPONZA_RES,
                    launches)
    sponza = phase("config5", phase_sponza, build_device, SPONZA_RES,
                   launches)
    image_1080 = sponza[2].latest_image.copy()   # for phase 15's encode
    phase("ui", phase_ui, sponza, launches, SPONZA_RES, records)
    del sponza
    torch.cuda.empty_cache()
    phase("exact", phase_exact, build_device, launches, SPONZA_RES, config4)
    phase("depth-states", phase_depth_states, build_device, launches)
    torch.cuda.empty_cache()
    probe_kernels = phase("probes", phase_probes, device, card, records,
                          launches, sponza_gather)
    del sponza_gather
    torch.cuda.empty_cache()
    phase("mesh", phase_mesh, build_device, launches, SPONZA_RES)
    phase("host-io", phase_host_io, build_device, launches, card, resources,
          build_s, compiled, image_1080)
    del image_1080

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
        dict(name="raster_exact", route="cuda",
             source="tyleri_tpu_torch/csrc/raster_exact.cu",
             replaces="none (tyleri_tpu/ops/raster_exact.py is plain jnp)",
             launches=path_sum("raster_exact"), **records["raster_exact"]),
        dict(name="bin_emit", route="cuda",
             source="tyleri_tpu_torch/csrc/binning_emit.cu",
             replaces="none (tyleri_tpu/ops/binning.py is plain XLA)",
             launches=path_sum("bin_emit"), **records["bin_emit_sponza"],
             statue=records["bin_emit_statue"]),
    ] + [dict(name=name, route="cuda",
              source=f"tyleri_tpu_torch/csrc/{source}", replaces=replaces,
              launches=launches["probes"][name], **records[name])
         for name, replaces, source in probe_kernels]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel no path launched: {launches}")
    for k in kernels:
        k["share"] = k["bound_ms"] / k["ms"]
        k["ptxas"] = ptxas_of(k["name"], resources)
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} "
        f"s; launches per path {launches}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
