"""Multi-device rendering of the port (tyleri_tpu_torch.parallel) on gloo
ranks on the CPU, against the port's single-device frame and, where
tests/test_parallel.py holds the JAX package to its own, against the JAX
package's sharded frame on the 8 virtual devices the root conftest sets.

Every case of tests/test_parallel.py that renders has a counterpart here, at
the same resolution, scenes, mesh shapes and budgets.  The ranks are 8
processes of their own (tests/torch_mesh_worker.py, which imports only the
port) in one gloo group, which run every case, the smaller meshes over the
first ranks; they are spawned when the first test asks for them, and this
process renders the JAX package's frames meanwhile.  The rendezvous goes
through a file store in the test's temporary directory; a rank that fails,
or ranks that outlast JOIN_S, fail the test that waits for them.
"""

import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax

import torch_mesh_worker as worker
import tyleri_tpu as ty
import tyleri_tpu_torch as tt
from tyleri_tpu.models import primitives as jprim
from tyleri_tpu.models import scenes as jscenes
from tyleri_tpu.parallel.mesh import make_render_mesh as jax_mesh
from tyleri_tpu.parallel.sharding import render_frame_sharded as jax_sharded
from tyleri_tpu.pipeline.state import CompareOp as JaxCompareOp
from tyleri_tpu.scene.mesh_renderer import MeshRenderer as JaxMeshRenderer
from tyleri_tpu.scene.render_scene import RenderScene as JaxScene
from tyleri_tpu.window.swapchain import ImageViewSwapchain as JaxSwapchain
from tyleri_tpu_torch.interop import from_jax, load_render_device
from tyleri_tpu_torch.parallel.mesh import make_render_mesh
from tyleri_tpu_torch.parallel.sharding import derive_draw_groups
from tyleri_tpu_torch.rendering.forward import frame_body

RES = worker.RES
WORLD = 8
JOIN_S = 240


class Ranks:
    """The 8 ranks; ``case(name)`` waits for them and returns what each
    rank in the case's mesh returned, and the case's single-device
    reference."""

    def __init__(self, tmp):
        self._dir, self._results = tmp, None
        self._procs = mp.start_processes(
            worker.run, args=(WORLD, str(tmp / "store"), str(tmp)),
            nprocs=WORLD, join=False, start_method="spawn")
        self._deadline = time.monotonic() + JOIN_S

    def result(self):
        if self._results is None:
            while not self._procs.join(timeout=1):
                if time.monotonic() > self._deadline:
                    self.stop()
                    pytest.fail(f"the ranks outlasted {JOIN_S} s")
            self._results = []
            for r in range(WORLD):
                with open(self._dir / f"rank{r}.pkl", "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def case(self, name):
        ranks = self.result()
        refs = [r["references"][name] for r in ranks
                if name in r["references"]]
        assert len(refs) <= 1
        got = [r["cases"][name] for r in ranks]
        return ([g for g in got if g is not None],
                refs[0] if refs else None)

    def stop(self):
        for p in self._procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("mesh"))
    yield r
    r.stop()


@pytest.fixture(scope="module")
def jax_frames(ranks):
    """The JAX package's sharded frames and the port's single-device frames
    of the same scenes through interop, rendered here while the ranks
    run."""
    out = {}
    built = jax_build(lambda d: jscenes.config4_instances(
        d, RES, n_instances=12))
    out["hybrid"] = jax_frame(built, 2, 8), port_single_from_interop(built)
    for less in (False, True):
        built = jax_tie(less)
        out["tie_less" if less else "tie_le"] = (
            jax_frame(built, 2, 2), port_single_from_interop(built,
                                                             less=less))
    built = jax_build(lambda d: jscenes.config4_instances(
        d, RES, n_instances=6), exact=True)
    out["exact_2"] = (jax_frame(built, 2, 8),
                      port_single_from_interop(built, exact=True))
    out["sponza_bands"] = jax_bands_and_single(jax_build(
        lambda d: jscenes.config5_sponza(d, worker.SPONZA_RES,
                                         grid_n=worker.SPONZA_GRID),
        res=worker.SPONZA_RES, t=0.0), worker.SPONZA_RES, 8)
    return out


def frame_of(ranks, name):
    """The gathered frame of a case, its single-device reference, and a
    check that every rank of its mesh gathered the same frame under the
    same plan."""
    got, want = ranks.case(name)
    for g in got[1:]:
        assert g["plan"] == got[0]["plan"], "the ranks' plans diverged"
        np.testing.assert_array_equal(g["color"], got[0]["color"])
        np.testing.assert_array_equal(g["depth"], got[0]["depth"])
    return got[0], want


def share_off(got, want, depth_tol=1e-6, color_tol=1e-3):
    d = float((np.abs(got["depth"] - want["depth"]) > depth_tol).mean())
    c = float((np.abs(got["color"] - want["color"]).max(-1) > color_tol)
              .mean())
    return d, c


# ---- the JAX package's sharded frames (this process, 8 virtual devices) --

def jax_build(rig_factory, exact=False, res=RES, t=0.6):
    from tyleri_tpu.rendering.forward import ForwardRenderingFunction

    dev = ty.RenderDeviceBuilder().build()
    rig = rig_factory(dev)
    rf = ForwardRenderingFunction(dev, JaxSwapchain(res), exact=exact)
    scene = JaxScene()
    rig.fill(scene, t)
    return dev, rf, scene


def jax_tie(less):
    import dataclasses

    from tyleri_tpu.models.scenes import _camera, _upload, _upload_texture
    from tyleri_tpu.rendering.forward import ForwardRenderingFunction

    dev = ty.RenderDeviceBuilder().build()
    verts, idx = jprim.triangle(z=0.5)
    v, i = _upload(dev, verts, idx)
    red = _upload_texture(dev, np.full((1, 1, 4), [1, 0, 0, 1], np.float32))
    green = _upload_texture(dev, np.full((1, 1, 4), [0, 1, 0, 1], np.float32))
    rf = ForwardRenderingFunction(dev, JaxSwapchain(RES))
    if less:
        rf.mesh_state = dataclasses.replace(rf.mesh_state, depth=(
            dataclasses.replace(rf.mesh_state.depth,
                                compare_op=JaxCompareOp.LESS)))
    scene = JaxScene()
    cam = _camera(RES, [0, 0, 2.2], [0, 0, 0])
    cam.mesh_renderers.append(JaxMeshRenderer(v, i, red))
    cam.mesh_renderers.append(JaxMeshRenderer(v, i, green))
    scene.add_camera(cam)
    return dev, rf, scene


def jax_frame(built, n_draw_shards, n_devices):
    """The JAX package's sharded frame on n_draw_shards x (n_devices /
    n_draw_shards) of the virtual devices."""
    dev, rf, scene = built
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    mesh = jax_mesh(n_draw_shards, devices=jax.devices()[:n_devices])
    color, depth, *_ = jax_sharded(rf.plan, rf.mesh_state, rf.ui_state,
                                   mesh, *arrays)
    return dict(color=np.asarray(color), depth=np.asarray(depth))


def jax_bands_and_single(built, res, n_devices):
    """The JAX package's frame in n_devices tile bands and its
    single-device frame, on a plan grown until neither overflows."""
    from tyleri_tpu.rendering.forward import _render_frame

    dev, rf, scene = built
    for _ in range(8):
        arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, res)
        single = _render_frame(rf.plan, rf.mesh_state, rf.ui_state, *arrays)
        stats = [int(single.bin_overflow), int(single.tile_overflow),
                 int(single.clip_overflow), int(single.clip_crossings)]
        if not (stats[0] or stats[2]):
            break
        rf.note_overflow(*stats)
    mesh = jax_mesh(1, devices=jax.devices()[:n_devices])
    color, depth, order, bin_of, _, clip_of, _ = jax_sharded(
        rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    assert not (stats[0] or stats[2] or int(bin_of) or int(clip_of))
    return ({k: np.asarray(v) for k, v in (("color", color),
                                            ("depth", depth),
                                            ("order", order))},
            {k: np.asarray(getattr(single, k))
             for k in ("color", "depth", "order")})


def port_single_from_interop(built, exact=False, less=False):
    """The port's single-device frame of the JAX scene rebuilt through
    interop (the JAX device's bytes copied into a port device): the ranks,
    which build the scene with the port's copy of the scene module, must
    have rendered the same frame."""
    import dataclasses

    jdev, jrf, jscene = built
    tdev = tt.RenderDeviceBuilder().device("cpu").build()
    load_render_device(tdev, jdev)
    trf = tt.ForwardRenderingFunction(tdev, tt.ImageViewSwapchain(RES),
                                      exact=exact)
    if less:
        trf.mesh_state = dataclasses.replace(trf.mesh_state, depth=(
            dataclasses.replace(trf.mesh_state.depth,
                                compare_op=tt.CompareOp.LESS)))
    scene = from_jax(jscene)
    inputs = trf.build_frame_inputs(tdev, scene.render_resources, 1.0, RES)
    # one thread: the frame's many small ops stall on a pool of threads
    # that the other test workers and the ranks keep off the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        f = frame_body(trf.plan, trf.mesh_state, *inputs,
                       ui_state=trf.ui_state)
    finally:
        torch.set_num_threads(threads)
    return dict(color=f.color.numpy(), depth=f.depth.numpy())


def assert_same_frame(a, b):
    np.testing.assert_array_equal(a["color"], b["color"])
    np.testing.assert_array_equal(a["depth"], b["depth"])


# ---- the cases -----------------------------------------------------------

def test_hybrid_draws_x_tiles_mesh(ranks, jax_frames):
    jax_want, interop = jax_frames["hybrid"]           # JAX 2 x 4
    got, want = frame_of(ranks, "hybrid")           # 2 x 4
    assert_same_frame(interop, want)
    for ref, what in ((want, "single device"), (jax_want, "JAX 2x4")):
        d, c = share_off(got, ref)
        print(f"hybrid 2x4 vs {what}: depth {d:.3%}, color {c:.3%}")
        assert d < 0.01 and c < 0.01


def test_sort_first_tile_bands_match_single_device(ranks):
    got, want = frame_of(ranks, "tile_bands")      # 1 x 8 bands
    assert got["band_rows"] == 8
    # band-local coordinates round differently in f32: ~1 D16 step
    np.testing.assert_allclose(got["color"], want["color"], atol=2e-4)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=1.6e-5)


def band_rounding(got, want):
    """How far a banded frame is from its single-device frame: the share
    of pixels more than a D16 step off in depth, the share whose winner
    differs, and the largest depth move where the winner is the same."""
    dz = np.abs(got["depth"] - want["depth"])
    same = got["order"] == want["order"]
    return (float((dz > 1.6e-5).mean()), float(1.0 - same.mean()),
            float(np.where(same, dz, 0.0).max()))


def test_band_rounding_matches_reference(ranks, jax_frames):
    """Band-local coordinates round a steep plane's constant differently
    in f32, so a band's depths move off the single-device frame's at some
    pixels of a reduced sponza; the JAX package's bands move them the same
    way, by as much, at as many pixels (within a factor of 3)."""
    jax_bands, jax_single = jax_frames["sponza_bands"]  # JAX 1 x 8
    got, want = frame_of(ranks, "sponza_bands")         # 1 x 8
    assert got["overflow"] == 0
    port = band_rounding(got, want)
    ref = band_rounding(jax_bands, jax_single)
    print(f"sponza 1x8 bands off their single-device frame, port / JAX: "
          f"depth > a D16 step {port[0]:.4%} / {ref[0]:.4%}, winner "
          f"{port[1]:.4%} / {ref[1]:.4%}, largest move at the same winner "
          f"{port[2]:.4g} / {ref[2]:.4g}")
    for depth, winner, dz_same in (port, ref):
        assert 0.0 < depth < 0.01 and winner < 0.01
        assert dz_same < 16 / 65535
    assert port[0] < 3 * ref[0] and ref[0] < 3 * port[0]


def test_draw_shard_only(ranks):
    got, want = frame_of(ranks, "draws_only")      # 2 x 1
    _, c = share_off(got, want)
    assert c < 0.01


def test_sharded_peel2_tiles_only_matches_single_device(ranks):
    got, want = frame_of(ranks, "peel2_tiles")     # 1 x 8
    d, c = share_off(got, want, depth_tol=1.6e-5, color_tol=2e-4)
    print(f"peel2 1x8: depth {d:.3%}, color {c:.3%}")
    assert d < 0.002 and c < 0.002


def test_sharded_peel2_draw_mesh_remaps_to_tiles_only(ranks):
    got, want = frame_of(ranks, "peel2_remap")     # 2 x 1 -> 1 x 2
    assert got["peel2"] and got["mesh_shape"] == (1, 2)
    assert got["color"][..., :3].max() > 0
    # said once, at the first frame, not again
    assert got["first"] == got["second"] == 1
    assert not got["shard_local"]
    _, c = share_off(got, want, color_tol=2e-4)
    assert c < 0.002, f"{c:.3%} color pixels differ from single device"


@pytest.mark.parametrize("less", [False, True], ids=["less_or_equal", "less"])
def test_equal_z_tie_resolves_by_draw_order_across_devices(ranks, jax_frames,
                                                           less):
    """Two identical triangles as two draws on two ranks: LESS_OR_EQUAL
    lets the later (green) draw win every tie, LESS keeps the earlier
    (red); the composite reproduces the single-device frame and the JAX
    package's sharded frame with zero pixels off."""
    name = "tie_less" if less else "tie_le"
    jax_want, interop = jax_frames[name]               # JAX 2 x 1
    got, want = frame_of(ranks, name)
    assert_same_frame(interop, want)
    winner, loser = (0, 1) if less else (1, 0)
    assert (want["color"][..., winner] > 0).any()
    assert not (want["color"][..., loser] > 0).any()
    assert_same_frame(got, want)
    assert_same_frame(got, jax_want)


def test_sharded_ui_overlay_spans_band_boundaries(ranks):
    got, want = frame_of(ranks, "ui_bands")        # 1 x 8
    assert (want["depth"] == 0.0).sum() > 500, "UI quads write depth 0"
    np.testing.assert_allclose(got["color"], want["color"], atol=2e-4)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=1.6e-5)


@pytest.mark.parametrize("layout", [1, 2])
def test_sharded_exact_mode_matches_single_device(ranks, jax_frames, layout):
    """Exact mode has no order map on a mesh: equal depths across ranks go
    to the lowest draws index.  Layout 1 is 8 bands, 2 is 2 x 4; the 2 x 4
    mesh is also held to the JAX package's."""
    got, want = frame_of(ranks, f"exact_{layout}")
    assert (want["depth"] < 1.0).any()
    refs = [(want, "single device")]
    if layout == 2:
        jax_want, interop = jax_frames["exact_2"]
        assert_same_frame(interop, want)
        refs.append((jax_want, "JAX 2x4"))
    for ref, what in refs:
        d, c = share_off(got, ref, depth_tol=1.6e-5, color_tol=2e-3)
        print(f"exact layout {layout} vs {what}: depth {d:.3%}, "
              f"color {c:.3%}")
        assert d < 0.01 and c < 0.01


@pytest.mark.parametrize("height", [60, 52])
def test_non_divisible_band_heights_match_single_device(ranks, height):
    """Bands of ceil(h / 8) rows, the padding cropped: 60 / 8 leaves a
    partial last band, 52 / 4 a band of 13 rows, not tile-aligned."""
    for layout in (1, 2):
        got, want = frame_of(ranks, f"height{height}_{layout}")
        assert (want["depth"] < 1.0).any(), "the cube must be visible"
        assert got["color"].shape == (height, 64, 4)
        assert got["depth"].shape == (height, 64)
        assert got["band_rows"] == -(-height // (8 // layout))
        np.testing.assert_allclose(got["color"], want["color"], atol=2e-4)
        np.testing.assert_allclose(got["depth"], want["depth"], atol=1.6e-5)


def test_composite_traffic_stays_o_band_as_draw_axis_grows(ranks):
    """The composite's bytes a rank are the same for 2 and 4 draw shards
    of one band, and it gathers nothing (the rank fails the frame on an
    all_gather)."""
    b2, _ = ranks.case("traffic_2")
    b4, _ = ranks.case("traffic_4")
    assert len(b2) == 2 and len(b4) == 4
    assert len({(b["bytes"], b["calls"]) for b in b2 + b4}) == 1, (b2, b4)
    b2 = b2[0]
    assert b2["calls"] == 6
    # depth bits, order key, owner, color (4 channels) and the 4 counters
    assert b2["bytes"] == RES[0] * RES[1] * 4 * 7 + 2 * 16


def test_sharded_hybrid_clip_matches_single_device(ranks):
    got, want = frame_of(ranks, "hybrid_clip")     # 2 x 4
    assert got["crossings"] > 0, "the hybrid must have clipped"
    assert (want["depth"] < 1.0).any()
    d, c = share_off(got, want)
    assert d < 0.01 and c < 0.01


def test_render_window_mesh(ranks):
    """RenderWindow(device_mesh=make_render_mesh(2)) on 8 ranks: every rank
    presents the same whole image, within 1 % of the single-device
    window's."""
    got, want = ranks.case("window")
    images = [g["image"] for g in got]
    assert images[0].shape == (RES[1], RES[0], 4)
    for img in images[1:]:
        np.testing.assert_array_equal(img, images[0])
    bad = (np.abs(images[0].astype(int) - want["image"].astype(int))
           .max(-1) > 1).mean()
    assert bad < 0.01, f"{bad:.3%} pixels differ from a single device"


def test_one_by_one_mesh_equals_single_device_bit_for_bit(ranks):
    got, want = frame_of(ranks, "one_by_one")
    assert_same_frame(got, want)
    (win,), single = ranks.case("one_by_one_window")
    np.testing.assert_array_equal(win["image"], single["image"])


MESH_CASES = {
    "1x8": ["tile_bands", "peel2_tiles", "ui_bands", "sponza_bands",
            "exact_1", "height60_1", "height52_1"],
    "2x4": ["hybrid", "exact_2", "height60_2", "height52_2", "hybrid_clip",
            "window"],
    "2x1": ["draws_only", "peel2_remap", "tie_le", "tie_less", "traffic_2"],
    "4x1": ["traffic_4"],
    "1x1": ["one_by_one", "one_by_one_window"],
}


@pytest.mark.parametrize("shape", sorted(MESH_CASES))
def test_ranks_keep_identical_plans(ranks, shape):
    """Diverging plans would give the collectives different shapes, which
    hangs instead of raising: every rank of a mesh ends each of its cases
    with one plan."""
    nd, nt = (int(v) for v in shape.split("x"))
    for name in MESH_CASES[shape]:
        got, _ = ranks.case(name)
        assert len(got) == nd * nt, name
        assert len({g["plan"] for g in got}) == 1, name


def test_make_render_mesh_raises(ranks):
    """Without a process group, and on a world (8 ranks) that the draw
    shards (3) do not divide."""
    with pytest.raises(RuntimeError):
        make_render_mesh(1, "cpu")
    got, _ = ranks.case("indivisible")
    assert len(got) == WORLD and len(set(got)) == 1
    assert "not divisible" in got[0]


def test_derive_draw_groups_raises_on_drift():
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config4_instances(dev, RES, n_instances=5)
    scene = tt.RenderScene()
    rig.fill(scene, 0.6)
    cams = scene.render_resources.cameras
    assert derive_draw_groups(cams, 2) == [[[0, 2, 4], [1, 3]]]
    cam = cams[0]
    plain = cam.get_and_order_meshes

    def drifted(n):
        pg = plain(n)
        pg._groups[0], pg._groups[1] = pg._groups[1], pg._groups[0]
        return pg

    cam.get_and_order_meshes = drifted
    with pytest.raises(RuntimeError):
        derive_draw_groups(cams, 2)
