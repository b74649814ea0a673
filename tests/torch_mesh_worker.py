"""The ranks of tests/test_torch_parallel.py.

Each of the 8 ranks is a process of its own, spawned by the test, that
joins a gloo process group through a file store, renders every case on the
port's CPU path (in the same order as every other rank, so the collectives
and the sub-groups line up), and writes what the test holds the cases to
into a pickle of its own.  It imports only the port, never JAX or the JAX
package.

The cases mirror tests/test_parallel.py's, at its RES = (64, 64) and with
its scenes (the port's copies of the JAX package's scene module), on the
same mesh shapes: 1x8 and 2x4 over every rank (make_render_mesh), 2x1, 4x1
and 1x1 over the first ranks.  A case returns the gathered frame and the
rank's plan (None on a rank outside its mesh); the single-device frame
each is compared with is rendered afterwards, case ``k`` by rank
``k % 8``, with no collective in flight.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

import tyleri_tpu_torch as tt
from tyleri_tpu_torch.models import primitives as prim
from tyleri_tpu_torch.models.scenes import _camera, _upload, _upload_texture
from torch.distributed.device_mesh import DeviceMesh

from tyleri_tpu_torch.parallel import sharding
from tyleri_tpu_torch.parallel.mesh import (
    AXIS_DRAWS,
    AXIS_TILES,
    make_render_mesh,
)
from tyleri_tpu_torch.rendering.forward import frame_body
from tyleri_tpu_torch.scene.mesh_renderer import MeshRenderer

RES = (64, 64)
# the reduced sponza whose bands move depths by more than a D16 step
SPONZA_RES = (128, 128)
SPONZA_GRID = 60
TIMEOUT = datetime.timedelta(seconds=60)


def cpu_device(info=False):
    b = tt.RenderDeviceBuilder().device("cpu")
    if info:
        b = b.validation_level(tt.ValidationLevel.INFO)
    return b.build()


def rig_frame(make, res=RES, t=0.6, exact=False, ui=False):
    """(device, rendering function, scene) of a rig from the port's scene
    module, its frame filled at ``t``."""
    dev = cpu_device()
    rig = make(dev, res)
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(res),
                                     exact=exact)
    scene = tt.RenderScene()
    rig.fill(scene, t)
    if ui:
        scene.add_ui(ui_quads(dev))
    return dev, rf, scene


def ui_quads(dev):
    """tests/test_parallel.py's overlay: a tall quad across every band of
    a 64-px frame, and a small one inside a middle band."""
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    quad = [((24, 2), (0, 0), (0, 1, 0, 1)), ((40, 2), (1, 0), (0, 1, 0, 1)),
            ((40, 62), (1, 1), (0, 1, 0, 1)), ((24, 62), (0, 1), (0, 1, 0, 1))]
    small = [((4, 34), (0, 0), (1, 0, 0, 1)), ((12, 34), (1, 0), (1, 0, 0, 1)),
             ((12, 38), (1, 1), (1, 0, 0, 1)), ((4, 38), (0, 1), (1, 0, 0, 1))]
    return [(quad, [0, 1, 2, 0, 2, 3], white),
            (small, [0, 1, 2, 0, 2, 3], white)]


def tie_frame(less=False):
    """Two identical triangles at one depth as two draws, red then green,
    which round-robin to different ranks."""
    dev = cpu_device()
    verts, idx = prim.triangle(z=0.5)
    v, i = _upload(dev, verts, idx)
    red = _upload_texture(dev, np.full((1, 1, 4), [1, 0, 0, 1], np.float32))
    green = _upload_texture(dev, np.full((1, 1, 4), [0, 1, 0, 1], np.float32))
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
    if less:
        rf.mesh_state = dataclasses.replace(rf.mesh_state, depth=(
            dataclasses.replace(rf.mesh_state.depth,
                                compare_op=tt.CompareOp.LESS)))
    scene = tt.RenderScene()
    cam = _camera(RES, [0, 0, 2.2], [0, 0, 0])
    cam.mesh_renderers.append(MeshRenderer(v, i, red))
    cam.mesh_renderers.append(MeshRenderer(v, i, green))
    scene.add_camera(cam)
    return dev, rf, scene


def clip_frame():
    """Six cubes around a camera inside them: faces cross the near plane,
    and the fused setup's hybrid clip re-clips each rank's crossers."""
    dev = cpu_device()
    verts, idx = prim.cube(1.5)
    v, i = _upload(dev, verts, idx)
    white = _upload_texture(dev, np.ones((1, 1, 4), np.float32))
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
    scene = tt.RenderScene()
    cam = _camera(RES, [0.2, 0.1, 0.8], [0, 0, 0])
    rng = np.random.default_rng(3)
    for _ in range(6):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = rng.uniform(-0.8, 0.8, 3).astype(np.float32)
        cam.mesh_renderers.append(MeshRenderer(v, i, white, m))
    scene.add_camera(cam)
    return dev, rf, scene


def peel2_plan(plan):
    """tests/test_parallel.py's peel2 plan: the JAX kernel's 128x8 tiles."""
    return dataclasses.replace(plan, raster=dataclasses.replace(
        plan.raster, peel2=True, tile_w=128, tile_h=8, chunk=128))


def cube(dev, res):
    return tt.scenes.config2_cube(dev, res)


def instances(n):
    return lambda dev, res: tt.scenes.config4_instances(dev, res,
                                                        n_instances=n)


def sponza(dev, res):
    return tt.scenes.config5_sponza(dev, res, grid_n=SPONZA_GRID)


def numpy_frame(frame) -> dict:
    return dict(color=frame.color.numpy(), depth=frame.depth.numpy(),
                order=frame.order.numpy())


class Rank:
    """One rank's run: its meshes (made once each, in case order) and the
    single-device frames the cases owe."""

    def __init__(self):
        self._meshes = {}
        self.references = []   # (case, thunk) in case order

    def mesh(self, nd, nt=None):
        """The (nd, nt) mesh: make_render_mesh's over the whole world, or,
        for a smaller nd * nt, a mesh over the first nd * nt ranks (every
        rank makes it: its sub-groups are made collectively); None where
        this rank is not in it."""
        nt = nt or dist.get_world_size() // nd
        if (nd, nt) not in self._meshes:
            if nd * nt == dist.get_world_size():
                mesh = make_render_mesh(nd, "cpu")
            else:
                mesh = DeviceMesh("cpu", torch.arange(nd * nt).reshape(
                    nd, nt), mesh_dim_names=(AXIS_DRAWS, AXIS_TILES))
            self._meshes[nd, nt] = mesh
        mesh = self._meshes[nd, nt]
        return mesh if mesh.get_coordinate() is not None else None

    def frame(self, case, shape, built, res=RES, tweak=None):
        """render_frame_sharded on the mesh of ``shape``, gathered (None on
        a rank outside it); the same inputs' single-device frame is owed as
        the reference."""
        dev, rf, scene = built
        inputs = rf.build_frame_inputs(dev, scene.render_resources, 1.0, res)
        if tweak:
            rf.plan = tweak(rf.plan)
        self.references.append((case, lambda: numpy_frame(frame_body(
            rf.plan, rf.mesh_state, *inputs, ui_state=rf.ui_state))))
        mesh = self.mesh(*shape)
        if mesh is None:
            return None
        band = sharding.render_frame_sharded(rf.plan, rf.mesh_state,
                                             rf.ui_state, mesh, *inputs)
        full = sharding.gather_frame(band, mesh, res[1])
        return dict(numpy_frame(full), band_rows=band.color.shape[0],
                    plan=repr(rf.plan),
                    crossings=int(band.clip_crossings),
                    overflow=int(band.bin_overflow) + int(band.clip_overflow))

    def traffic(self, nd):
        """The bytes this rank hands all_reduce in one sharded frame of the
        hybrid scene on an (nd, 1) mesh; an all_gather there fails the
        frame."""
        dev, rf, scene = rig_frame(instances(12))
        inputs = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
        mesh = self.mesh(nd, 1)
        if mesh is None:
            return None
        sent = []
        all_reduce, all_gather = dist.all_reduce, dist.all_gather

        def recording(t, *a, **k):
            sent.append(t.numel() * t.element_size())
            return all_reduce(t, *a, **k)

        def forbidden(*a, **k):
            raise AssertionError("the composite gathered bands")

        dist.all_reduce, dist.all_gather = recording, forbidden
        try:
            sharding.render_frame_sharded(rf.plan, rf.mesh_state,
                                          rf.ui_state, mesh, *inputs)
        finally:
            dist.all_reduce, dist.all_gather = all_reduce, all_gather
        return dict(bytes=sum(sent), calls=len(sent), plan=repr(rf.plan))

    def peel2_remap(self):
        """peel2 on a 2x1 mesh through record_sharded: the mesh is remapped
        to tiles-only once and said so once; two frames."""
        dev = cpu_device(info=True)
        msgs = []
        dev.debug_messenger.callback = lambda m: msgs.append(m.message_id)
        rig = instances(6)(dev, RES)
        rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
        rf.plan = peel2_plan(rf.plan)
        scene = tt.RenderScene()
        rig.fill(scene, 0.6)
        mesh = self.mesh(2, 1)
        inputs = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
        self.references.append(("peel2_remap", lambda: numpy_frame(
            frame_body(rf.plan, rf.mesh_state, *inputs,
                       ui_state=rf.ui_state))))
        if mesh is None:
            # the remap's sub-groups are made collectively: the ranks
            # outside the mesh make them too
            DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                       mesh_dim_names=(AXIS_DRAWS, AXIS_TILES))
            return None
        band = rf.record_sharded(dev, scene.render_resources, 1.0, RES, mesh)
        first = msgs.count("peel2-mesh-tiles-only")
        rf.record_sharded(dev, scene.render_resources, 1.0, RES, mesh)
        tiles_only = rf._tiles_only[1]
        full = sharding.gather_frame(band, tiles_only, RES[1])
        return dict(numpy_frame(full), first=first,
                    second=msgs.count("peel2-mesh-tiles-only"),
                    shard_local="peel2-shard-local" in msgs,
                    mesh_shape=tuple(tiles_only.shape),
                    peel2=rf.plan.raster.peel2, plan=repr(rf.plan))

    def window(self, case, shape, make, t=0.4, res=RES):
        """RenderWindow(device_mesh=...) for two frames; every rank's
        presented image; the single-device window's owed."""
        dev = cpu_device()
        rig = make(dev, res)

        def single():
            one = tt.RenderWindow(dev, resolution=res,
                                  present_mode="immediate")
            for _ in range(2):
                rig.fill(one.get_render_scene(), t)
                one.render()
            return dict(image=one.flush())

        self.references.append((case, single))
        mesh = self.mesh(*shape)
        if mesh is None:
            return None
        win = tt.RenderWindow(dev, resolution=res, present_mode="immediate",
                              device_mesh=mesh)
        for _ in range(2):
            rig.fill(win.get_render_scene(), t)
            win.render()
        image = win.flush()
        return dict(image=image, plan=repr(win.rendering_function.plan))


def cases(r: Rank) -> dict:
    """Every case, in order (a mesh is made where a case first needs it, so
    the sub-groups line up on every rank); a case is None on the ranks
    outside its mesh."""
    out = {}
    out["tile_bands"] = r.frame("tile_bands", (1, 8), rig_frame(cube))
    out["hybrid"] = r.frame("hybrid", (2, 4), rig_frame(instances(12)))
    out["peel2_tiles"] = r.frame("peel2_tiles", (1, 8),
                                 rig_frame(instances(12)), tweak=peel2_plan)
    out["ui_bands"] = r.frame("ui_bands", (1, 8), rig_frame(cube, ui=True))
    out["sponza_bands"] = r.frame(
        "sponza_bands", (1, 8), rig_frame(sponza, res=SPONZA_RES, t=0.0),
        res=SPONZA_RES)
    for nd in (1, 2):
        out[f"exact_{nd}"] = r.frame(f"exact_{nd}", (nd, 8 // nd), rig_frame(
            instances(6), exact=True))
        for h in (60, 52):
            res = (64, h)
            out[f"height{h}_{nd}"] = r.frame(
                f"height{h}_{nd}", (nd, 8 // nd), rig_frame(cube, res=res),
                res=res)
    out["hybrid_clip"] = r.frame("hybrid_clip", (2, 4), clip_frame())
    out["window"] = r.window("window", (2, 4), instances(8))
    out["draws_only"] = r.frame("draws_only", (2, 1),
                                rig_frame(instances(6)))
    out["peel2_remap"] = r.peel2_remap()
    out["tie_le"] = r.frame("tie_le", (2, 1), tie_frame())
    out["tie_less"] = r.frame("tie_less", (2, 1), tie_frame(less=True))
    out["traffic_2"] = r.traffic(2)
    out["traffic_4"] = r.traffic(4)
    out["one_by_one"] = r.frame("one_by_one", (1, 1),
                                rig_frame(instances(6)))
    out["one_by_one_window"] = r.window("one_by_one_window", (1, 1), cube)
    try:
        make_render_mesh(3, "cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank: join the group, run the cases, then the owed single-device
    frames, and write ``rank<r>.pkl`` into ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        r = Rank()
        out = cases(r)
        dist.barrier()
        refs = {case: thunk() for k, (case, thunk) in enumerate(r.references)
                if k % world == rank}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(cases=out, references=refs), f)
