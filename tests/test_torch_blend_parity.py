"""The port's blend-parity policy, as the JAX package's
(tests/test_blend_parity.py, tyleri_tpu/rendering/forward.py:537-580): the
reference blends every mesh fragment in submission order
(common_pipeline.rs:117-131); "auto" engages the two-layer blend (peel2) up
to BLEND_PARITY_PEEL2_MAX_TRIS triangles wherever K3 supports the depth
state, and otherwise ships the single layer and reports the deviation once;
"peel2" and "fast" pin it; exact mode blends every fragment in order and
takes neither.  Depth states K3 does not take resolve on the last-passing
path, where "auto" leaves peel2 off and reports the deviation.
"""

import dataclasses

import numpy as np
import pytest

import tyleri_tpu_torch as tt
from tyleri_tpu_torch.pipeline.state import CompareOp
from tyleri_tpu_torch.rendering import forward

RES = (64, 64)


def _device():
    msgs = []
    dev = tt.RenderDeviceBuilder().device("cpu").validation_level(
        tt.ValidationLevel.WARNING).debug_callback(
            lambda m: msgs.append(m.message_id)).build()
    return dev, msgs


def _scene(dev):
    rig = tt.scenes.config4_instances(dev, RES, n_instances=6)
    scene = tt.RenderScene()
    rig.fill(scene, 0.5)
    return scene


def _plan_for(rf, dev, scene):
    rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    return rf.plan.raster


def test_auto_engages_peel2_below_threshold_and_renders():
    dev, msgs = _device()
    win = tt.RenderWindow(dev, resolution=RES, present_mode="immediate")
    rig = tt.scenes.config4_instances(dev, RES, n_instances=6)
    rig.fill(win.get_render_scene(), 0.5)
    win.render()
    img = win.flush()
    assert win.rendering_function.plan.raster.peel2
    assert "blend-order-deviation" not in msgs, "silent when engaged"
    assert img[..., :3].max() > 0


def test_auto_keeps_single_layer_above_threshold_and_warns_once(monkeypatch):
    monkeypatch.setattr(forward, "BLEND_PARITY_PEEL2_MAX_TRIS", 8)
    dev, msgs = _device()
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
    scene = _scene(dev)   # hundreds of triangles > 8
    assert not _plan_for(rf, dev, scene).peel2
    assert msgs.count("blend-order-deviation") == 1
    assert not _plan_for(rf, dev, scene).peel2
    assert msgs.count("blend-order-deviation") == 1, "once, not per frame"


def test_auto_needs_a_depth_state_k3_supports():
    dev, msgs = _device()
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
    rf.mesh_state = dataclasses.replace(rf.mesh_state, depth=dataclasses.replace(
        rf.mesh_state.depth, compare_op=CompareOp.GREATER))
    assert not _plan_for(rf, dev, _scene(dev)).peel2
    assert msgs.count("blend-order-deviation") == 1


def test_no_blend_no_peel2_no_message():
    dev, msgs = _device()
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
    rf.mesh_state = dataclasses.replace(
        rf.mesh_state, blend=dataclasses.replace(rf.mesh_state.blend,
                                                 enable=False))
    assert not _plan_for(rf, dev, _scene(dev)).peel2
    assert msgs == []


def test_pinned_modes(monkeypatch):
    monkeypatch.setattr(forward, "BLEND_PARITY_PEEL2_MAX_TRIS", 8)
    dev, msgs = _device()
    scene = _scene(dev)
    # "peel2" is on from construction and stays on above the threshold
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES),
                                     blend_parity="peel2")
    assert rf.plan.raster.peel2
    assert _plan_for(rf, dev, scene).peel2
    assert msgs == []
    # "fast" never engages, even below the threshold
    monkeypatch.setattr(forward, "BLEND_PARITY_PEEL2_MAX_TRIS", 1 << 18)
    rf_fast = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES),
                                          blend_parity="fast")
    assert not _plan_for(rf_fast, dev, scene).peel2
    assert msgs == ["blend-order-deviation"]
    # "exact" is exact mode, with no peel2 and no message; an unknown
    # policy is an error
    rf_exact = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES),
                                           blend_parity="exact")
    assert rf_exact.plan.raster.exact
    assert not _plan_for(rf_exact, dev, scene).peel2
    assert msgs == ["blend-order-deviation"]
    with pytest.raises(ValueError):
        tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES),
                                    blend_parity="bogus")


def test_pinned_peel2_and_fast_differ_only_where_layers_overlap():
    """Without blending the two layers collapse to one: peel2 and fast
    render the same frame (tests/test_raster_pallas.py:448-456)."""
    def render(policy, blend):
        dev, _ = _device()
        win = tt.RenderWindow(dev, resolution=RES, present_mode="immediate",
                              blend_parity=policy)
        rf = win.rendering_function
        rf.mesh_state = dataclasses.replace(
            rf.mesh_state, blend=dataclasses.replace(rf.mesh_state.blend,
                                                     enable=blend))
        rig = tt.scenes.config2_cube(dev, RES)
        rig.fill(win.get_render_scene(), 0.9)
        win.render()
        return win.flush()

    np.testing.assert_array_equal(render("peel2", False),
                                  render("fast", False))
    assert (render("peel2", True) != render("fast", True)).any()
