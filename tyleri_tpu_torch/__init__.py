"""tyleri_tpu_torch — the PyTorch / CUDA port of ``tyleri_tpu``.

The same software rasterizer, with the frame path in eager PyTorch and the
three Pallas kernels of ``tyleri_tpu`` rewritten by hand for NVIDIA Hopper
(``csrc/*.cu``, built with nvcc for ``sm_90a`` on first use and bound with
ctypes, see ``_build.py``):

  ops/setup_cuda.py   K1+K2 fused transform + near-cull + triangle setup
  ops/raster_cuda.py  K3 per-tile visibility resolve

Every kernel has a plain PyTorch version in the same module.  A wrapper
routes a CPU tensor to the plain version and a CUDA tensor to the kernel.

The layout mirrors ``tyleri_tpu`` (api/, device/, models/, native/,
pipeline/, resource/, scene/, ops/, rendering/, testing/, utils/, window/),
so each module's counterpart lives under the same path.  The package imports
nothing of ``tyleri_tpu`` and never imports JAX: the numpy-only modules it
needs (pipeline state, scenes, models, the oracle, math, allocators,
swapchain, the native host runtime) are its own copies, held against their
originals by ``tests/test_torch_vendored.py``.  Every public name of
``tyleri_tpu``'s root is exported here, from the port's module under the
same path, and with them what a program needs to drive a frame
(``scenes``, ``ImageViewSwapchain``, ``RasterPlan``, ``make_render_mesh``);
the names resolve lazily, so importing the package touches no CUDA.

``tools/`` holds the port of the JAX package's TPU probe tools
(``python3 -m tyleri_tpu_torch.tools.<name>``), each a hand-written CUDA
kernel of ``csrc/probes.cu`` beside its plain version.

Covered: the frame through ``RenderWindow`` with its UI overlay (drawn
first, at z = 0, by the exact rasterizer ``ops/raster_exact.py``), the mesh
pass unlit (the fused setup kernel) and lit (Blinn-Phong, the clip-space
setup path), with the two-layer blend (peel2) that the "auto" blend policy
engages up to 2^18 triangles; exact mode (``blend_parity="exact"``), every
depth state (K3 resolves test+write with LESS or LESS_OR_EQUAL, the
reference's last-passing resolve the others), anisotropic sampling, and
multi-device rendering: ``RenderWindow(device_mesh=make_render_mesh(n))``
renders each rank's band and share of the draws and composites them with
``torch.distributed`` collectives (``parallel/``).
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "Vertex": "tyleri_tpu_torch.api.vertex",
    "UIVertex": "tyleri_tpu_torch.api.vertex",
    "LitVertex": "tyleri_tpu_torch.api.vertex",
    "DirectionalLight": "tyleri_tpu_torch.scene.light",
    "RenderDeviceBuilder": "tyleri_tpu_torch.device.builders",
    "DeviceSelectionError": "tyleri_tpu_torch.device.builders",
    "ValidationLevel": "tyleri_tpu_torch.device.builders",
    "RenderDevice": "tyleri_tpu_torch.device.render_device",
    "BlendFactor": "tyleri_tpu_torch.pipeline.state",
    "BlendOp": "tyleri_tpu_torch.pipeline.state",
    "BlendState": "tyleri_tpu_torch.pipeline.state",
    "CompareOp": "tyleri_tpu_torch.pipeline.state",
    "CullMode": "tyleri_tpu_torch.pipeline.state",
    "DepthFormat": "tyleri_tpu_torch.pipeline.state",
    "DepthState": "tyleri_tpu_torch.pipeline.state",
    "FrontFace": "tyleri_tpu_torch.pipeline.state",
    "MESH_PIPELINE_STATE": "tyleri_tpu_torch.pipeline.state",
    "PipelineState": "tyleri_tpu_torch.pipeline.state",
    "RasterState": "tyleri_tpu_torch.pipeline.state",
    "UI_PIPELINE_STATE": "tyleri_tpu_torch.pipeline.state",
    "ForwardRenderingFunction": "tyleri_tpu_torch.rendering.forward",
    "RasterPlan": "tyleri_tpu_torch.rendering.passes",
    "RenderingFunction": "tyleri_tpu_torch.rendering.function",
    "Camera": "tyleri_tpu_torch.scene.camera",
    "MeshRenderer": "tyleri_tpu_torch.scene.mesh_renderer",
    "RenderScene": "tyleri_tpu_torch.scene.render_scene",
    "Rect2D": "tyleri_tpu_torch.utils.math3d",
    "Viewport": "tyleri_tpu_torch.utils.math3d",
    "RenderWindow": "tyleri_tpu_torch.window.render_window",
    "WindowHandle": "tyleri_tpu_torch.window.render_window",
    "ImageViewSwapchain": "tyleri_tpu_torch.window.swapchain",
    "CommonPipeline": "tyleri_tpu_torch.pipeline.common_pipeline",
    "UIPipeline": "tyleri_tpu_torch.pipeline.ui_pipeline",
    "UIElement": "tyleri_tpu_torch.scene.ui",
    "ParallelGroup": "tyleri_tpu_torch.scene.parallel_group",
    "FrameProfiler": "tyleri_tpu_torch.utils.profiling",
    "make_render_mesh": "tyleri_tpu_torch.parallel.mesh",
}
_MODULES = {
    "scenes": "tyleri_tpu_torch.models.scenes",
}

__all__ = sorted(_EXPORTS) + sorted(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(_MODULES[name])
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'tyleri_tpu_torch' has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_MODULES))
