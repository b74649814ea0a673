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
originals by ``tests/test_torch_vendored.py``.  What a program needs to
drive a frame is exported here (``scenes``, ``RenderScene``,
``ImageViewSwapchain``).

``tools/`` holds the port of the JAX package's TPU probe tools
(``python3 -m tyleri_tpu_torch.tools.<name>``), each a hand-written CUDA
kernel of ``csrc/probes.cu`` beside its plain version.

Covered so far: the UI-free mesh frame through ``RenderWindow``, unlit
(the fused setup kernel) and lit (Blinn-Phong, the clip-space setup path),
with the two-layer blend (peel2) that the "auto" blend policy engages up to
2^18 triangles.  The UI overlay, exact mode, anisotropic sampling and
multi-device rendering raise ``NotImplementedError``.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "RenderDeviceBuilder": "tyleri_tpu_torch.device.builders",
    "DeviceSelectionError": "tyleri_tpu_torch.device.builders",
    "ValidationLevel": "tyleri_tpu_torch.device.builders",
    "RenderDevice": "tyleri_tpu_torch.device.render_device",
    "ForwardRenderingFunction": "tyleri_tpu_torch.rendering.forward",
    "RenderWindow": "tyleri_tpu_torch.window.render_window",
    "WindowHandle": "tyleri_tpu_torch.window.render_window",
    "RasterPlan": "tyleri_tpu_torch.rendering.passes",
    "RenderScene": "tyleri_tpu_torch.scene.render_scene",
    "ImageViewSwapchain": "tyleri_tpu_torch.window.swapchain",
    "CompareOp": "tyleri_tpu_torch.pipeline.state",
    "DepthFormat": "tyleri_tpu_torch.pipeline.state",
    "DepthState": "tyleri_tpu_torch.pipeline.state",
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
