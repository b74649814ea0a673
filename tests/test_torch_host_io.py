"""The port's host I/O around a frame: the profiler's trace on the CPU, and
on the card the PNG encoder on a 1080p frame and a new process seeded from
the pipeline cache.

This file imports no JAX (the card's machine has none); the card tests
skip where no CUDA device exists.  On the card, run them without the
repository's root conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_host_io.py
"""

import collections
import glob
import json
import os

import numpy as np
import pytest
import torch

import tyleri_tpu_torch as tt
from tyleri_tpu_torch import _build, native
from tyleri_tpu_torch.testing import seeded_frame
from tyleri_tpu_torch.utils import image
from tyleri_tpu_torch.utils.profiling import annotate, trace, tracing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def trace_events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def ranges(events, name):
    return [e for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def cpu_frame(times, resolution=(32, 32)):
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config1_triangle(dev, resolution)
    win = tt.RenderWindow(dev, resolution=resolution,
                          present_mode="immediate")
    for t in times:
        with annotate("frame"):
            rig.fill(win.get_render_scene(), t)
            win.render()
    return win.flush()


def test_trace_holds_the_annotated_frame(tmp_path):
    """``trace`` writes a Chrome trace into its directory that holds the
    ``annotate`` range and the frame's ops inside it."""
    with trace(str(tmp_path)):
        img = cpu_frame([0.0])
    assert img[16, 16, 0] == 255
    events = trace_events(tmp_path)
    (frame,) = ranges(events, "frame")
    inside = [e for e in events if e.get("cat") == "cpu_op"
              and frame["ts"] <= e["ts"] <= frame["ts"] + frame["dur"]]
    assert any(e["name"] == "aten::sort" for e in inside), \
        sorted({e["name"] for e in inside})[:20]


def test_profile_frame_stages_are_annotated_ranges(tmp_path):
    """Inside ``trace``, every span the recorder keeps (the layers
    testing/profile_frame.py reports) is a ``ty::`` range in the trace, as
    many times as it was recorded; the ranges are record-function scopes,
    not user annotations, and leave the annotation around them whole."""
    with tracing() as records, trace(str(tmp_path)):
        cpu_frame([0.0, 0.1])
    events = trace_events(tmp_path)
    assert len(ranges(events, "frame")) == 2
    recorded = collections.Counter(s.name for s in records.spans)
    assert {"frame", "record", "plan", "bin", "bin.spill", "shade",
            "present.enqueue", "present", "flush"} <= set(recorded)
    for name, n in recorded.items():
        assert len([e for e in events if e.get("cat") == "cpu_op"
                    and e.get("name") == "ty::" + name]) == n, name
        assert not ranges(events, "ty::" + name)
    assert all(s.profile == 0 for s in records.spans)


@pytest.mark.cuda
def test_native_png_reads_back_as_the_python_path_on_a_1080p_frame(
        cuda_device, tmp_path, monkeypatch):
    """A 1080p config-2 frame written by the native encoder and by the
    python zlib path: both read back as the frame.  Their bytes are equal
    only where python's zlib is the system's libz version: printed, not
    held."""
    assert native.available(), native.build_error()
    dev = tt.RenderDeviceBuilder().build()
    rig = tt.scenes.config2_cube(dev, (1920, 1080))
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    rig.fill(win.get_render_scene(), 0.9)
    win.render()
    img = win.flush()
    assert img.shape == (1080, 1920, 4) and (img[..., :3] > 0).any()
    native_path = str(tmp_path / "native.png")
    image.write_png(native_path, img)
    with open(native_path, "rb") as f:
        native_png = f.read()
    assert native_png == native.png_encode(img)
    monkeypatch.setattr(native, "available", lambda: False)
    python_path = str(tmp_path / "python.png")
    image.write_png(python_path, img)
    with open(python_path, "rb") as f:
        python_png = f.read()
    for path in (native_path, python_path):
        np.testing.assert_array_equal(image.read_png(path), img)
    print(f"1080p PNG: native {len(native_png)} B, python "
          f"{len(python_png)} B, bytes equal {native_png == python_png}")


@pytest.mark.cuda
def test_seeded_process_loads_the_built_kernels(cuda_device):
    """A new process seeded from this one's pipeline cache loads the kernel
    library and the host runtime from its seeded directory, builds
    nothing, and renders config 1 as this process does."""
    _build.load()
    assert native.available(), native.build_error()
    dev = tt.RenderDeviceBuilder().build()
    want = seeded_frame.render_one(dev, 1)
    got = seeded_frame.run(dev.pipeline_cache.get_data(), config=1)
    assert (got["compiles"], got["host_compiles"]) == (0, 0), got
    for key in ("library", "host_library"):
        assert got[key].startswith(got["directory"] + os.sep), got
    assert got["launches"]["fused_setup"] == 1 and \
        got["launches"]["peel2"] == 1, got
    assert got["image_sha256"] == seeded_frame.image_digest(want)
