"""The port's PNG present target against the JAX package's, on the CPU:
``utils/image.py`` (``to_unorm8``, ``write_png``, ``read_png``) and the
native encoder (``native.png_encode``, ``ty_png_encode`` in
``native/host_runtime.cpp``), each the port's own copy.

Python's zlib and the system's libz are the same version here, so the
native encoder and the pure-python path give the same bytes: the tests hold
all four writers (two packages, two paths) to one another.
"""

import fcntl
import importlib
import os
import struct
import zlib

import numpy as np
import pytest

from test_torch_frame import port_scene, twin_windows
from tyleri_tpu import native as jnative
from tyleri_tpu.models import scenes
from tyleri_tpu.utils import image as jimage
from tyleri_tpu_torch import native
from tyleri_tpu_torch.utils import image

SIZES = [(1, 1), (33, 47), (64, 64)]
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")


def noise(shape, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(*shape, 4), dtype=np.uint8)


def test_to_unorm8_matches_the_jax_package():
    """Seeded values in and out of [0, 1], exact .5 ties (0.5 * 255 is
    127.5: round half to even) and the ends."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.25, 1.25, (17, 23, 4)).astype(np.float32)
    x.flat[:8] = [0.5, 1.5, -0.5, 2.5, 0.0, 1.0, np.float32(1 / 255),
                  np.float32(254.5 / 255)]
    got = image.to_unorm8(x)
    np.testing.assert_array_equal(got, jimage.to_unorm8(x))
    assert got.dtype == np.uint8 and got.flat[0] == 128
    assert got.flat[1] == 255 and got.flat[2] == 0


@pytest.fixture
def jax_host_library():
    """The JAX package's host library, loaded.  That package builds it on
    first use under one temporary file name for every process, so of two
    processes that build it at once the one whose file the other moved
    away first reports it unavailable, and keeps that answer.  Here the
    load is taken under a lock that these tests share, and a load that
    failed while another process was building is made once more, afresh:
    the library is there by then."""
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, ".host_library.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not jnative.available():
                importlib.reload(jnative)
            assert jnative.available(), jnative.build_error()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return jnative


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_encode_matches_the_jax_package(size, jax_host_library):
    assert native.available(), native.build_error()
    img = noise(size)
    got = native.png_encode(img)
    assert got == jax_host_library.png_encode(img)
    np.testing.assert_array_equal(_decode(got), img)


def _decode(png: bytes) -> np.ndarray:
    """An RGBA PNG with filter 0 rows, decoded without the port's reader."""
    w, h = struct.unpack(">II", png[16:24])
    (n,) = struct.unpack(">I", png[33:37])
    raw = zlib.decompress(png[41:41 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 4 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 4)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_png_gives_the_jax_packages_bytes(tmp_path, monkeypatch, size,
                                                path):
    """``write_png`` on the native encoder and on the pure-python zlib path
    (native made unavailable in both packages) gives the JAX package's
    bytes, and the two paths give the same bytes."""
    if path == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    img = noise(size, seed=size[0])
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    image.write_png(ours, img)
    jimage.write_png(theirs, img)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want
    monkeypatch.undo()
    assert got == native.png_encode(img)


def test_write_png_quantizes_floats_and_rejects_other_shapes(tmp_path):
    x = np.random.default_rng(9).uniform(-0.1, 1.1, (5, 7, 4)).astype(
        np.float32)
    path = str(tmp_path / "f.png")
    image.write_png(path, x)
    np.testing.assert_array_equal(image.read_png(path), jimage.to_unorm8(x))
    with pytest.raises(ValueError):
        image.write_png(path, np.zeros((5, 7, 3), np.uint8))


def test_read_png_round_trips_and_reads_the_jax_packages_files(tmp_path):
    img = noise((33, 47))
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    image.write_png(ours, img)
    jimage.write_png(theirs, img)
    for path in (ours, theirs):
        np.testing.assert_array_equal(image.read_png(path), img)
        np.testing.assert_array_equal(jimage.read_png(path), img)


def filtered_png(rows: np.ndarray, filters, ctype=6) -> bytes:
    """A PNG whose row y is stored with filter ``filters[y]``, each
    filtered row computed from ``rows`` (RGBA or RGB u8)."""
    h, stride = rows.shape[0], rows.shape[1]
    bpp = {6: 4, 2: 3}[ctype]
    raw = b""
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        if filters[y] == 1:
            left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
            data = (cur - left) & 0xFF
        elif filters[y] == 2:
            data = (cur - prev) & 0xFF
        else:
            data = cur
        raw += bytes([filters[y]]) + data.astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    w = stride // bpp
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [6, 2], ids=["rgba", "rgb"])
def test_read_png_undoes_sub_and_up_filters_as_the_jax_package(tmp_path,
                                                               ctype):
    """Filters 0, 1 (Sub) and 2 (Up) are read; any other raises, in both
    packages."""
    channels = {6: 4, 2: 3}[ctype]
    img = noise((6, 9))[..., :channels]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(filtered_png(img.reshape(6, -1), [0, 1, 2, 1, 2, 0], ctype))
    got = image.read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jimage.read_png(path))
    with open(path, "wb") as f:
        f.write(filtered_png(img.reshape(6, -1), [0, 3, 0, 0, 0, 0], ctype))
    for reader in (image.read_png, jimage.read_png):
        with pytest.raises(NotImplementedError):
            reader(path)


def test_png_encode_bound_holds_for_1080p_noise():
    """``png_encode`` gives its encoder the frame's bytes plus 64 KiB; zlib's
    ``compressBound`` of a 1080p noise frame's filtered rows, plus the PNG's
    57 bytes of signature and chunks, stays below it."""
    img = noise((1080, 1920))
    raw = img.nbytes + 1080                    # a filter byte a row
    # zlib 1.2.13's compressBound
    bound = raw + (raw >> 12) + (raw >> 14) + (raw >> 25) + 13 + 57
    assert bound <= img.nbytes + (1 << 16)
    png = native.png_encode(img)
    assert len(png) <= bound
    np.testing.assert_array_equal(_decode(png), img)


def test_png_present_target_through_the_window_matches_jax(tmp_path):
    """Config 1 at 64x64 through both packages' RenderWindow, each frame
    presented to its package's ``write_png`` (tests/test_scene_window.py:
    47-50): the port's last file reads back as its latest image and equals
    the JAX window's pixel for pixel (config 1 is off the reference on 0
    pixels)."""
    rig, jwin, twin = twin_windows(scenes.config1_triangle, (64, 64))
    written = {"jax": [], "port": []}

    def target(pkg, write):
        def present(img):
            path = str(tmp_path / f"{pkg}{len(written[pkg])}.png")
            write(path, img)
            written[pkg].append(path)
        return present

    jwin.present_target = target("jax", jimage.write_png)
    twin.present_target = target("port", image.write_png)
    times = (0.0, 0.1, 0.2)
    for t in times:
        rig.fill(jwin.get_render_scene(), t)
        jwin.render()
        scene = twin.get_render_scene()
        for cam in port_scene(rig, t).render_resources.cameras:
            scene.add_camera(cam)
        twin.render()
    jwin.flush()
    twin.flush()
    # the port presents every frame on its flush, the JAX window the last
    assert len(written["port"]) == len(times) and written["jax"]
    np.testing.assert_array_equal(image.read_png(written["port"][-1]),
                                  twin.latest_image)
    assert twin.latest_image[32, 32, 0] == 255
    np.testing.assert_array_equal(image.read_png(written["port"][-1]),
                                  jimage.read_png(written["jax"][-1]))
