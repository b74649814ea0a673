"""Binning's entry-emit kernel (csrc/binning_emit.cu) against its plain
version (ops/binning.py's eager emit on CPU tensors), on the card.

The kernel's pre-sort key2 and triangle-id arrays and its two placed
counts must equal the plain version's, position by position, on CPU copies
of the same first-sort key and permuted opA: on seeded setup tables under
roomy caps (pad rows past the emitted list) and tight ones (valid_cap, a
spill-level override and an entry_cap below the emitted rows), at K = 8,
16 and 32; on a table past 2^21 triangles; on a table with every row dead;
and on random keys and opA words through the launch alone.  Then
``bin_triangles`` on CUDA against CPU: per-tile entry multisets equal, and
tile_start, overflow, num_entries, the demands and the broad list exactly
equal.  Also: the emit makes no synchronizing call, and counts one
``bin.emit`` a launch.

This file imports no JAX (the card's machine has none) and skips where no
CUDA device exists.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_binning_emit_cuda.py
"""

import numpy as np
import pytest
import torch

from tyleri_tpu_torch.ops import binning as B
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.utils.profiling import tracing

pytestmark = pytest.mark.cuda

FB_W, FB_H, TILE = 192, 128, 8
GRID_W, GRID_H = FB_W // TILE, FB_H // TILE


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def setup_table(seed=5, T=1500, valid_share=0.9):
    """The port's setup table (on the CPU) of small, tile-spanning and
    screen-sized triangles: dense, spill and broad entries, and invalid
    rows."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1.2, 1.2, (T, 1, 2))
    size = rng.choice([0.02, 0.1, 0.4, 2.5], size=(T, 1, 1),
                      p=[0.6, 0.3, 0.09, 0.01])
    clip = np.ones((T, 3, 4), np.float32)
    clip[..., :2] = center + size * rng.uniform(-1, 1, (T, 3, 2))
    clip[..., 2] = rng.uniform(0.05, 0.95, (T, 1))
    return S.setup_triangles(
        torch.from_numpy(clip),
        torch.from_numpy(rng.random((T, 3, 2)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 3, T).astype(np.int32)),
        torch.from_numpy(rng.random(T) < valid_share),
        [0, 0, FB_W, FB_H, 0, 1], [0, 0, FB_W, FB_H], tile_w=TILE,
        tile_h=TILE, grid_w=GRID_W, grid_h=GRID_H)


def big_table(T, gw=120, gh=68):
    """T live rows, each covering one to four tiles of a gw x gh grid."""
    t = torch.arange(T)
    lo = torch.stack([t % (gw - 1), (t // gw) % (gh - 1)], dim=1)
    hi = lo + torch.stack([t % 2, (t // 3) % 2], dim=1)
    ch = torch.zeros((T, S.NUM_CHANNELS))
    ch[:, S.CH_ORDER] = S.encode_order(t)
    ch[:, S.CH_ZMIN] = (t % 65536).to(torch.float32)
    return S.TriangleSetup(torch.ones(T, dtype=torch.bool), ch,
                           lo.to(torch.int32), hi.to(torch.int32))


def caps(name, K):
    """test_torch_binning's CAPS at K: the spill-level override one cap a
    level of K's, and the tight entry cap below the emitted rows at K = 8
    too."""
    levels = len(B._level_caps(1 << 12, K))
    return {
        "roomy": dict(entry_cap=1 << 15, broad_cap=128, spill_cap=1 << 14),
        "tight": dict(entry_cap=min(1 << 12, 256 * K), broad_cap=4,
                      spill_cap=1 << 12, valid_cap=512,
                      spill_level_caps=(512,) * levels),
    }[name]


def to(su, device):
    return S.TriangleSetup(*(t.to(device) if t is not None else None
                             for t in su))


def emits(monkeypatch, su, device, **kw):
    """``bin_triangles`` on ``su`` moved to ``device``, and each call of
    the emit inside it: (key, opA, keywords, outputs), cloned."""
    calls = []
    real = B.emit_entries

    def spy(key, opA, **k):
        out = real(key, opA, **k)
        calls.append((key.clone(), opA.clone(), k,
                      tuple(t.clone() for t in out)))
        return out

    monkeypatch.setattr(B, "emit_entries", spy)
    binned = B.bin_triangles(to(su, device), **kw)
    monkeypatch.setattr(B, "emit_entries", real)
    return binned, calls


def assert_emit_equal(call):
    """The kernel's outputs equal the plain version's on CPU copies of its
    inputs, position by position; returns the list's length."""
    key, opA, kw, got = call
    want = B.emit_entries(key.cpu(), opA.cpu(), **kw)
    names = ("key2", "tri", "placed_dense", "placed_spill")
    for name, g, w in zip(names, got, want, strict=True):
        g = g.cpu()
        assert g.dtype == w.dtype == torch.int64, name
        assert g.shape == w.shape, (name, g.shape, w.shape)
        bad = int((g != w).sum())
        assert bad == 0, f"{name}: {bad} positions differ"
    return got[0].shape[0]


def assert_binned_equal(got, want):
    """CUDA against CPU binning: the integer bookkeeping exactly, the
    per-tile entry multisets (by draw order), the broad list."""
    got = type(got)(*(t.cpu() if t is not None else None for t in got))
    for name in ("overflow", "num_entries", "dense_demand", "level_demand",
                 "num_broad", "tile_start", "broad_tiles"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    ts = want.tile_start.numpy()
    g = S.decode_order(got.entry_channels[:, S.CH_ORDER]).numpy()
    w = S.decode_order(want.entry_channels[:, S.CH_ORDER]).numpy()
    for tile in np.flatnonzero(np.diff(ts)):
        seg = slice(ts[tile], ts[tile + 1])
        np.testing.assert_array_equal(np.sort(g[seg]), np.sort(w[seg]),
                                      f"tile {tile}")
    assert torch.equal(got.entry_tile[:ts[-1]], want.entry_tile[:ts[-1]])
    nb = int(want.num_broad)
    assert torch.equal(got.broad_channels[:nb].view(torch.int32),
                       want.broad_channels[:nb].view(torch.int32))


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("name", ["roomy", "tight"])
def test_emit_equals_its_twin(cuda_device, monkeypatch, name, K):
    su = setup_table()
    kw = dict(grid_w=GRID_W, grid_h=GRID_H, max_tiles_per_tri=K,
              **caps(name, K))
    got, calls = emits(monkeypatch, su, cuda_device, **kw)
    (call,) = calls
    n = assert_emit_equal(call)
    segs = B.emit_segments(call[2]["vcap"], call[2]["caps"],
                           kw["entry_cap"], K)
    rows = sum(s[1] for s in segs if s[2] >= 0)
    # pad rows past the emitted list (roomy at K = 8 and 16), or the entry
    # cap truncating the sorted list (tight, roomy at K = 32)
    pad = name == "roomy" and K < 32
    assert (rows < kw["entry_cap"]) == pad == (segs[-1][2] == -1)
    assert n == max(rows, kw["entry_cap"])
    if name == "roomy":
        assert int(got.overflow) == 0
    else:
        assert int(got.overflow) > 0 and call[2]["vcap"] == 512
    assert_binned_equal(got, B.bin_triangles(su, **kw))


def test_emit_past_2_21_triangles(cuda_device, monkeypatch):
    T = (1 << 21) + 3
    su = big_table(T)
    kw = dict(grid_w=120, grid_h=68, entry_cap=3 * T, max_tiles_per_tri=32,
              broad_cap=16, spill_cap=2 * T)
    got, (call,) = emits(monkeypatch, su, cuda_device, **kw)
    assert_emit_equal(call)
    assert int(got.overflow) == 0 and int(got.num_entries) > T
    assert_binned_equal(got, B.bin_triangles(su, **kw))


def test_emit_with_every_row_dead(cuda_device, monkeypatch):
    su = setup_table(seed=7, valid_share=0.0)
    kw = dict(grid_w=GRID_W, grid_h=GRID_H, max_tiles_per_tri=32,
              **caps("roomy", 32))
    got, (call,) = emits(monkeypatch, su, cuda_device, **kw)
    assert_emit_equal(call)
    key2 = call[3][0]
    assert bool((key2 >> 16 == GRID_W * GRID_H).all())
    assert int(got.num_entries) == 0 and int(got.tile_start[-1]) == 0
    assert_binned_equal(got, B.bin_triangles(su, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_launch_equals_its_twin_on_random_words(cuda_device, seed):
    """Random keys (dead ones among them, every spill count and width) and
    random opA words of all 64 bits, so zmin's clamp works at both ends."""
    g = torch.Generator().manual_seed(seed)
    n, T = 50_000, 40_000
    scount = torch.randint(0, 32, (n,), generator=g)
    tw = torch.randint(1, 33, (n,), generator=g)
    tri = torch.randint(0, 1 << 32, (n,), generator=g)
    key = B.pack_key(scount, tw, tri)
    key[torch.rand(n, generator=g) < 0.2] = B.DEAD_KEY
    key = torch.sort(key).values
    opA = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g) * 2 + 1
    kw = dict(T=T, grid_w=24, ntiles=24 * 16, K=32, vcap=n - 7,
              caps=[4608, 1536, 1024, 512, 512], entry_cap=n + 31 * 3000)
    got = B.emit_entries(key.to(cuda_device), opA.to(cuda_device), **kw)
    assert_emit_equal((key, opA, kw, got))


def test_emit_makes_no_synchronizing_call(cuda_device, monkeypatch):
    """Under the sync debug mode's "error", around the emit alone; one
    ``bin.emit`` count and one launch a call, inside the ``bin.spill``
    span."""
    su = setup_table()
    kw = dict(grid_w=GRID_W, grid_h=GRID_H, **caps("roomy", 32))
    _, (call,) = emits(monkeypatch, su, cuda_device, **kw)
    key, opA, k, _ = call
    torch.cuda.synchronize()
    before = B.launches
    with tracing() as records:
        torch.cuda.set_sync_debug_mode("error")
        try:
            B.emit_entries(key, opA, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert B.launches == before + 1
    assert records.counters == {None: {"bin.emit": 1}}
    assert [s.name for s in records.spans] == ["bin.spill"]
