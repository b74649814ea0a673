"""The launch path every kernel binding shares (``tyleri_tpu_torch._build``):
``check_args``, the argument check, and ``launcher``, the launch that
counts itself, passes the current stream and checks the error code.

On the CPU, with a stub library in place of ``_build.load()`` and a stub
``torch.cuda.current_stream``: nothing here needs a card or nvcc.
"""

import collections
import types

import pytest
import torch

from tyleri_tpu_torch import _build

STREAM = 0x5EED


def good_args():
    return [("rows", torch.zeros((4, 3)), torch.float32, (4, 3)),
            ("ids", torch.zeros((5,), dtype=torch.int32), torch.int32, (5,))]


# a wrong argument: (its index in good_args, how it goes wrong)
BAD = {
    "dtype": (1, lambda t: t.to(torch.int64)),
    "shape": (0, lambda t: t[:3]),
    "strided": (0, lambda t: t.t().contiguous().t()),
    "device": (1, lambda t: t.to("meta")),
}


def test_check_args_passes_what_the_kernel_takes():
    _build.check_args("k_test", torch.device("cpu"), good_args())


def test_check_args_leaves_a_shape_of_none_to_the_wrapper():
    """A shape of None takes any shape, and still checks the dtype."""
    cpu = torch.device("cpu")
    for t in (torch.zeros((2, 3, 4)), torch.zeros(()), torch.zeros((0,))):
        _build.check_args("k_test", cpu, [("x", t, torch.float32, None)])
    with pytest.raises(ValueError) as e:
        _build.check_args("k_test", cpu, [
            ("x", torch.zeros((2, 3), dtype=torch.int32), torch.float32,
             None)])
    assert str(e.value) == ("k_test: x must be a contiguous torch.float32 on "
                            "cpu, got torch.int32 (2, 3) on cpu")


@pytest.mark.parametrize("case", sorted(BAD))
def test_check_args_names_the_kernel_and_the_argument(case):
    i, spoil = BAD[case]
    args = good_args()
    name, t, dtype, shape = args[i]
    args[i] = (name, spoil(t), dtype, shape)
    with pytest.raises(ValueError) as e:
        _build.check_args("k_test", torch.device("cpu"), args)
    msg = str(e.value)
    assert msg.startswith(f"k_test: {name} must be a contiguous {dtype} "
                          f"{shape} on cpu, got "), msg


@pytest.fixture
def stub(monkeypatch):
    """A library whose ``ty_stub`` records its arguments and returns
    ``stub.err``; a fresh launch counter; the stream handle ``STREAM``."""
    lib = types.SimpleNamespace(calls=[], err=0, streams=[])

    def ty_stub(*args):
        lib.calls.append(args)
        return lib.err

    def current_stream(device=None):
        lib.streams.append(device)
        return types.SimpleNamespace(cuda_stream=STREAM)

    lib.ty_stub = ty_stub
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return lib


def test_launch_counts_each_call_under_its_name(stub):
    launch = _build.launcher("k_test", "ty_stub", torch.device("cuda", 0),
                             (1,))
    assert not _build.launches and not stub.calls   # made, not launched
    launch()
    launch()
    _build.launcher("k_other", "ty_stub", torch.device("cuda", 0), (2,))()
    assert _build.launches == {"k_test": 2, "k_other": 1}
    assert len(stub.calls) == 3
    _build.reset_launches()
    assert not _build.launches


def test_launch_passes_the_current_stream_last(stub):
    dev = torch.device("cuda", 1)
    _build.launcher("k_test", "ty_stub", dev, (7, 2.5, None))()
    assert stub.calls == [(7, 2.5, None, STREAM)]
    assert stub.streams == [dev]


def test_launch_keeps_its_tensors(stub):
    out = torch.zeros(3)
    launch = _build.launcher("k_test", "ty_stub", torch.device("cuda", 0),
                             (out.data_ptr(),), dict(out=out))
    del out
    assert launch.tensors["out"].shape == (3,)
    launch()
    assert stub.calls == [(launch.tensors["out"].data_ptr(), STREAM)]


def test_launch_raises_on_an_error_code(stub):
    launch = _build.launcher("k_test", "ty_stub", torch.device("cuda", 0),
                             ())
    launch()
    stub.err = 700
    with pytest.raises(RuntimeError, match="^k_test: CUDA error 700 at "
                                           "launch$"):
        launch()
    assert _build.launches == {"k_test": 2}   # each call counts, as it ran
