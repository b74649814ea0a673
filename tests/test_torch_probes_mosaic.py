"""P5: the port's ``tools/exp_mosaic_probe.py`` plain versions against the
TPU tool's ``transpose_kernel`` and ``compute_kernel`` in Pallas interpret
mode, with the tool's block specs, on the CPU: bit-equal.  The tool's own
checks (``tools/exp_mosaic_probe.py:42-43, 84``) hold at its N = 2^20.
Nothing under ``tools/`` is edited."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tyleri_tpu_torch.tools import exp_mosaic_probe as P5
from test_torch_probes import PL_INTERPRET, t, tool_module

N, B = 8192, 1024


def test_transpose_matches_the_tpu_kernel():
    tool = tool_module("exp_mosaic_probe")
    x = np.random.default_rng(0).standard_normal((24, N)).astype(np.float32)
    want = PL_INTERPRET.pallas_call(
        tool.transpose_kernel, grid=(N // B,),
        in_specs=[PL_INTERPRET.BlockSpec((24, B), lambda i: (0, i))],
        out_specs=PL_INTERPRET.BlockSpec((B, 24), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, 24), jnp.float32))(jnp.asarray(x))
    got = P5.transpose(t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_matches_the_tpu_kernel():
    tool = tool_module("exp_mosaic_probe")
    x = np.random.default_rng(1).standard_normal((16, N // 128, 128)).astype(
        np.float32)
    want = PL_INTERPRET.pallas_call(
        tool.compute_kernel, grid=(N // B,),
        in_specs=[PL_INTERPRET.BlockSpec((16, 8, 128), lambda i: (0, i, 0))],
        out_specs=PL_INTERPRET.BlockSpec((B, 24), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, 24), jnp.float32))(jnp.asarray(x))
    got = P5.compute(t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_tools_own_checks_at_full_size():
    x_t, x_c = P5.tool_inputs("cpu")
    assert x_t.shape == (24, 1 << 20) and x_c.shape == (16, 8192, 128)
    P5.check_tool_asserts(x_t, P5.transpose(x_t), P5.compute(x_c))
    with pytest.raises(ValueError):
        P5.transpose(x_c.to("meta"))
