"""Vulkan blend equations and depth compares over pixels (counterpart of
``tyleri_tpu/ops/blend.py``).  The mesh pipeline's state is
SrcColor/OneMinusDstColor ADD with alpha Zero/Zero
(ref: src/pipeline/common_pipeline.rs:117-131)."""

from __future__ import annotations

import torch

from tyleri_tpu_torch.pipeline.state import (
    BlendFactor,
    BlendOp,
    BlendState,
    CompareOp,
    lookup,
)

_COMPARE = {
    CompareOp.NEVER: None, CompareOp.ALWAYS: None,
    CompareOp.LESS: torch.lt, CompareOp.EQUAL: torch.eq,
    CompareOp.LESS_OR_EQUAL: torch.le, CompareOp.GREATER: torch.gt,
    CompareOp.NOT_EQUAL: torch.ne, CompareOp.GREATER_OR_EQUAL: torch.ge,
}


def apply_compare(op: CompareOp, new, old):
    """Depth-compare ``new`` against ``old``: a boolean pass mask."""
    fn = lookup(_COMPARE, op)
    if fn is None:
        shape = torch.broadcast_shapes(new.shape, old.shape)
        fill = torch.ones if op == CompareOp.ALWAYS else torch.zeros
        return fill(shape, dtype=torch.bool, device=new.device)
    return fn(new, old)


def _factor(fac: BlendFactor, src, dst, channels: slice):
    """Per-channel multiplier for ``channels`` (rgb or alpha); the *_COLOR
    factors use alpha for the alpha channel (Vulkan spec)."""
    s, d = src[..., channels], dst[..., channels]
    sa, da = src[..., 3:4], dst[..., 3:4]
    one = torch.ones_like(s)
    if fac == BlendFactor.ZERO:
        return torch.zeros_like(s)
    if fac == BlendFactor.ONE:
        return one
    if fac == BlendFactor.SRC_COLOR:
        return s
    if fac == BlendFactor.ONE_MINUS_SRC_COLOR:
        return 1.0 - s
    if fac == BlendFactor.DST_COLOR:
        return d
    if fac == BlendFactor.ONE_MINUS_DST_COLOR:
        return 1.0 - d
    if fac == BlendFactor.SRC_ALPHA:
        return sa * one
    if fac == BlendFactor.ONE_MINUS_SRC_ALPHA:
        return (1.0 - sa) * one
    if fac == BlendFactor.DST_ALPHA:
        return da * one
    if fac == BlendFactor.ONE_MINUS_DST_ALPHA:
        return (1.0 - da) * one
    raise ValueError(f"unknown blend factor {fac}")


def _op(op: BlendOp, a, b):
    if op == BlendOp.ADD:
        return a + b
    if op == BlendOp.SUBTRACT:
        return a - b
    if op == BlendOp.REVERSE_SUBTRACT:
        return b - a
    if op == BlendOp.MIN:
        return torch.minimum(a, b)
    if op == BlendOp.MAX:
        return torch.maximum(a, b)
    raise ValueError(f"unknown blend op {op}")


def apply_blend(state: BlendState, src, dst):
    """Blend ``src`` over ``dst`` ([..., 4] rgba), clamp to [0, 1] (UNORM
    attachment), then apply the write mask."""
    if not state.enable:
        out = src
    else:
        if state.color_op in (BlendOp.MIN, BlendOp.MAX):
            rgb = _op(state.color_op, src[..., :3], dst[..., :3])
        else:
            rgb = _op(state.color_op,
                      src[..., :3] * _factor(state.src_color, src, dst,
                                             slice(0, 3)),
                      dst[..., :3] * _factor(state.dst_color, src, dst,
                                             slice(0, 3)))
        if state.alpha_op in (BlendOp.MIN, BlendOp.MAX):
            a = _op(state.alpha_op, src[..., 3:4], dst[..., 3:4])
        else:
            a = _op(state.alpha_op,
                    src[..., 3:4] * _factor(state.src_alpha, src, dst,
                                            slice(3, 4)),
                    dst[..., 3:4] * _factor(state.dst_alpha, src, dst,
                                            slice(3, 4)))
        out = torch.cat([rgb, a], dim=-1)
    out = torch.clamp(out, 0.0, 1.0)
    if all(state.write_mask):
        return out
    # per-channel select from the host-side mask (no host->device copy,
    # which would wait for the stream)
    return torch.cat([out[..., i:i + 1] if m else dst[..., i:i + 1]
                      for i, m in enumerate(state.write_mask)], dim=-1)
