"""Pipeline state objects — the fixed-function state of the two reference
pipelines, expressed as hashable dataclasses that parameterize the kernels.

The reference bakes this state into two Vulkan graphics pipelines
(ref: src/pipeline/common_pipeline.rs:31-139, src/pipeline/ui_pipeline.rs:29-135).
There is no fixed-function hardware here: the state below is consumed by the
raster/blend kernels in ``tyleri_tpu_torch.ops``.  A lookup keyed by one of
these enums raises on a member it does not hold (``lookup``), so a member of
another package's enum of the same name never falls through to a default.

The port's own copy of ``tyleri_tpu/pipeline/state.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import dataclasses
import enum


def lookup(table: dict, key):
    """``table[key]``, raising ValueError for a key the table does not hold.
    Enum members hash by name but compare by identity, so a member of the
    JAX package's enum of the same name is such a key."""
    try:
        return table[key]
    except (KeyError, TypeError):
        raise ValueError(f"{key!r} is not one of {list(table)}") from None


class BlendFactor(enum.Enum):
    ZERO = "zero"
    ONE = "one"
    SRC_COLOR = "src_color"
    ONE_MINUS_SRC_COLOR = "one_minus_src_color"
    DST_COLOR = "dst_color"
    ONE_MINUS_DST_COLOR = "one_minus_dst_color"
    SRC_ALPHA = "src_alpha"
    ONE_MINUS_SRC_ALPHA = "one_minus_src_alpha"
    DST_ALPHA = "dst_alpha"
    ONE_MINUS_DST_ALPHA = "one_minus_dst_alpha"


class BlendOp(enum.Enum):
    ADD = "add"
    SUBTRACT = "subtract"
    REVERSE_SUBTRACT = "reverse_subtract"
    MIN = "min"
    MAX = "max"


class CompareOp(enum.Enum):
    NEVER = "never"
    LESS = "less"
    EQUAL = "equal"
    LESS_OR_EQUAL = "less_or_equal"
    GREATER = "greater"
    NOT_EQUAL = "not_equal"
    GREATER_OR_EQUAL = "greater_or_equal"
    ALWAYS = "always"


class FrontFace(enum.Enum):
    COUNTER_CLOCKWISE = "ccw"
    CLOCKWISE = "cw"


class CullMode(enum.Enum):
    NONE = "none"
    FRONT = "front"
    BACK = "back"
    FRONT_AND_BACK = "front_and_back"  # VK_CULL_MODE_FRONT_AND_BACK


class DepthFormat(enum.Enum):
    """Depth attachment format. The reference defaults to D16_UNORM
    (ref: src/render_device/builders.rs:31) and hard-codes it in the render
    pass (ref: src/rendering_function/forward_rendering/mod.rs:132). We honor
    the quantization of the chosen format for pixel parity."""

    D16_UNORM = 16
    D32_SFLOAT = 32


@dataclasses.dataclass(frozen=True)
class BlendState:
    """One color-attachment blend state (VkPipelineColorBlendAttachmentState)."""

    enable: bool = True
    src_color: BlendFactor = BlendFactor.ONE
    dst_color: BlendFactor = BlendFactor.ZERO
    color_op: BlendOp = BlendOp.ADD
    src_alpha: BlendFactor = BlendFactor.ONE
    dst_alpha: BlendFactor = BlendFactor.ZERO
    alpha_op: BlendOp = BlendOp.ADD
    write_mask: tuple = (True, True, True, True)


@dataclasses.dataclass(frozen=True)
class DepthState:
    test_enable: bool = True
    write_enable: bool = True
    compare_op: CompareOp = CompareOp.LESS_OR_EQUAL
    format: DepthFormat = DepthFormat.D16_UNORM
    # depth bounds test: both pipelines set bounds [0, 1]
    # (ref: common_pipeline.rs:115, ui_pipeline.rs:113)
    min_bound: float = 0.0
    max_bound: float = 1.0


@dataclasses.dataclass(frozen=True)
class RasterState:
    front_face: FrontFace = FrontFace.COUNTER_CLOCKWISE
    # The reference never sets a cull mode, so Vulkan's default (NONE)
    # applies (ref: common_pipeline.rs:96-102 sets only front_face,
    # line_width, polygon_mode).
    cull_mode: CullMode = CullMode.NONE


@dataclasses.dataclass(frozen=True)
class PipelineState:
    blend: BlendState = BlendState()
    depth: DepthState = DepthState()
    raster: RasterState = RasterState()


# The 3D mesh pipeline's odd "screen-ish" blend:
#   rgb  = src.rgb * src.rgb + dst.rgb * (1 - dst.rgb)
#   a    = 0
# (ref: src/pipeline/common_pipeline.rs:117-131)
#
# blend_enable caveat: the reference configures blend FACTORS but never
# calls an explicit blend-enable toggle on the (unvendored) yarvk
# PipelineColorBlendAttachmentState builder.  If yarvk mirrors Vulkan's
# zero-default (VK_FALSE), the upstream renderer actually runs with
# blending DISABLED and the factors are inert.  Unverifiable from this
# repo (yarvk is a path dependency, not mounted); we assume the factors
# were intentional and enable blending.  Apps can opt out with
# dataclasses.replace(..., blend=BlendState(enable=False)) — the
# visibility path then also avoids the order-dependent-blend deviation
# warned about by the debug messenger.
MESH_PIPELINE_STATE = PipelineState(
    blend=BlendState(
        enable=True,
        src_color=BlendFactor.SRC_COLOR,
        dst_color=BlendFactor.ONE_MINUS_DST_COLOR,
        color_op=BlendOp.ADD,
        src_alpha=BlendFactor.ZERO,
        dst_alpha=BlendFactor.ZERO,
        alpha_op=BlendOp.ADD,
    ),
    depth=DepthState(
        test_enable=True,
        write_enable=True,
        compare_op=CompareOp.LESS_OR_EQUAL,
        format=DepthFormat.D16_UNORM,
    ),
    raster=RasterState(),
)

# The UI pipeline's blend: rgb = src + dst*(1 - src.a) (premultiplied
# color), alpha = 0.  The reference sets ONLY the color factors — the alpha
# factor lines are commented out (ref: src/pipeline/ui_pipeline.rs:115-129),
# so Vulkan's zero defaults apply: src/dst alpha factor ZERO => written
# alpha is 0.  We replicate that effective state exactly; the conventional
# premultiplied-alpha config is available as
# UI_PIPELINE_STATE_PREMULTIPLIED_ALPHA for apps that read back alpha.
UI_PIPELINE_STATE = PipelineState(
    blend=BlendState(
        enable=True,
        src_color=BlendFactor.ONE,
        dst_color=BlendFactor.ONE_MINUS_SRC_ALPHA,
        color_op=BlendOp.ADD,
        src_alpha=BlendFactor.ZERO,
        dst_alpha=BlendFactor.ZERO,
        alpha_op=BlendOp.ADD,
    ),
    depth=DepthState(
        test_enable=True,
        write_enable=True,
        compare_op=CompareOp.LESS_OR_EQUAL,
        format=DepthFormat.D16_UNORM,
    ),
    raster=RasterState(),
)

UI_PIPELINE_STATE_PREMULTIPLIED_ALPHA = dataclasses.replace(
    UI_PIPELINE_STATE,
    blend=dataclasses.replace(
        UI_PIPELINE_STATE.blend,
        src_alpha=BlendFactor.ONE,
        dst_alpha=BlendFactor.ONE_MINUS_SRC_ALPHA,
    ),
)
