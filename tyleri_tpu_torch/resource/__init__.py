"""tyleri_tpu_torch.resource — L1 resources & memory.

The upload API lives on ``RenderDevice`` (create_vertices / create_indices /
create_textures, as in ``tyleri_tpu``); the building blocks are exported
here under the reference's names.
"""

from tyleri_tpu_torch.resource.allocator import (
    INDICES_INIT_SIZE,
    MemoryAllocator,
    UploadQueue,
    VERTICES_INIT_SIZE,
)
from tyleri_tpu_torch.resource.arenas import (
    AllocationError,
    BindlessBuffer,
    BindlessBufferAllocator,
    BlockBasedAllocator,
    VariableLengthBuffer,
)
from tyleri_tpu_torch.resource.textures import StaticTexture, TextureArena

# aliases of the reference's public resource handles
# (ref: src/resource/mod.rs:26-28)
StaticVertices = BindlessBuffer
StaticIndices = BindlessBuffer

__all__ = [
    "AllocationError",
    "BindlessBuffer",
    "BindlessBufferAllocator",
    "BlockBasedAllocator",
    "INDICES_INIT_SIZE",
    "MemoryAllocator",
    "StaticIndices",
    "StaticTexture",
    "StaticVertices",
    "TextureArena",
    "UploadQueue",
    "VERTICES_INIT_SIZE",
    "VariableLengthBuffer",
]
