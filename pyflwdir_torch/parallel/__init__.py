"""Multi-device runtime on ``torch.distributed`` (mesh, sharded tile plan)."""

from .distributed import global_mesh, init_distributed
from .tiled import (
    Mesh,
    build_sharded_plan,
    make_mesh,
    pad_to_tiles,
    tiled_accumulate,
    tiled_basins,
    tiled_fill,
    tiled_hand,
    tiled_rank,
    tiled_stream_distance,
    tiled_strahler,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "pad_to_tiles",
    "build_sharded_plan",
    "tiled_accumulate",
    "tiled_basins",
    "tiled_fill",
    "tiled_hand",
    "tiled_rank",
    "tiled_stream_distance",
    "tiled_strahler",
    "init_distributed",
    "global_mesh",
]
