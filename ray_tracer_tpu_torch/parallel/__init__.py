"""Multi-device scaling: rank meshes, sharded rendering, multi-process
scaffolding on ``torch.distributed``."""

from .mesh import AXIS, Mesh, make_mesh, shard_map_fn
from .shard import render_frame_distributed
from . import distributed

__all__ = ["AXIS", "make_mesh", "shard_map_fn", "render_frame_distributed",
           "distributed"]
