"""Data-parallel rendering: pixel shards over the ranks of a mesh.

Port of ``ray_tracer_tpu.parallel.shard``. The frame's flat pixel ids are
split evenly over the mesh's ranks; each rank renders its contiguous shard
with ``render_pixels`` on its own device, with the scene and camera basis
replicated (the caller builds them on each rank's device), and one
all-gather hands every rank the whole frame. ``render_pixels`` takes pixel
ids as an argument, so the per-rank body is the single-device code.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..camera import CameraBasis
from ..ops.closest_hit import plane_scope
from ..renderer import (_blocked_ids, _unblock, render_pixels,
                        resolved_backend)
from ..scene import Scene
from ..utils.config import RenderParams
from .mesh import Mesh, make_mesh, shard_map_fn


def _padded_ids(params: RenderParams, n_dev: int, scene: Scene):
    """Flat pixel ids on the scene's device, padded to a multiple of n_dev
    (surplus lanes repeat the last id; they are dropped after the gather).

    The same blocked 16x8 order as ``renderer.render_frame`` whenever the
    kernels run or coherent scatter is on, so each rank's contiguous shard
    is whole compact pixel blocks (tight ray groups for the kernels'
    culling). Returns (ids, blocked, inverse-or-None)."""
    W, H = params.width, params.height
    n = W * H
    blocked = (resolved_backend(params, scene) == "cuda"
               or params.coherent_scatter)
    if blocked:
        base, inverse = _blocked_ids(W, H, scene.device)
    else:
        base = torch.arange(n, dtype=torch.int64, device=scene.device)
        inverse = None
    pad = -(-n // n_dev) * n_dev - n
    if pad:
        base = torch.cat([base, base[-1:].expand(pad)])
    return base, blocked, inverse


def _render_sharded(scene: Scene, basis: CameraBasis, params: RenderParams,
                    frame_index: int, mesh: Mesh):
    W, H = params.width, params.height
    basis = basis.to(scene.device)
    ids, blocked, inverse = _padded_ids(params, mesh.size, scene)

    def body(ids_r):
        return render_pixels(scene, basis, params, frame_index, ids_r)

    img = shard_map_fn(body, mesh)(ids)[:W * H]
    if blocked:
        img = _unblock(img, inverse, W, H)   # back to raster order
    return img.reshape(H, W, 3)


@plane_scope()
def render_frame_distributed(scene: Scene, basis: CameraBasis,
                             params: RenderParams, frame_index,
                             mesh: Optional[Mesh] = None):
    """One frame rendered across the mesh's ranks → (H, W, 3) on every
    rank, on the scene's device. Every rank of the mesh calls it with its
    own replica of the scene. Not differentiable through the gather: the
    sharded loss is ``grad.image_mse(..., mesh=mesh)``."""
    mesh = mesh if mesh is not None else make_mesh()
    return _render_sharded(scene, basis, params, int(frame_index), mesh)
