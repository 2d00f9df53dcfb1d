"""Progressive rendering over a mesh: one image, its pixels split over the
ranks in whole share tiles, one all-gather a call.

Each rank renders its own contiguous run of the frame's lanes, in the
order ``renderer.render_frame`` traces them (``renderer.frame_lanes``),
for every frame of
the call, and accumulates it with ``accumulate``'s float32 weights. After
the call's last frame one all-gather, padded to the longest run, hands
every rank the whole image. The scene and camera are replicated: every
rank calls with its own copy on its own device.

The runs keep every lane's draws what they are in one process:

  * where the one-process frame shares coherent-scatter draws (its
    ``trace`` calls hold whole share tiles), each rank gets whole tiles,
    the first ``n_tiles % N`` ranks one more, so no tile is split and
    every tile draws from its first lane as it does in one process; a
    last partial tile is padded with its last pixel, as ``render_frame``
    pads its last chunk;
  * where it shares none, no run shares either, whatever its length: the
    runs are whole 16x8 pixel blocks of the blocked order (128 lanes),
    the first ranks one more, so that a run's lanes also fall on the same
    vector lanes of a CPU's elementwise loops as in one process.

So the image equals ``renderer.render_progressive``'s bit for bit. With
no process group, or a mesh of one rank, the call is
``render_progressive`` itself. The pixel split of
``render_frame_distributed`` (``shard._padded_ids``, the JAX package's
even split) is left as it is.

Span ``parallel.render`` times a call on the host. Stream spans:
``parallel.shard``, the rank's frames of its run; ``parallel.gather``, the
all-gather, unpadding and unblocking after them; ``parallel.all_gather``,
the collective alone. Counters:
``render_progressive_distributed.gathers`` (all-gathers issued) and
``render_progressive_distributed.shard_tiles`` (this rank's share tiles in
the last call; 0 where the frame shares no draws).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..camera import CameraBasis
from ..ops.closest_hit import plane_scope
from ..renderer import (_unblock, accumulate, frame_lanes, render_pixels,
                        render_progressive)
from ..scene import Scene
from ..utils.config import RenderParams
from ..utils.metrics import span
from .mesh import Mesh, make_mesh

# lanes of the unit a run holds whole where no draws are shared: one
# 16x8 block of renderer._blocked_order
BLOCK_LANES = 128
# torch's all-gather into one tensor: ``all_gather_single`` where torch has
# it, ``all_gather_into_tensor`` (its name before, deprecated since) where
# it does not, as torch 2.11 does not
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def shard_bounds(n: int, ranks: int, unit: int) -> List[Tuple[int, int]]:
    """(start, stop) of each rank's contiguous run of ``n`` lanes: whole
    units of ``unit`` lanes, the first ``units % ranks`` ranks one more
    (the last unit may be partial)."""
    base, extra = divmod(-(-n // unit), ranks)
    bounds, start = [], 0
    for r in range(ranks):
        stop = start + (base + (r < extra)) * unit
        bounds.append((min(start, n), min(stop, n)))
        start = stop
    return bounds


def _rank_ids(ids, start: int, stop: int, tile: int):
    """This rank's lanes, a partial last tile padded with its last
    pixel."""
    mine = ids[start:stop]
    pad = -(stop - start) % tile if tile else 0
    if pad:
        mine = torch.cat([mine, mine[-1:].expand(pad)])
    return mine


def _render_run(scene, basis, params, ids, frames, start_frame, prev):
    """``frames`` frames of the lanes ``ids`` from ``start_frame``,
    accumulated onto ``prev`` → (lanes, 3). ``params`` shares draws only
    where the one-process frame does."""
    chunk = params.chunk_pixels
    if not ids.shape[0]:
        return prev
    for k in range(frames):
        f = start_frame + k
        if chunk and chunk < ids.shape[0]:
            img = torch.cat([render_pixels(scene, basis, params, f, c)
                             for c in ids.split(chunk)])
        else:
            img = render_pixels(scene, basis, params, f, ids)
        prev = accumulate(prev, img, f)
    return prev


def _gather_order(mesh: Mesh) -> List[int]:
    """For each mesh position, the index of its rank in the group's own
    order, which the all-gather fills its output in."""
    members = dist.get_process_group_ranks(
        mesh.group if mesh.group is not None else dist.group.WORLD)
    where = {int(r): i for i, r in enumerate(mesh.ranks.ravel())}
    index = {where[int(m)]: i for i, m in enumerate(members)}
    return [index[p] for p in range(mesh.size)]


@plane_scope()
@span("parallel.render")
def render_progressive_distributed(scene: Scene, basis: CameraBasis,
                                   params: RenderParams, frames: int,
                                   start_frame: int = 0, image0=None,
                                   mesh: Optional[Mesh] = None):
    """``frames`` progressive frames from ``start_frame`` over the mesh's
    ranks → the accumulated (H, W, 3) image on every rank, on the scene's
    device, equal to ``render_progressive``'s. ``image0`` (the whole
    image, on every rank) continues an earlier accumulation. Every rank of
    the mesh calls it with the same arguments and its own replica of the
    scene. ``mesh`` defaults to every rank of the process group; with no
    group, or one rank, this is ``render_progressive``."""
    if mesh is None and dist.is_initialized():
        mesh = make_mesh()
    if mesh is None or mesh.size == 1 or frames < 1:
        return render_progressive(scene, basis, params, frames,
                                  start_frame=start_frame, image0=image0)
    W, H = params.width, params.height
    n = W * H
    basis = basis.to(scene.device)
    ids, inverse, tile = frame_lanes(scene, params)
    bounds = shard_bounds(n, mesh.size, tile or BLOCK_LANES)
    start, stop = bounds[mesh.rank]
    mine = _rank_ids(ids, start, stop, tile)
    render_progressive_distributed.shard_tiles = (
        mine.shape[0] // tile if tile else 0)
    if image0 is None:
        prev = torch.zeros((mine.shape[0], 3), dtype=torch.float32,
                           device=scene.device)
    else:
        prev = image0.reshape(n, 3)[mine]
    run_params = params if tile else params.replace(coherent_scatter=False)
    with span("parallel.shard"):
        acc = _render_run(scene, basis, run_params, mine, int(frames),
                          int(start_frame), prev)
    with span("parallel.gather"):
        longest = max(b - a + (-(b - a) % tile if tile else 0)
                      for a, b in bounds)
        if acc.shape[0] < longest:
            acc = torch.cat([acc, acc.new_zeros(
                (longest - acc.shape[0], 3))])
        out = acc.new_empty((mesh.size * longest, 3))
        with span("parallel.all_gather"):
            _ALL_GATHER(out, acc, group=mesh.group)
        render_progressive_distributed.gathers += 1
        parts = out.view(mesh.size, longest, 3)
        img = torch.cat([parts[g, :b - a] for g, (a, b) in
                         zip(_gather_order(mesh), bounds)])
        if inverse is not None:
            img = _unblock(img, inverse, W, H)   # back to raster order
        return img.reshape(H, W, 3)


render_progressive_distributed.gathers = 0
render_progressive_distributed.shard_tiles = 0
