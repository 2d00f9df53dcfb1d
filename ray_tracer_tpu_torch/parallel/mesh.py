"""Rank meshes over ``torch.distributed``.

Port of ``ray_tracer_tpu.parallel.mesh``. The reference lays devices out
on a ``jax.sharding.Mesh``; here each rank is one process on one device,
and a ``Mesh`` is the ranks laid out on named axes plus the process group
that joins them. The port keeps its own small class rather than
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` binds one
device type and one rank per device (it sets each rank's CUDA device from
its rank), while the renderer's shards run on whatever device the caller
built the scene on, CPU ranks and several ranks sharing one card
included, and it needs only two collectives (an all-gather of pixel
shards, an all-reduce of gradients) over one group.

With no process group initialized, ``make_mesh()`` creates a one-rank
group, so a single process runs the same collectives at world size 1 and
takes no separate code path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS = "devices"


def _single_process_group() -> None:
    """Initialize a one-rank default group in this process (an in-memory
    store, no address): gloo for CPU tensors, and NCCL for CUDA tensors
    where there is a card."""
    backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
               else "gloo")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


@dataclasses.dataclass(eq=False)
class Mesh:
    """Global ranks laid out on named axes, and their process group.

    ``ranks`` has one axis per name; the flat pixel axis is split over all
    of them in ``ranks.ravel()`` order, so this process renders shard
    ``self.rank`` (its position in that order). ``group`` is ``None`` for
    the default (world) group."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]
    group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.ranks.shape)

    @property
    def rank(self) -> int:
        """This process's shard index; raises outside the mesh."""
        me = dist.get_rank()
        flat = [int(r) for r in self.ranks.ravel()]
        if me not in flat:
            raise ValueError(f"rank {me} is not in the mesh {flat}")
        return flat.index(me)

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's ``shard`` concatenated along dim 0 in mesh order,
        on every rank. Not differentiable."""
        shard = shard.contiguous()
        out = shard.new_empty((self.size * shard.shape[0],)
                              + tuple(shard.shape[1:]))
        chunks = out.chunk(self.size)
        members = dist.get_process_group_ranks(
            self.group if self.group is not None else dist.group.WORLD)
        where = {int(r): i for i, r in enumerate(self.ranks.ravel())}
        # the group fills its outputs in its own rank order: hand it the
        # slice of each rank's mesh position
        dist.all_gather([chunks[where[r]] for r in members], shard,
                        group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor, async_op: bool = False):
        """Sum ``t`` over the mesh in place; with ``async_op`` the work
        handle to ``wait()`` on, else None."""
        return dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group,
                               async_op=async_op)


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default). Every
    rank of the world must call it (a sub-mesh makes a new group)."""
    if not dist.is_initialized():
        _single_process_group()
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(np.arange(n), (axis,), group)


def shard_map_fn(fn, mesh: Mesh):
    """The port's counterpart of the reference's ``shard_map_fn`` as the
    renderer uses it: ``shard_map_fn(fn, mesh)(*replicated, flat)`` runs
    ``fn(*replicated, shard)`` on this rank's contiguous shard of ``flat``
    (its length a multiple of the mesh size) and all-gathers the results
    along dim 0, so every rank gets the whole output."""
    def run(*args):
        *replicated, flat = args
        per = flat.shape[0] // mesh.size
        if per * mesh.size != flat.shape[0]:
            raise ValueError(f"{flat.shape[0]} lanes do not split over "
                             f"{mesh.size} ranks")
        r = mesh.rank
        return mesh.all_gather(fn(*replicated, flat[r * per:(r + 1) * per]))
    return run
