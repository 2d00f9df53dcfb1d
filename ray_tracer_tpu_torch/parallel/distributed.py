"""Multi-process scaffolding on ``torch.distributed``.

Port of ``ray_tracer_tpu.parallel.distributed``. One process per device;
the processes join one process group, the scene and camera are replicated
on every rank, the flat pixel axis is split over every rank (forward
rendering needs no collective but the final all-gather), and the
gradients of the replicated scene are all-reduced (``grad/inverse.py``).
A 2-D ``(host, chip)`` mesh tells the ranks of one host from those of
another, as the reference's tells ICI from DCN.

Under ``torchrun`` (which sets RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT) one call per process joins the group:

    from ray_tracer_tpu_torch.parallel import distributed
    distributed.initialize()
    mesh = distributed.make_host_chip_mesh()
    img = render_frame_distributed(scene, basis, params, 0, mesh)

Elsewhere pass the coordinator's ``host:port``, the process count and this
process's rank. A single process needs no call: ``make_mesh()`` makes a
one-rank group.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

logger = logging.getLogger("ray_tracer_tpu_torch.distributed")

HOST_AXIS = "host"
CHIP_AXIS = "chip"

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None) -> bool:
    """Join the default process group; True when it is (now) initialized,
    False in a single process with nothing to join.

    Idempotent: a second call finds ``torch.distributed.is_initialized()``.
    With no arguments it joins through the environment ``torchrun`` sets
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and returns False where
    that is absent. With arguments it joins ``tcp://coordinator_address``
    as rank ``process_id`` of ``num_processes``; a coordinator that cannot
    be reached raises (a rank that carried on alone would render the whole
    frame with no diagnostic).

    The backend follows the device the caller renders on: NCCL for a CUDA
    device (this process's card becomes the current device), gloo for the
    CPU. ``backend`` overrides it; several ranks on one card need
    ``"gloo"``, which takes CUDA tensors and stages them through the host,
    because NCCL refuses two ranks on one GPU. Nothing falls back to
    another backend after a failure."""
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    named = (coordinator_address is not None or num_processes is not None
             or process_id is not None)
    if not named and not all(k in os.environ for k in _TORCHRUN_ENV):
        logger.info("torch.distributed not initialized (single process)")
        return False
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(device.index if device.index is not None
                              else local % torch.cuda.device_count())
    if not named:
        dist.init_process_group(backend, init_method="env://")
        return True
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _host_grid(ranks: Sequence[int], hosts: Sequence[str]) -> np.ndarray:
    """(hosts, ranks per host) grid of ``ranks`` grouped by ``hosts[i]``,
    the host of ``ranks[i]``, in first-seen host order; raises when the
    hosts hold different numbers of ranks."""
    by_host: dict = {}
    for r, h in zip(ranks, hosts):
        by_host.setdefault(h, []).append(int(r))
    counts = {h: len(rs) for h, rs in by_host.items()}
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"uneven ranks per host {counts}; pass an explicit `ranks` "
            f"subset with equal ranks per host")
    return np.array(list(by_host.values()))


def make_host_chip_mesh(ranks: Optional[Sequence[int]] = None) -> Mesh:
    """(host, chip) mesh: axis 0 spans hosts, axis 1 the ranks within each
    host. With one process this is (1, 1).

    Groups ranks by each one's ``socket.gethostname()``, gathered from
    every rank (every rank of the world must call it), not by a bare
    reshape, and requires an equal rank count per host: a pixel shard
    must exist on every host."""
    from .mesh import make_mesh
    if not dist.is_initialized():
        make_mesh()
    world = dist.get_world_size()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    grid = _host_grid(ranks, [hosts[r] for r in ranks])
    group = None if len(ranks) == world else dist.new_group(sorted(ranks))
    return Mesh(grid, (HOST_AXIS, CHIP_AXIS), group)


def pixel_sharding_spec():
    """The axes the flat pixel axis is split over: host AND chip, every
    rank a data-parallel shard with the scene replicated (the reference's
    ``P((HOST_AXIS, CHIP_AXIS))``)."""
    return (HOST_AXIS, CHIP_AXIS)
