"""Inverse rendering: the image loss, its gradient and the training step.

Port of ``ray_tracer_tpu.grad.inverse`` with its names and call shapes.
The renderer is differentiable in PyTorch: the closest-hit search detaches
only the discrete winner, so ``torch.autograd`` flows from the pixel loss
to sphere centres and radii, triangle vertices, albedos, emission and
smoothness. On the "cuda" backend the winner rows come out of the
closest-hit kernel and their backward is the scatter-add kernel
(``ops/intersect._WinnerRows``).

Differences from the reference, all in how state is held:

  * a trainable dict maps field names to leaf tensors that require grad;
    ``init_fn`` makes them, and the optimizer updates them in place;
  * ``opt_state`` is the ``torch.optim`` optimizer itself;
  * nothing is compiled: ``step_fn`` runs eagerly.

Distributed (``mesh``, a ``parallel.Mesh``): each rank renders its own
pixels of the frame, and the gradients of the replicated scene are summed
over the mesh's ranks with an all-reduce, where the reference's
``shard_map`` transpose inserts a psum. Every rank holds the same scene
and takes the same optimizer step.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..camera import CameraBasis
from ..ops.closest_hit import plane_scope
from ..parallel.shard import _padded_ids
from ..renderer import _blocked_order, render_frame, render_pixels
from ..scene import Scene
from ..utils.config import RenderParams
from ..utils.metrics import span

# Continuous scene leaves that make sense to optimize.
DEFAULT_TRAINABLE = ("sphere_albedo", "sphere_center", "sphere_radius",
                     "tri_albedo", "tri_v0", "tri_v1", "tri_v2")


def split_scene(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE
                ) -> Tuple[Dict[str, torch.Tensor], Scene]:
    """Partition the scene into (trainable dict, frozen scene)."""
    trainable = {f: getattr(scene, f) for f in fields}
    return trainable, scene


def merge_scene(scene: Scene, trainable: Dict[str, torch.Tensor]) -> Scene:
    return dataclasses.replace(scene, **trainable)


class _Replicated(torch.autograd.Function):
    """Identity on the replicated trainable leaves whose backward sums
    their gradients over the mesh in one all-reduce: the transpose of a
    replicated input (the reference's psum). One node for all leaves, so
    every rank makes the same single collective per backward."""

    @staticmethod
    def forward(ctx, mesh, *leaves):
        ctx.mesh = mesh
        return tuple(v.view_as(v) for v in leaves)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        ctx.mesh.all_reduce(flat)
        parts = flat.split([g.numel() for g in grads])
        return (None,) + tuple(p.view_as(g) for p, g in zip(parts, grads))


class _SumOverMesh(torch.autograd.Function):
    """The mesh's sum of each rank's loss; its gradient passes through to
    each rank's own term."""

    @staticmethod
    def forward(ctx, loss, mesh):
        total = loss.clone()
        mesh.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, g):
        return g, None


def image_mse(trainable, scene: Scene, basis: CameraBasis,
              params: RenderParams, frame_index, target, mesh=None):
    """Mean-squared pixel loss of a 1-frame render against ``target``.

    With ``mesh`` each rank renders its shard of the pixels (as
    ``parallel.render_frame_distributed`` splits them) and takes their
    squared error over the whole frame's denominator; the loss is the sum
    over the mesh, and the gradient of any trainable leaf is the mesh's
    sum of each rank's, on every rank."""
    if mesh is None:
        img = render_frame(merge_scene(scene, trainable), basis, params,
                           int(frame_index))
        return torch.mean((img - target) ** 2)
    names = list(trainable)
    shared = dict(zip(names, _Replicated.apply(
        mesh, *(trainable[k] for k in names))))
    n = params.width * params.height
    ids, _, _ = _padded_ids(params, mesh.size, scene)
    per = ids.shape[0] // mesh.size
    lo = mesh.rank * per
    mine = ids[lo:lo + per]
    rad = render_pixels(merge_scene(scene, shared), basis.to(scene.device),
                        params, int(frame_index), mine)
    real = (torch.arange(lo, lo + per, device=mine.device) < n)[:, None]
    err = torch.where(real, (rad - target.reshape(n, 3)[mine]) ** 2, 0.0)
    return _SumOverMesh.apply(torch.sum(err) / float(n * 3), mesh)


def _chunked_inputs(params, target, chunks: int):
    """Blocked-order pixel ids / targets / weights split into ``chunks``
    equal slabs, tail-padded with zero-weighted duplicates of the last
    pixel id when ``chunks`` does not divide W*H. Chunks walk the same
    blocked 16x8 pixel order as render_frame, so each chunk's rays stay
    compact for the kernel's culling."""
    W, H = params.width, params.height
    R = W * H
    order_np, _ = _blocked_order(W, H)
    n = -(-R // chunks)
    pad = chunks * n - R
    order_pad = np.concatenate(
        [order_np, np.full(pad, order_np[-1], order_np.dtype)])
    w_pad = np.concatenate(
        [np.ones(R, np.float32), np.zeros(pad, np.float32)])
    dev = target.device
    order = torch.from_numpy(order_pad.astype(np.int64)).to(dev)
    ids = order.reshape(chunks, n)
    wts = torch.from_numpy(w_pad).to(dev).reshape(chunks, n, 1)
    tgt = target.reshape(R, 3)[order].reshape(chunks, n, 3)
    return ids, tgt, wts, float(R * 3)


def _chunk_scan(trainable, render_pixels_fn, ids, tgt, wts, denom,
                reduce_fn=None):
    """Forward and backward per pixel chunk (``ids[c]``), the chunks'
    losses and cotangents summed: only one chunk's graph is alive at a
    time.

    ``reduce_fn(flat)`` (optional) is called on each chunk's loss and
    cotangents, flattened into one tensor, as soon as that chunk's
    backward ends, and returns a handle whose ``wait()`` completes a
    reduction of ``flat`` in place. The sharded path passes an
    asynchronous all-reduce here, so chunk k's collective runs while chunk
    k+1 renders and differentiates; the handles are waited on at the end.
    The sum is linear, so this equals reducing the total, up to f32
    summation order."""
    names = list(trainable)
    leaves = {k: trainable[k].detach().requires_grad_(True) for k in names}
    pending = []
    for c in range(ids.shape[0]):
        rad = render_pixels_fn(leaves, ids[c])
        loss_c = torch.sum(wts[c] * (rad - tgt[c]) ** 2) / denom
        g = torch.autograd.grad(loss_c, [leaves[k] for k in names],
                                allow_unused=True, materialize_grads=True)
        flat = torch.cat([loss_c.detach().reshape(1)]
                         + [gk.reshape(-1) for gk in g])
        pending.append((flat, None if reduce_fn is None else reduce_fn(flat)))
    total = torch.zeros_like(pending[0][0])
    for flat, work in pending:
        if work is not None:
            work.wait()
        total = total + flat
    parts = total[1:].split([leaves[k].numel() for k in names])
    return total[0], {k: p.view_as(leaves[k]) for k, p in zip(names, parts)}


def chunked_mse_value_and_grad(trainable, render_pixels_fn, params,
                               target, chunks: int):
    """(loss, grads) of ``mean((render - target)**2)`` accumulated over
    sequential pixel chunks (``_chunk_scan``): bounds the backward's
    memory by ~1/chunks. Equal to the whole-frame gradient up to f32
    summation order (each pixel's radiance depends only on its own pixel
    id).

    ``render_pixels_fn(trainable, pixel_ids) -> (N, 3)`` radiance.
    """
    ids, tgt, wts, denom = _chunked_inputs(params, target, chunks)
    return _chunk_scan(trainable, render_pixels_fn, ids, tgt, wts, denom)


def sharded_chunked_mse_value_and_grad(trainable, render_pixels_fn, params,
                                       target, chunks: int, mesh):
    """The chunked gradient with the chunks sharded over the mesh: the
    frame is split into ``mesh.size x chunks`` slabs in the blocked pixel
    order, each rank walks its own ``chunks`` slabs, and each chunk's loss
    and cotangents are all-reduced asynchronously as soon as its backward
    ends (``_chunk_scan``), overlapping the next chunk. Every rank returns
    the whole frame's (loss, grads)."""
    ids, tgt, wts, denom = _chunked_inputs(params, target,
                                           mesh.size * chunks)
    mine = slice(mesh.rank * chunks, (mesh.rank + 1) * chunks)
    return _chunk_scan(trainable, render_pixels_fn, ids[mine], tgt[mine],
                       wts[mine], denom,
                       reduce_fn=lambda flat: mesh.all_reduce(
                           flat, async_op=True))


def _adam(params):
    """The default optimizer: Adam(1e-2), the update form and defaults of
    ``optax.adam(1e-2)`` (betas 0.9, 0.999; eps 1e-8)."""
    return torch.optim.Adam(params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)


EDGE_SEED = 1234   # the boundary estimator's seed, as the reference's key


def edge_generator(frame_index, device) -> torch.Generator:
    """The boundary estimator's generator for a training step's frame:
    seeded with EDGE_SEED · 2^20 + frame_index on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(EDGE_SEED * 2 ** 20 + int(frame_index))
    return g


def _add_boundary_gradients(grads, full: Scene, basis, params, target,
                            frame_index, edge_samples, topology, mesh=None):
    """``grads`` plus the edge-sampled boundary gradients of the MSE at
    ``full`` (the current scene), on the keys both have. With ``mesh``
    every rank draws the same samples and the estimates are averaged over
    the mesh, so every rank adds the same gradient: the estimator's
    ``index_add_`` sums in no fixed order on a CUDA device, and ranks
    whose steps differed by its rounding would drift apart."""
    from .edges import boundary_gradients
    with torch.no_grad():
        img = render_frame(full, basis, params, int(frame_index))
    cot = 2.0 * (img - target) / img.numel()      # d(mse)/d(img)
    bg = boundary_gradients(full, basis, params, cot,
                            edge_generator(frame_index, full.device),
                            n_tri_samples=edge_samples,
                            n_sph_samples=edge_samples, topology=topology)
    if mesh is not None:
        keys = list(bg)
        flat = torch.cat([bg[k].reshape(-1) for k in keys])
        mesh.all_reduce(flat)
        flat = flat / mesh.size
        bg = dict(zip(keys, (p.view_as(bg[k]) for p, k in zip(
            flat.split([bg[k].numel() for k in keys]), keys))))
    return {k: v + bg[k] if k in bg else v for k, v in grads.items()}


def make_train_step(params: RenderParams, optimizer=None, mesh=None,
                    edge_samples: int = 0, grad_chunks: int = 0,
                    topology=None):
    """Build an optimizer step over trainable scene leaves.

    ``edge_samples > 0`` adds the edge-sampled visibility (boundary)
    gradients (``grad/edges.py``) for geometry fields: without them,
    autodiff sees only shading changes, not silhouette motion. The frame
    is rendered once more without autograd, the cotangent of the MSE is
    2 (img − target) / img.numel(), and the estimator draws from a
    ``torch.Generator`` on the scene's device seeded with
    1234 · 2^20 + frame_index, so a step's draws are a function of its
    frame. Pass ``topology`` (``grad.topology.build_topology``) for meshes
    with shared edges: it fixes the uniform sampler's interior-edge double
    count and concentrates samples on silhouette, boundary and crease
    edges. The estimate is added to the interior gradient of each key it
    has (tri_v0..v2, sphere_center, sphere_radius) that is trainable.

    ``optimizer`` is a factory from a list of parameter tensors to a
    ``torch.optim`` optimizer (default: Adam, lr 1e-2). ``grad_chunks > 1``
    accumulates the gradient over sequential pixel chunks
    (``chunked_mse_value_and_grad``), for frames whose whole-frame backward
    does not fit in device memory.

    With ``mesh`` every rank of the mesh calls ``step_fn`` with its own
    replica of the scene: the interior gradient is the mesh's
    (``image_mse(mesh=)``, or ``sharded_chunked_mse_value_and_grad`` with
    ``grad_chunks > 1``: each rank walks ``grad_chunks`` chunks of its
    shard), and the boundary gradient is computed whole on every rank from
    the same generator seed and averaged over the mesh, so every rank adds
    the same one and takes the same step.

    Returns (init_fn, step_fn):
      init_fn(scene, fields) -> (trainable, opt_state)
      step_fn(trainable, opt_state, scene, basis, target, frame_index)
          -> (trainable, opt_state, loss)
    ``trainable``'s tensors are the optimizer's parameters: ``step_fn``
    updates them in place and returns the same dict. A step is the span
    ``train.step`` (``utils/metrics.span``, numbered from 1 as its request
    id) around ``train.forward``, ``train.backward`` and ``train.optimizer``.
    """
    make_optimizer = optimizer or _adam
    step_ids = itertools.count(1)     # the spans' request id of a step

    def init_fn(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE):
        trainable, _ = split_scene(scene, fields)
        trainable = {k: v.detach().clone().requires_grad_(True)
                     for k, v in trainable.items()}
        return trainable, make_optimizer(list(trainable.values()))

    @plane_scope()
    def step_fn(trainable, opt_state, scene, basis, target, frame_index):
        owned = {id(p) for group in opt_state.param_groups
                 for p in group["params"]}
        if owned != {id(p) for p in trainable.values()}:
            raise ValueError("trainable must hold the optimizer's own "
                             "parameters (made by init_fn)")
        with span("train.step", request=next(step_ids)):
            return _step(trainable, opt_state, scene, basis, target,
                         frame_index)

    def _step(trainable, opt_state, scene, basis, target, frame_index):
        with span("train.forward"):
            if grad_chunks > 1:
                on_device = basis.to(scene.device)

                def rp(tr, ids):
                    return render_pixels(merge_scene(scene, tr), on_device,
                                         params, int(frame_index), ids)

                if mesh is None:
                    loss, grads = chunked_mse_value_and_grad(
                        trainable, rp, params, target, grad_chunks)
                else:
                    loss, grads = sharded_chunked_mse_value_and_grad(
                        trainable, rp, params, target, grad_chunks, mesh)
            else:
                loss = image_mse(trainable, scene, basis, params,
                                 frame_index, target, mesh=mesh)
        with span("train.backward"):
            if grad_chunks <= 1:
                names = list(trainable)
                g = torch.autograd.grad(loss, [trainable[k] for k in names],
                                        allow_unused=True)
                grads = {k: (torch.zeros_like(trainable[k]) if gk is None
                             else gk) for k, gk in zip(names, g)}
                loss = loss.detach()
            if edge_samples:
                grads = _add_boundary_gradients(
                    grads, merge_scene(scene, trainable), basis, params,
                    target, frame_index, edge_samples, topology, mesh)
        with span("train.optimizer"):
            for k, p in trainable.items():
                p.grad = grads[k]
            opt_state.step()
        return trainable, opt_state, loss

    return init_fn, step_fn
