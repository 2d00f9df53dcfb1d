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

Not ported yet, raising ``NotImplementedError``: the device mesh
(``ROADMAP.md`` A13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..camera import CameraBasis
from ..renderer import _blocked_order, render_frame, render_pixels
from ..scene import Scene
from ..utils.config import RenderParams

# Continuous scene leaves that make sense to optimize.
DEFAULT_TRAINABLE = ("sphere_albedo", "sphere_center", "sphere_radius",
                     "tri_albedo", "tri_v0", "tri_v1", "tri_v2")


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet (ROADMAP.md A13)")


def split_scene(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE
                ) -> Tuple[Dict[str, torch.Tensor], Scene]:
    """Partition the scene into (trainable dict, frozen scene)."""
    trainable = {f: getattr(scene, f) for f in fields}
    return trainable, scene


def merge_scene(scene: Scene, trainable: Dict[str, torch.Tensor]) -> Scene:
    return dataclasses.replace(scene, **trainable)


def image_mse(trainable, scene: Scene, basis: CameraBasis,
              params: RenderParams, frame_index, target, mesh=None):
    """Mean-squared pixel loss of a 1-frame render against ``target``."""
    _no_mesh(mesh)
    img = render_frame(merge_scene(scene, trainable), basis, params,
                       int(frame_index))
    return torch.mean((img - target) ** 2)


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


def chunked_mse_value_and_grad(trainable, render_pixels_fn, params,
                               target, chunks: int):
    """(loss, grads) of ``mean((render - target)**2)`` accumulated over
    sequential pixel chunks: forward and backward run per chunk with
    ``torch.autograd.grad`` and the cotangents are summed, so only one
    chunk's graph is alive at a time. Equal to the whole-frame gradient up
    to f32 summation order (each pixel's radiance depends only on its own
    pixel id).

    ``render_pixels_fn(trainable, pixel_ids) -> (N, 3)`` radiance.
    """
    ids, tgt, wts, denom = _chunked_inputs(params, target, chunks)
    names = list(trainable)
    leaves = {k: trainable[k].detach().requires_grad_(True) for k in names}
    loss = torch.zeros((), dtype=torch.float32, device=target.device)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for c in range(chunks):
        rad = render_pixels_fn(leaves, ids[c])
        loss_c = torch.sum(wts[c] * (rad - tgt[c]) ** 2) / denom
        g = torch.autograd.grad(loss_c, [leaves[k] for k in names],
                                allow_unused=True)
        loss = loss + loss_c.detach()
        for k, gk in zip(names, g):
            if gk is not None:
                grads[k] = grads[k] + gk
    return loss, grads


def sharded_chunked_mse_value_and_grad(trainable, render_pixels_fn, params,
                                       target, chunks: int, mesh):
    """The multi-device chunked gradient: not ported yet."""
    raise NotImplementedError(
        "sharded_chunked_mse_value_and_grad: a device mesh is not ported "
        "yet (ROADMAP.md A13)")


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
                            frame_index, edge_samples, topology):
    """``grads`` plus the edge-sampled boundary gradients of the MSE at
    ``full`` (the current scene), on the keys both have."""
    from .edges import boundary_gradients
    with torch.no_grad():
        img = render_frame(full, basis, params, int(frame_index))
    cot = 2.0 * (img - target) / img.numel()      # d(mse)/d(img)
    bg = boundary_gradients(full, basis, params, cot,
                            edge_generator(frame_index, full.device),
                            n_tri_samples=edge_samples,
                            n_sph_samples=edge_samples, topology=topology)
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

    Returns (init_fn, step_fn):
      init_fn(scene, fields) -> (trainable, opt_state)
      step_fn(trainable, opt_state, scene, basis, target, frame_index)
          -> (trainable, opt_state, loss)
    ``trainable``'s tensors are the optimizer's parameters: ``step_fn``
    updates them in place and returns the same dict.
    """
    _no_mesh(mesh)
    make_optimizer = optimizer or _adam

    def init_fn(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE):
        trainable, _ = split_scene(scene, fields)
        trainable = {k: v.detach().clone().requires_grad_(True)
                     for k, v in trainable.items()}
        return trainable, make_optimizer(list(trainable.values()))

    def step_fn(trainable, opt_state, scene, basis, target, frame_index):
        owned = {id(p) for group in opt_state.param_groups
                 for p in group["params"]}
        if owned != {id(p) for p in trainable.values()}:
            raise ValueError("trainable must hold the optimizer's own "
                             "parameters (made by init_fn)")
        if grad_chunks > 1:
            def rp(tr, ids):
                return render_pixels(merge_scene(scene, tr), basis, params,
                                     int(frame_index), ids)

            loss, grads = chunked_mse_value_and_grad(
                trainable, rp, params, target, grad_chunks)
        else:
            names = list(trainable)
            loss = image_mse(trainable, scene, basis, params, frame_index,
                             target)
            g = torch.autograd.grad(loss, [trainable[k] for k in names],
                                    allow_unused=True)
            grads = {k: (torch.zeros_like(trainable[k]) if gk is None
                         else gk) for k, gk in zip(names, g)}
            loss = loss.detach()
        if edge_samples:
            grads = _add_boundary_gradients(
                grads, merge_scene(scene, trainable), basis, params, target,
                frame_index, edge_samples, topology)
        for k, p in trainable.items():
            p.grad = grads[k]
        opt_state.step()
        return trainable, opt_state, loss

    return init_fn, step_fn
