"""The plain reference of the training step: the whole-frame image loss,
its gradient by autograd through the plain path tracer, and Adam.

It starts from the same arrays as the port (the true scene and the start
with its albedos scaled), renders the target itself, and takes its own
Adam steps (torch.optim.Adam's update, written out). The leaves carry the
port's field names.
"""

from __future__ import annotations

import math

import torch

from . import pathtrace as ref

# the port's trainable field names → this reference's scene keys
LEAVES = {"sphere_albedo": "sph_alb", "sphere_center": "sph_c",
          "sphere_radius": "sph_r", "tri_albedo": "tri_alb",
          "tri_v0": "v0", "tri_v1": "v1", "tri_v2": "v2"}
ALBEDOS = ("sphere_albedo", "tri_albedo")


def frame(S, basis, render, W, H, frame_index):
    """One whole frame → (H, W, 3), row 0 the bottom, traced as the port
    traces it (lanes in the blocked pixel order)."""
    order = ref.blocked_order(W, H)
    lanes = ref.render_lanes(S, basis, render, W, H, order,
                             [frame_index])[0]
    inverse = torch.as_tensor(order.argsort(kind="stable"),
                              device=lanes.device)
    return lanes[inverse].reshape(H, W, 3)


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), one rate
    per leaf."""

    def __init__(self, leaves: dict, lrs: dict, betas=(0.9, 0.999),
                 eps=1e-8):
        self.leaves, self.lrs = leaves, lrs
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in self.leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lrs[k] / bc1)


def mse(img, target):
    return torch.mean((img - target) ** 2)


def train(arrays, config, traffic, device, dtype=torch.float32, steps=3,
          frame0=0, loss_fn=mse, frames=None):
    """The reference's first ``steps`` steps → (losses, the first
    gradient by leaf, each leaf's start and its value after the steps).
    The target is frame ``frame0``; step k renders frame ``frames[k]``
    (default ``frame0 + k``). ``loss_fn`` and ``frames`` are there for the
    control's planted faults."""
    W, H = int(traffic["width"]), int(traffic["height"])
    render = dict(config["render"])
    cam = config["camera"]
    basis = ref.camera_basis(cam["origin"], cam["look_at"], cam["fov"],
                             W / H)
    S = ref.build_scene(arrays, device, dtype)
    with torch.no_grad():
        target = frame(S, basis, render, W, H, frame0)
    scale = float(traffic["albedo_start"])
    leaves = {}
    for name, key in LEAVES.items():
        x = S[key].detach().clone()
        leaves[name] = (x * scale if name in ALBEDOS else x).requires_grad_()
    start = {k: v.detach().clone() for k, v in leaves.items()}
    lrs = {k: float(traffic["lr_albedo"] if k in ALBEDOS
                    else traffic["lr_geometry"]) for k in leaves}
    opt = Adam(leaves, lrs)
    losses, first = [], None
    for step in range(steps):
        scene = ref.with_leaves(S, {LEAVES[k]: v for k, v in leaves.items()})
        img = frame(scene, basis, render, W, H,
                    frame0 + step if frames is None else frames[step])
        loss = loss_fn(img, target)
        g = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, g))
        if first is None:
            first = {k: v.detach().clone() for k, v in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(grads)
    end = {k: v.detach().clone() for k, v in leaves.items()}
    return losses, first, start, end


def leaf_gaps(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between two norms: | |got| - |want| | over the
    larger of |want| and the median leaf's |want|, over the leaves in
    ``keep`` (all where None)."""
    keys = [k for k in want if keep is None or k in keep]
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in want}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(torch.linalg.vector_norm(got[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in keys)


def moving_leaves(first: dict, floor: float = 1e-3) -> set:
    """Leaves whose first gradient in the reference is at least ``floor``
    of the median leaf's norm: the others move under Adam by round-off
    alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in first.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k for k, n in norms.items() if n >= floor * med}
