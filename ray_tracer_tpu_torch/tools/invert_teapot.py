"""Rigid recovery (BASELINE config 5 in its first form) on the port.

Port of ``tools/invert_teapot.py``. Recovers a rigid vertex offset and a
uniform albedo of a triangle mesh from target renders:

  * albedo: autograd through the frame (the closest-hit kernel's winner
    rows, the scatter-add kernel as their backward), with the cotangent
    restricted to pixels that both the current render and the target
    cover (primary-ray hit AOVs): while the offset is off by a pixel or
    two, the silhouette band compares object against sky, and its
    residuals would pull the albedo toward the sky;
  * offset (3 DoF): central finite differences of the loss, six extra
    renders a step. The interior gradient is blind to visibility, and the
    edge estimator is variance-bound at this size; under common random
    numbers the loss itself is deterministic and sees visibility, so the
    differences are exact as h → 0. ``fd_h`` anneals from 1.5% of the
    extent down one decade;
  * common random numbers: each step re-renders the target at the step's
    own frame index, so the loss has an exact zero at the truth;
  * two timescales: the offset descends alone for the first 35% of the
    steps, then the albedo unfreezes, then both rates decay
    (``RigidRecoveryOptimizer``).

Every step renders on the scene's device and runs in one plane scope. The
reference's retries of a remote-device relay are not ported (ROADMAP.md
D4); its host copy of the step state is: the offset, the albedo and the
optimizer's moments live on the host between steps.

Usage: python -m ray_tracer_tpu_torch.tools.invert_teapot
    [steps] [size] [outfile] [model]
(defaults 200, 192, artifacts/invert_teapot_torch.json and the upstream's
teapot, assets/the_utah_teapot.glb). ``RTT_INVERT_START_ALB`` and
``RTT_INVERT_START_DIR`` set the start, as in the reference; the card is
used unless ``RTT_PLATFORM=cpu``. Prints one JSON line with the recovery
errors and writes it to ``outfile``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .. import Camera, SceneBuilder, camera_basis
from ..io import load_model
from ..ops.closest_hit import plane_scope
from ..renderer import render_aov, render_frame
from ..utils.bounds import maximum
from ..utils.config import RenderParams
from .invert_vertices import RecoveryOptimizer, _cosine

TRUE_ALBEDO = np.array([0.7, 0.45, 0.25], np.float32)
TRUE_OFFSET = np.zeros(3, np.float32)
MODEL = os.path.join("assets", "the_utah_teapot.glb")


def _env_vector(name, default):
    return np.array([float(x) for x in os.environ.get(name, default)
                     .split(",")], np.float32)


START_ALBEDO = _env_vector("RTT_INVERT_START_ALB", "0.35,0.6,0.55")
START_DIR = _env_vector("RTT_INVERT_START_DIR", "1.0,-0.6,0.4")


class RigidRecoveryOptimizer(RecoveryOptimizer):
    """The reference's ``optax.multi_transform`` over the offset ("o") and
    the albedo ("a"), written out: each group clipped by its own global
    norm of 10, then Adam (b1 0.9, b2 0.999, eps 1e-8) scaled by its
    schedule. The offset's rate is a cosine decay from 0.015·ext over
    ``steps`` to alpha 0.005; the albedo's is optax's ``join_schedules``
    of 0 until int(0.35·steps), 0.03 until int(0.8·steps), then a cosine
    decay from 0.03 over the rest to alpha 0.01, each piece evaluated at
    the count minus its boundary. Adam's moments update while a rate is
    0. ``update`` returns the updates to add."""

    def __init__(self, off, alb, steps: int, ext: float = 1.0):
        super().__init__(off, alb, steps, ext)
        self.max_norms = (10.0, 10.0)
        self.a_phase, self.a_decay = int(0.35 * steps), int(0.8 * steps)

    def rates(self, count):
        lr_o = _cosine(0.015 * self.ext, self.steps, 0.005, count)
        if count < self.a_phase:
            lr_a = np.float32(0.0)
        elif count < self.a_decay:
            lr_a = np.float32(0.03)
        else:
            lr_a = _cosine(0.03, self.steps - self.a_decay, 0.01,
                           count - self.a_decay)
        return lr_o, lr_a


def apply_rigid(scene, offset, albedo):
    """``scene`` moved by ``offset`` (3,) and painted ``albedo`` (3,):
    new vertex tensors (offset · tri_valid added to each), the normals as
    they are, tri_albedo = albedo · tri_valid."""
    valid = scene.tri_valid[:, None]
    move = offset * valid
    return dataclasses.replace(
        scene, tri_v0=scene.tri_v0 + move, tri_v1=scene.tri_v1 + move,
        tri_v2=scene.tri_v2 + move,
        tri_albedo=albedo.expand(scene.tri_albedo.shape) * valid)


@plane_scope()
def step_gradients(scene, offset, albedo, frame: int, fd_h: float,
                   hit_target, params: RenderParams, basis):
    """One step's estimator on ``scene``'s device (``scene`` is the truth)
    → (loss, g_off (3,), g_alb (3,)), 0-d and (3,) tensors there.

    The target is re-rendered at ``frame`` without autograd (common random
    numbers). ``g_alb`` is the albedo's gradient through one forward of
    ``apply_rigid(offset, albedo)`` with the cotangent 2·res·w /
    (3·max(Σw, 1)), w the overlap of the render's hit AOV with
    ``hit_target``; ``g_off`` the central differences of the loss at
    offset ± fd_h·e_i, six renders without autograd. ``fd_h`` is rounded
    to f32 first, as the reference's is."""
    dev = scene.device
    offset = torch.as_tensor(offset, dtype=torch.float32, device=dev)
    albedo = torch.as_tensor(albedo, dtype=torch.float32, device=dev)
    fd_h = float(np.float32(fd_h))
    with torch.no_grad():
        target = render_frame(scene, basis, params, frame)
    alb_ = albedo.clone().requires_grad_(True)
    moved = apply_rigid(scene, offset, alb_)
    img = render_frame(moved, basis, params, frame)
    res = (img - target).detach()
    loss = torch.mean(res ** 2)
    with torch.no_grad():
        # the forward's scene through detached aliases: the same planes
        w = render_aov(moved.detach(), basis, params, "hit") * hit_target
    g_alb, = torch.autograd.grad(
        img, alb_, 2.0 * res * w / (3.0 * maximum(torch.sum(w), 1.0)))
    del img
    with torch.no_grad():
        def loss_at(off):
            return torch.mean((render_frame(apply_rigid(scene, off, albedo),
                                            basis, params, frame)
                               - target) ** 2)

        eye = torch.eye(3, dtype=torch.float32, device=dev)
        g_off = torch.stack([
            (loss_at(offset + fd_h * eye[i]) - loss_at(offset - fd_h * eye[i]))
            / (2.0 * fd_h) for i in range(3)])
    return loss.detach(), g_off, g_alb


def run_recovery(scene, ext, params, steps, start_offset, start_albedo,
                 basis, log=True):
    """The recovery loop, on ``scene``'s device. ``scene`` is the true
    scene (true albedo baked in, textures stripped); recovers a rigid
    offset and a uniform albedo from ``start_offset`` and
    ``start_albedo``. Returns (offset (3,) np, albedo (3,) np, losses
    list)."""
    dev = scene.device
    basis = basis.to(dev)
    with torch.no_grad():   # the target's coverage, constant over the run
        hit_target = render_aov(scene, basis, params, "hit")
    # the step state, kept on the host between steps
    offset = torch.as_tensor(np.asarray(start_offset, np.float32)).clone()
    albedo = torch.as_tensor(np.asarray(start_albedo, np.float32)).clone()
    opt = RigidRecoveryOptimizer(offset, albedo, steps, ext)
    losses = []
    for i in range(steps):
        h = 0.015 * ext * (0.1 ** (i / max(1, steps - 1)))
        loss, g_off, g_alb = step_gradients(scene, offset, albedo, i, h,
                                            hit_target, params, basis)
        do, da = opt.update(g_off.cpu(), g_alb.cpu())
        offset = offset + do
        # a projection of the optimizer's state onto the physical range
        albedo = torch.clamp(albedo + da, 0.0, 1.0)
        losses.append(float(loss))
        if log and i % max(1, steps // 10) == 0:
            err = float(torch.linalg.vector_norm(offset)) / ext
            print(f"step {i:4d} loss {losses[-1]:.6f} off_err {err:.4f} "
                  f"alb {albedo.numpy().round(3)}", file=sys.stderr)
    return offset.numpy(), albedo.numpy(), losses


def recovery_setup(path: str, device="cuda"):
    """The reference main's setup for a model file → (scene, basis, ext):
    loaded at the origin with TRUE_ALBEDO and smoothness 0, textures
    stripped and the albedo broadcast to every triangle (the recovery's
    model is a uniform albedo, so the truth must be one), the camera at
    centre + ext·(0.7, 0.4, 0.7) looking at the centre, aspect 1."""
    b = SceneBuilder()
    load_model(path, b, placement="origin", albedo=tuple(TRUE_ALBEDO),
               smoothness=0.0)
    lo, hi = b.bounds()
    scene = b.build(device=device)
    scene = dataclasses.replace(
        scene, tri_tex=torch.full_like(scene.tri_tex, -1),
        tri_albedo=(torch.as_tensor(TRUE_ALBEDO, device=scene.device)
                    .expand(scene.tri_albedo.shape)
                    * scene.tri_valid[:, None]))
    center, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = Camera(origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
                 look_at=tuple(center), aspect=1.0, focus_dist=1.0)
    return scene, camera_basis(cam), ext


def recovery_params(size: int) -> RenderParams:
    """The reference's render settings: size², one bounce, the sky, two
    rays a pixel (a rigid move changes interior radiance only through
    which surface point a pixel sees, so one ray a pixel leaves the
    offset's signal below the noise)."""
    return RenderParams(width=size, height=size, bounces=1, skybox=True,
                        rays_per_pixel=2)


def main(argv=None):
    from ..cli import platform_device
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if len(argv) > 0 else 200
    size = int(argv[1]) if len(argv) > 1 else 192
    out = argv[2] if len(argv) > 2 else "artifacts/invert_teapot_torch.json"
    model = argv[3] if len(argv) > 3 else MODEL

    device = platform_device()
    scene, basis, ext = recovery_setup(model, device)
    start_offset = (np.float32(0.12 * ext) * START_DIR).astype(np.float32)
    t0 = time.time()
    offset, albedo, _ = run_recovery(scene, ext, recovery_params(size),
                                     steps, start_offset, START_ALBEDO,
                                     basis)
    off_err = float(np.linalg.norm(offset - TRUE_OFFSET)) / ext
    alb_err = float(np.abs(albedo - TRUE_ALBEDO).max())
    result = {
        "steps": steps, "resolution": size,
        "seconds": round(time.time() - t0, 1),
        "tris": int(scene.num_tris),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "start_offset_rel": 0.12 * float(np.linalg.norm(START_DIR)),
        "start_dir": [float(x) for x in START_DIR],
        "start_albedo": [float(x) for x in START_ALBEDO],
        "offset_error_rel_extent": round(off_err, 4),
        "albedo_error": round(alb_err, 4),
        "recovered": off_err < 0.02 and alb_err < 0.05,
    }
    line = json.dumps(result)
    print(line)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
