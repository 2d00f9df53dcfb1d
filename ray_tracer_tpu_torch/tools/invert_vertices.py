"""Per-vertex geometry recovery (BASELINE config 5) on the port.

Port of ``tools/invert_vertices.py``. Recovers a per-vertex offset field
(plus a uniform albedo) of a triangle mesh from multi-view target
renders:

  * interior gradients: autograd through ``apply_vertex_offsets``
    (positions and area-weighted recomputed normals, so shading sees
    geometry) and the renderer's detached-winner recompute;
  * visibility gradients: the silhouette-classified physical-edge
    boundary estimator (``grad/edges.py`` with ``grad/topology.py``),
    pulled back onto unique vertices;
  * a Dirichlet (graph-Laplacian) prior propagates sparse silhouette
    evidence inboard, and Sobolev preconditioning ((I + λL)⁻¹ by CG)
    moves the large-scale error modes first;
  * common random numbers: the target is rendered with the optimization
    render's frame index, so the loss has an exact zero at the truth.

Views cycle per step; the albedo unfreezes after ``albedo_phase`` of the
steps. Every step renders on the scene's device: on the card, the
closest-hit kernel serves the frame, the coverage AOV and both side-ray
traces of the edge estimator, and the scatter-add kernel the backward.

Differences from the reference, none of which changes a result: with
``frame_cycle > 0`` the targets, one per (view, frame) pair, are rendered
once before the loop (the reference renders the same image every step);
the coverage AOV and the edge estimator read the frame's scene through
detached aliases, so the kernels pack each step's scene once; the
optimizer is ``RecoveryOptimizer``, optax's transforms written out.
``safe_point`` (the reference's retries of a remote-device relay) is
accepted and does nothing.

Usage: python -m ray_tracer_tpu_torch.tools.invert_vertices
    [steps] [size] [outfile] [model]
(defaults 600, 128, artifacts/invert_vertices_torch.json and the
upstream's teapot, assets/the_utah_teapot.glb). The reference's
``RTT_INVERT_*`` variables set the rest. Prints one JSON line with the
recovery errors (offset-field RMS relative to the scene extent) and
writes it to ``outfile``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import Camera, SceneBuilder, camera_basis
from ..grad.edges import boundary_gradients
from ..grad.topology import (apply_vertex_offsets, build_topology,
                             dirichlet_energy, pull_back_vertex_grads,
                             sobolev_precondition)
from ..io import load_model
from ..ops.closest_hit import plane_scope
from ..renderer import render_aov, render_frame
from ..utils.bounds import maximum
from ..utils.config import RenderParams

TRUE_ALBEDO = np.array([0.7, 0.45, 0.25], np.float32)
EDGE_SEED = 7172   # the boundary estimator's seed, as the reference's key
MODEL = os.path.join("assets", "the_utah_teapot.glb")


def smooth_field(generator, verts, ext, rms, waves: int = 4):
    """Smooth random per-vertex field with the requested RMS: a sum of
    low-frequency sinusoids of the position (wavelengths ~ the scene
    extent), drawn from ``generator`` on ``verts``' device."""
    kw = dict(generator=generator, device=verts.device)
    freqs = torch.randn(waves, 3, **kw) * (2.0 * np.pi / ext)
    phases = torch.rand(waves, **kw) * (2.0 * np.pi)
    amps = torch.randn(waves, 3, **kw)
    field = torch.sin(verts @ freqs.T + phases[None, :]) @ amps   # (V, 3)
    return field * (rms / torch.sqrt(torch.mean(torch.sum(field ** 2, -1))))


def ring_cameras(center, ext, n_views: int, elevation: float = 0.4,
                 radius: float = 0.85, alternate: bool = True):
    """n_views camera bases on an azimuth ring looking at center.
    ``alternate`` flips the elevation sign on odd views so the object's
    underside is observed too."""
    bases = []
    for i in range(n_views):
        th = 2.0 * np.pi * i / n_views
        el = elevation * (-1.0 if (alternate and i % 2) else 1.0)
        eye = center + ext * np.array(
            [radius * np.cos(th), el, radius * np.sin(th)])
        cam = Camera(origin=tuple(eye), look_at=tuple(center), aspect=1.0,
                     focus_dist=1.0)
        bases.append(camera_basis(cam))
    return bases


def _cosine(init_value, decay_steps, alpha, count):
    """optax.cosine_decay_schedule(init_value, decay_steps, alpha)(count),
    in float32."""
    f = np.float32
    c = f(min(count, decay_steps))
    cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(decay_steps)))
    return f(init_value) * ((f(1) - f(alpha)) * cosine + f(alpha))


class RecoveryOptimizer:
    """The reference's ``optax.multi_transform`` over the offsets ("o") and
    the albedo ("a"), written out: each group is clipped by its own global
    norm (10·ext and 10), then Adam (b1 0.9, b2 0.999, eps 1e-8) scaled by
    its schedule: the offsets' a cosine decay from ``lr_scale``·ext over
    ``steps`` to alpha 0.02; the albedo's 0 until ``albedo_phase``·steps,
    then a cosine decay from 0.03 over the rest. Adam's moments update
    while a rate is 0, as optax's do. ``update`` returns the updates to
    add."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, off, alb, steps: int, ext: float = 1.0,
                 lr_scale: float = 0.004, albedo_phase: float = 0.25):
        self.steps, self.ext, self.lr_scale = steps, ext, lr_scale
        self.a_phase = int(albedo_phase * steps)
        self.max_norms = (float(10.0 * ext), 10.0)   # the groups' clips
        self.count = 0
        self.mu = [torch.zeros_like(off), torch.zeros_like(alb)]
        self.nu = [torch.zeros_like(off), torch.zeros_like(alb)]

    def rates(self, count):
        lr_o = _cosine(self.lr_scale * self.ext, self.steps, 0.02, count)
        if count < self.a_phase:
            lr_a = np.float32(0.0)
        else:
            lr_a = _cosine(0.03, max(1, self.steps - self.a_phase), 0.02,
                           count - self.a_phase)
        return lr_o, lr_a

    def update(self, g_off, g_alb):
        n = self.count + 1
        out = []
        for i, (g, max_norm, lr) in enumerate(zip(
                (g_off, g_alb), self.max_norms, self.rates(self.count))):
            norm = torch.sqrt(torch.sum(g * g))
            g = torch.where(norm < max_norm, g, (g / norm) * max_norm)
            self.mu[i] = (1 - self.B1) * g + self.B1 * self.mu[i]
            self.nu[i] = (1 - self.B2) * (g ** 2) + self.B2 * self.nu[i]
            # the bias corrections in f32, as optax computes them
            mu_hat = self.mu[i] / float(1 - np.float32(self.B1) ** n)
            nu_hat = self.nu[i] / float(1 - np.float32(self.B2) ** n)
            out.append(-float(lr) * (mu_hat / (torch.sqrt(nu_hat)
                                                + self.EPS)))
        self.count = n
        return out


def run_vertex_recovery(scene_true, topo, params, bases, steps,
                        start_offsets, start_albedo=None,
                        edge_samples: int = 4096,
                        smooth_weight: float = 0.08,
                        smooth_weight_end: float = 0.08,
                        l2_weight: float = 0.0,
                        lr_scale: float = 0.004,
                        albedo_phase: float = 0.25,
                        frame_cycle: int = 0,
                        sobolev_lam: float = 0.0,
                        ext: float = 1.0, log=True, log_every=None,
                        safe_point=False):
    """The recovery loop, on ``scene_true``'s device. ``scene_true`` must
    already be representable by the model (textures stripped, true albedo
    baked). Returns (offsets (V, 3) np, albedo (3,) np or None, losses
    list).

    ``smooth_weight`` multiplies the Dirichlet prior in units of
    (offset/ext)², annealed exponentially to ``smooth_weight_end``;
    ``l2_weight`` adds a weak pull of the offsets toward zero (tangential
    sliding is a null space of any image loss); ``sobolev_lam`` > 0
    preconditions the total vertex gradient by (I + λL)⁻¹."""
    dev = scene_true.device
    n_views = len(bases)
    bases = [b.to(dev) for b in bases]
    recover_albedo = start_albedo is not None
    valid = scene_true.tri_valid

    def scene_at(off, alb):
        s = apply_vertex_offsets(scene_true, topo, off)
        if recover_albedo:
            s = dataclasses.replace(
                s, tri_albedo=alb.expand(s.tri_albedo.shape)
                * valid[:, None])
        return s

    with torch.no_grad(), plane_scope():
        # target-side coverage masks per view, constant across the run
        hit_targets = [render_aov(scene_true, b, params, "hit")
                       for b in bases]
        # CRN: the target of step i is the true scene at the render's frame
        # index; with frame_cycle one per (view, frame) pair, made once
        targets = {}
        if frame_cycle:
            for i in range(min(steps, math.lcm(n_views, frame_cycle))):
                key = (i % n_views, i % frame_cycle)
                targets[key] = render_frame(scene_true, bases[key[0]],
                                            params, key[1])

    off = (start_offsets.detach() if torch.is_tensor(start_offsets)
           else torch.from_numpy(np.array(start_offsets))).to(
               dev, torch.float32)
    alb = torch.as_tensor(start_albedo if recover_albedo else TRUE_ALBEDO,
                          dtype=torch.float32, device=dev)
    opt = RecoveryOptimizer(off, alb, steps, ext, lr_scale, albedo_phase)
    sw_ratio = np.float32(smooth_weight_end / max(smooth_weight, 1e-9))

    losses = []
    log_every = log_every or max(1, steps // 10)
    for i in range(steps):
        v = i % n_views
        basis, hit_t = bases[v], hit_targets[v]
        f = i % frame_cycle if frame_cycle else i
        if frame_cycle:
            target = targets[(v, f)]
        else:
            with torch.no_grad():
                target = render_frame(scene_true, basis, params, f)

        with plane_scope():   # the step's scene packs once for its renders
            off_ = off.clone().requires_grad_(True)
            alb_ = alb.clone().requires_grad_(recover_albedo)
            scene = scene_at(off_, alb_)
            img = render_frame(scene, basis, params, f)
            res = (img - target).detach()
            loss = torch.mean(res ** 2)
            cot = 2.0 * res / res.numel()
            # the frame's scene without autograd: the same tensors, so the
            # AOV and the edge traces reuse the frame's packed planes
            scene_d = scene.detach()

            # interior gradient; the albedo cotangent is restricted to pixels
            # both coverages agree on (the silhouette-band bias fix)
            with torch.no_grad():
                w = render_aov(scene_d, basis, params, "hit") * hit_t
            g_off, = torch.autograd.grad(img, off_, cot,
                                         retain_graph=recover_albedo)
            if recover_albedo:
                g_alb, = torch.autograd.grad(
                    img, alb_, 2.0 * res * w / (3.0 * maximum(torch.sum(w),
                                                              1.0)))
            else:
                g_alb = torch.zeros_like(alb)
            del img

            # boundary (visibility) gradient at the current geometry
            gen = torch.Generator(device=dev)
            gen.manual_seed(EDGE_SEED * 2 ** 20 + i)
            bg = boundary_gradients(scene_d, basis, params, cot, gen,
                                    n_tri_samples=edge_samples,
                                    n_sph_samples=0, topology=topo)
            g_off = g_off + pull_back_vertex_grads(topo, bg, valid)

        # priors, dimensionless (offsets in exts): Dirichlet smoothness,
        # its weight annealed from smooth_weight to smooth_weight_end, and
        # the optional minimum-norm term
        sw = np.float32(smooth_weight) * np.power(
            sw_ratio, np.float32(i) / np.float32(max(1, steps - 1)))
        o = off.clone().requires_grad_(True)
        on = o / ext
        prior = (float(sw) * dirichlet_energy(topo, o)
                 + l2_weight * torch.mean(torch.sum(on * on, dim=-1)))
        g_off = g_off + torch.autograd.grad(prior, o)[0]
        if sobolev_lam:
            g_off = sobolev_precondition(topo, g_off, sobolev_lam)

        do, da = opt.update(g_off, g_alb)
        off = off + do
        if recover_albedo:
            # a projection of the optimizer's state, not a differentiable
            # bound
            alb = torch.clamp(alb + da, 0.0, 1.0)
        losses.append(float(loss))
        if log and i % log_every == 0:
            rms = float(torch.sqrt(torch.mean(torch.sum(off ** 2, -1)))) / ext
            print(f"step {i:4d} loss {losses[-1]:.6f} off_rms {rms:.4f}"
                  + (f" alb {alb.cpu().numpy().round(3)}"
                     if recover_albedo else ""), file=sys.stderr)
    return (off.cpu().numpy(),
            alb.cpu().numpy() if recover_albedo else None, losses)


def recovery_scene(path: str, device="cuda"):
    """The reference's recovery setup for a model file: loaded at the
    origin with TRUE_ALBEDO and smoothness 0, textures stripped, the
    truth carrying the recomputed normals the recovery renders with →
    (scene, topology, centre, extent)."""
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
    topo = build_topology(scene)
    scene = apply_vertex_offsets(
        scene, topo, torch.zeros((topo.num_verts, 3), device=scene.device))
    return scene, topo, (lo + hi) / 2, float(np.linalg.norm(hi - lo))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if len(argv) > 0 else 600
    size = int(argv[1]) if len(argv) > 1 else 128
    out = argv[2] if len(argv) > 2 else "artifacts/invert_vertices_torch.json"
    model = argv[3] if len(argv) > 3 else MODEL
    env = os.environ.get
    seed = int(env("RTT_INVERT_SEED", "1"))
    start_rms = float(env("RTT_INVERT_START_RMS", "0.10"))

    scene, topo, center, ext = recovery_scene(model)
    params = RenderParams(width=size, height=size, bounces=1, skybox=True,
                          rays_per_pixel=1)
    bases = ring_cameras(center, ext,
                         n_views=int(env("RTT_INVERT_VIEWS", "6")))
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    start = smooth_field(gen, topo.base_verts, ext, rms=start_rms * ext)
    start_alb = np.array([0.35, 0.6, 0.55], np.float32)

    t0 = time.time()
    off, alb, losses = run_vertex_recovery(
        scene, topo, params, bases, steps, start, start_alb,
        frame_cycle=int(env("RTT_INVERT_FRAME_CYCLE", "2")),
        edge_samples=int(env("RTT_INVERT_EDGE_SAMPLES", "4096")),
        smooth_weight=float(env("RTT_INVERT_SW", "0.08")),
        smooth_weight_end=float(env("RTT_INVERT_SW_END", "0.08")),
        l2_weight=float(env("RTT_INVERT_L2", "0.0")),
        lr_scale=float(env("RTT_INVERT_LR", "0.004")),
        sobolev_lam=float(env("RTT_INVERT_SOBOLEV", "50.0")),
        ext=ext)

    rms = float(np.sqrt(np.mean(np.sum(off ** 2, -1)))) / ext
    alb_err = float(np.abs(alb - TRUE_ALBEDO).max())
    result = {
        "steps": steps, "resolution": size, "views": len(bases),
        "seconds": round(time.time() - t0, 1),
        "tris": int(scene.num_tris), "vertices": int(topo.num_verts),
        "dof": int(topo.num_verts * 3),
        "device": torch.cuda.get_device_name(scene.device),
        "seed": seed,
        "start_offset_rms_rel_extent": start_rms,
        "offset_rms_rel_extent": round(rms, 5),
        "albedo_error": round(alb_err, 4),
        "recovered": rms < 0.01 and alb_err < 0.05,
    }
    line = json.dumps(result)
    print(line)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
