"""Edge-sampled visibility (boundary) gradients.

Port of ``ray_tracer_tpu.grad.edges``. The interior gradient path
(``ops/intersect.py``: detached winner, continuous recompute) cannot see
silhouette motion: moving a sphere sideways changes which pixels it
covers, a discontinuity autodiff integrates to zero. The missing
boundary term (Li et al. 2018, "Differentiable Monte Carlo Ray Tracing
through Edge Sampling") is

    dLoss/dθ |_boundary = ∮_silhouettes cot(pix(x)) · (L⁻(x) − L⁺(x))
                              · ( n̂(x) · ∂x_img/∂θ ) dl_img

where x runs over visibility discontinuity curves in image space, n̂ is a
unit normal of the curve, L± the radiance just to either side and cot the
upstream pixel cotangent. The form is orientation-invariant, so occluded
and interior edges contribute ≈0 by themselves.

Curves sampled: every triangle edge (uniform over (triangle, corner)
slots, or with a ``MeshTopology`` importance-sampled over physical
silhouette, boundary and crease edges), and every sphere's silhouette
circle as seen from the sample's lens point (thin-lens cameras draw one
lens point per sample; at aperture 0 it is the pinhole).

The estimator is split in two, so that the reference's draws can be fed
to the port: ``draw_edge_samples`` makes every random choice from a
``torch.Generator`` (edge or slot ids, positions along the edge, lens
uniforms, render-RNG states as int64 in [0, 2^32), sphere ids and angles),
and ``gradients_from_draws`` computes the gradients from them.
``boundary_gradients`` chains the two. The side-ray traces run without
autograd on detached scene fields; the image-space tangents are one
batched ``torch.func.jvp`` and the per-sample vector-Jacobian products
one ``torch.autograd.grad`` of a sum (every sample's function is
independent of the other rows).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..camera import CameraBasis
from ..ops.closest_hit import plane_scope
from ..ops.intersect import cross
from ..renderer import trace
from ..scene import Scene
from ..utils.bounds import clip, maximum
from ..utils.config import RenderParams

OUT_FIELDS = ("tri_v0", "tri_v1", "tri_v2", "sphere_center", "sphere_radius")


# ---------------------------------------------------------------------------
# Projection (inverse of the ray-gen map at aperture 0)
# ---------------------------------------------------------------------------

def project_to_image(basis: CameraBasis, x, width: int, height: int,
                     origin=None):
    """World point → image coordinates in pixel units (px right, py up,
    matching render_pixels' y-up pixel grid).

    Intersects the ray origin → x with the viewport plane spanned by
    (h, v) anchored at the lower-left corner. ``origin`` (default the
    pinhole) is the ray origin: a lens point for thin-lens cameras, for
    which this is the exact inverse of the ray generation at that point."""
    origin = basis.origin if origin is None else origin
    rel = x - origin
    anchor = basis.lower_left - origin
    denom = torch.sum(rel * basis.w, dim=-1, keepdim=True)
    tplane = torch.sum(anchor * basis.w, dim=-1, keepdim=True) / torch.where(
        torch.abs(denom) < 1e-12, 1e-12, denom)
    offset = rel * tplane - anchor
    px = (torch.sum(offset * basis.horizontal, dim=-1)
          / maximum(torch.sum(basis.horizontal ** 2, dim=-1), 1e-20))
    py = (torch.sum(offset * basis.vertical, dim=-1)
          / maximum(torch.sum(basis.vertical ** 2, dim=-1), 1e-20))
    return torch.stack([px * width, py * height], dim=-1)


def _radiance_at(scene, basis, params: RenderParams, pix, state,
                 origins=None):
    """Radiance of the ray through image point ``pix`` (pixel units), from
    ``origins`` ((N, 3) lens points; default: the pinhole origin)."""
    px = pix[:, 0] / params.width
    py = pix[:, 1] / params.height
    o = (basis.origin.expand(pix.shape[0], 3) if origins is None
         else origins).contiguous()
    d = (basis.lower_left + px[:, None] * basis.horizontal
         + py[:, None] * basis.vertical - o)
    _, rad = trace(scene, o, d, state, params)
    return rad


def _lookup_cot(cot_image, pix, width, height):
    """Nearest-pixel cotangent lookup; zero outside the frame."""
    x = torch.floor(pix[:, 0]).to(torch.int64)
    y = torch.floor(pix[:, 1]).to(torch.int64)
    inside = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    cot = cot_image.reshape(height, width, 3)[y.clamp(0, height - 1),
                                              x.clamp(0, width - 1)]
    return torch.where(inside[:, None], cot, 0.0)


def _lens_points(basis, lens_u):
    """(N, 3) per-sample ray origins from (N, 2) uniforms: a uniform disk
    point on the lens's (u, v) plane (camera_rays' depth-of-field model);
    exactly the pinhole at aperture 0."""
    rr = torch.sqrt(lens_u[:, 0])
    th = lens_u[:, 1] * (2.0 * np.pi)
    rd = basis.lens_radius * torch.stack([rr * torch.cos(th),
                                          rr * torch.sin(th)], dim=-1)
    return basis.origin + rd[:, 0:1] * basis.u + rd[:, 1:2] * basis.v


def _edge_weights(scene_d, basis, topo, width, height):
    """Physical-edge importance: projected image length (clipped to [1e-3,
    1e4]) on candidates, 0 elsewhere → (weights (E,), endpoints a, b (E,
    3)). Candidates: silhouettes (front/back flip between the two faces,
    seen from the pinhole), boundary edges and creases, of valid
    triangles."""
    verts = torch.stack([scene_d.tri_v0, scene_d.tri_v1, scene_d.tri_v2], 1)
    va_all = verts[topo.edge_tri, topo.edge_k]
    vb_all = verts[topo.edge_tri, (topo.edge_k + 1) % 3]

    def face_front(tri_ids):
        t = tri_ids.clamp_min(0)
        a = scene_d.tri_v0[t]
        nf = cross(scene_d.tri_v1[t] - a, scene_d.tri_v2[t] - a)
        cen = (a + scene_d.tri_v1[t] + scene_d.tri_v2[t]) / 3.0
        return torch.sum(nf * (basis.origin - cen), dim=-1) > 0.0

    has_b = topo.edge_tri2 >= 0
    cand = (torch.where(has_b, face_front(topo.edge_tri)
                        != face_front(topo.edge_tri2), True)
            | (topo.edge_crease > 0.5))
    cand = cand & (scene_d.tri_valid[topo.edge_tri] > 0.5)
    pa = project_to_image(basis, va_all, width, height)
    pb = project_to_image(basis, vb_all, width, height)
    ell = torch.linalg.vector_norm(pb - pa, dim=-1)
    return torch.where(cand, clip(ell, 1e-3, 1e4), 0.0), va_all, vb_all


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeDraws:
    """Every random choice of one estimate. A family whose ids are None is
    off. Triangle edges: ``edge_id`` (N,) int64, a physical-edge id with a
    topology, a (triangle, corner) slot id t * 3 + k without one;
    ``tparam`` (N,) f32 position along the edge; ``edge_lens`` (N, 2) f32
    lens uniforms (radius², angle); ``edge_state`` (N,) int64 render-RNG
    states in [0, 2^32). Sphere silhouettes: ``sphere_id`` (M,) int64,
    ``phi`` (M,) f32 angle on the circle, ``sphere_lens``,
    ``sphere_state``."""

    edge_id: Optional[torch.Tensor] = None
    tparam: Optional[torch.Tensor] = None
    edge_lens: Optional[torch.Tensor] = None
    edge_state: Optional[torch.Tensor] = None
    sphere_id: Optional[torch.Tensor] = None
    phi: Optional[torch.Tensor] = None
    sphere_lens: Optional[torch.Tensor] = None
    sphere_state: Optional[torch.Tensor] = None


@torch.no_grad()
def draw_edge_samples(scene: Scene, basis: CameraBasis,
                      params: RenderParams, generator: torch.Generator,
                      n_tri_samples: int = 4096, n_sph_samples: int = 4096,
                      topology=None) -> EdgeDraws:
    """Draw one estimate's samples from ``generator`` (on the scene's
    device). With a topology, edges are drawn in proportion to
    ``_edge_weights`` by ``torch.multinomial``; where no edge is a
    candidate every sample takes edge 0 with weight 0, as the reference's
    categorical draw over all −inf logits does, and contributes nothing."""
    dev = scene.device
    kw = dict(generator=generator, device=dev)

    def states(n):
        return torch.randint(0, 2 ** 32, (n,), dtype=torch.int64, **kw)

    draws = {}
    if n_tri_samples > 0 and scene.num_tris > 0 and (
            topology is None or topology.num_edges > 0):
        n = n_tri_samples
        if topology is not None:
            wgt = _edge_weights(scene.detach(), basis.to(dev), topology,
                                params.width, params.height)[0]
            some = torch.sum(wgt) > 0
            eid = torch.multinomial(torch.where(some, wgt, 1.0), n,
                                    replacement=True, generator=generator)
            eid = torch.where(some, eid, 0)
        else:
            eid = torch.randint(0, 3 * scene.padded_tris, (n,), **kw)
        draws.update(edge_id=eid, tparam=torch.rand(n, **kw),
                     edge_lens=torch.rand(n, 2, **kw), edge_state=states(n))
    if n_sph_samples > 0 and scene.num_spheres > 0:
        m = n_sph_samples
        draws.update(
            sphere_id=torch.randint(0, scene.padded_spheres, (m,), **kw),
            phi=torch.rand(m, **kw) * 2.0 * np.pi,
            sphere_lens=torch.rand(m, 2, **kw), sphere_state=states(m))
    return EdgeDraws(**draws)


# ---------------------------------------------------------------------------
# Boundary gradient estimator
# ---------------------------------------------------------------------------

def _silhouette_point(c, r, phi, o):
    """Point at angle ``phi`` on sphere (c, r)'s silhouette circle as seen
    from ``o`` (rows of (N, 3) / (N,) tensors): centre c + (r²/d²)(o − c),
    radius r·sqrt(1 − r²/d²), in the plane ⊥ (o − c)."""
    oc = o - c
    d2 = maximum(torch.sum(oc * oc, dim=-1), 1e-12)
    axis = oc / torch.sqrt(d2)[:, None]
    # visible only when the camera is outside (r < d)
    ratio2 = clip(r * r / d2, 0.0, 0.999999)
    center = c + oc * ratio2[:, None]
    r_sil = r * torch.sqrt(1.0 - ratio2)
    z_up = torch.abs(axis[:, 2:3]) < 0.9
    up = torch.where(z_up, axis.new_tensor([0.0, 0.0, 1.0]),
                     axis.new_tensor([0.0, 1.0, 0.0]))
    e1 = cross(axis, up)
    e1 = e1 / maximum(torch.linalg.vector_norm(e1, dim=-1, keepdim=True),
                      1e-12)
    e2 = cross(axis, e1)
    return center + r_sil[:, None] * (torch.cos(phi)[:, None] * e1
                                      + torch.sin(phi)[:, None] * e2)


@plane_scope()
def gradients_from_draws(scene: Scene, basis: CameraBasis,
                         params: RenderParams, cot_image, draws: EdgeDraws,
                         eps_px: float = 0.05,
                         topology=None) -> Dict[str, torch.Tensor]:
    """Monte-Carlo boundary-term gradients from the given draws (see
    ``boundary_gradients``). Both side rays of a sample share its lens
    point and render-RNG state."""
    W, H = params.width, params.height
    basis = basis.to(scene.device)
    scene_d = scene.detach()
    cot_image = cot_image.detach()
    out = {k: torch.zeros_like(getattr(scene_d, k)) for k in OUT_FIELDS}

    def side_terms(x_img, tangent, state, origins):
        tlen = torch.linalg.vector_norm(tangent, dim=-1)
        that = tangent / maximum(tlen, 1e-12)[:, None]
        nhat = torch.stack([-that[:, 1], that[:, 0]], dim=-1)
        with torch.no_grad():
            l_minus = _radiance_at(scene_d, basis, params,
                                   x_img - eps_px * nhat, state, origins)
            l_plus = _radiance_at(scene_d, basis, params,
                                  x_img + eps_px * nhat, state, origins)
        cot = _lookup_cot(cot_image, x_img, W, H)
        # scalar weight per sample: Σ_c cot_c (L⁻ − L⁺)_c, with a zero
        # cotangent (off the frame) contributing 0 even where a side ray's
        # radiance overflows: the sun lobe, pow(d·s, 500) on unnormalized
        # directions, is inf for rays far past the frame, and the
        # reference's 0 · inf makes the whole gradient NaN there
        dl = torch.where(cot != 0.0, l_minus - l_plus, 0.0)
        return nhat, tlen, torch.sum(cot * dl, dim=-1)

    if draws.edge_id is not None:
        n = draws.edge_id.shape[0]
        eid, tparam = draws.edge_id, draws.tparam
        if topology is not None:
            wgt, va_all, vb_all = _edge_weights(scene_d, basis, topology,
                                                W, H)
            wsum = torch.sum(wgt)
            tri, edge = topology.edge_tri[eid], topology.edge_k[eid]
            va, vb, w_e = va_all[eid], vb_all[eid], wgt[eid]
            p_e = w_e / maximum(wsum, 1e-30)
            inv_meas = torch.where(w_e > 0,
                                   1.0 / (maximum(p_e, 1e-30) * n), 0.0)
            valid = (w_e > 0) & (wsum > 0)
        else:
            # uniform over (triangle, corner) slots: right only where no
            # edge is shared (see ``topology``)
            verts = torch.stack(
                [scene_d.tri_v0, scene_d.tri_v1, scene_d.tri_v2], 1)
            tri, edge = eid // 3, eid % 3
            va, vb = verts[tri, edge], verts[tri, (edge + 1) % 3]
            valid = scene_d.tri_valid[tri] > 0.5
            inv_meas = torch.full((n,), 3 * scene.padded_tris / n,
                                  dtype=torch.float32, device=eid.device)
        ol = _lens_points(basis, draws.edge_lens)

        def project(p):
            return project_to_image(basis, p, W, H, ol)

        x_world = (1.0 - tparam)[:, None] * va + tparam[:, None] * vb
        # image-space tangent dX/dt, the derivative along (vb - va)
        x_img, tangent = torch.func.jvp(project, (x_world,), (vb - va,))
        nhat, tlen, s = side_terms(x_img, tangent, draws.edge_state, ol)
        # measure ∫ dl_img = ∫₀¹ |dX/dt| dt per edge, the edge choice
        # weighted by inv_meas = 1/(pdf·N)
        coeff = torch.where(valid, s, 0.0) * tlen * inv_meas
        # ∂(n̂·x_img)/∂va = (1−t)·Jᵀn̂, ∂/∂vb = t·Jᵀn̂
        with torch.enable_grad():
            xw = x_world.detach().requires_grad_(True)
            gw, = torch.autograd.grad(torch.sum(project(xw) * nhat), xw)
        ga = coeff[:, None] * (1.0 - tparam)[:, None] * gw
        gb = coeff[:, None] * tparam[:, None] * gw
        for k in range(3):
            contrib = (torch.where((edge == k)[:, None], ga, 0.0)
                       + torch.where(((edge + 1) % 3 == k)[:, None], gb, 0.0))
            out[f"tri_v{k}"].index_add_(0, tri, contrib)

    if draws.sphere_id is not None:
        m = draws.sphere_id.shape[0]
        sid, phi = draws.sphere_id, draws.phi
        valid = ((scene_d.sphere_valid[sid] > 0.5)
                 & (scene_d.sphere_radius[sid] > 0.0))
        ol = _lens_points(basis, draws.sphere_lens)
        c, r = scene_d.sphere_center[sid], scene_d.sphere_radius[sid]

        def project_on_circle(c_, r_, phi_):
            return project_to_image(
                basis, _silhouette_point(c_, r_, phi_, ol), W, H, ol)

        # tangent along the curve: dX/dφ
        x_img, tangent = torch.func.jvp(
            lambda p: project_on_circle(c, r, p), (phi,),
            (torch.ones_like(phi),))
        nhat, tlen, s = side_terms(x_img, tangent, draws.sphere_state, ol)
        inside_cam = torch.sum((ol - c) ** 2, dim=-1) > r * r
        # measure ∫ dl_img = ∫₀²π |dX/dφ| dφ, spheres picked uniformly
        coeff = (torch.where(valid & inside_cam, s, 0.0) * tlen
                 * (scene.padded_spheres * 2.0 * np.pi / m))
        with torch.enable_grad():
            c_ = c.detach().requires_grad_(True)
            r_ = r.detach().requires_grad_(True)
            g_c, g_r = torch.autograd.grad(
                torch.sum(project_on_circle(c_, r_, phi) * nhat), (c_, r_))
        out["sphere_center"].index_add_(0, sid, coeff[:, None] * g_c)
        out["sphere_radius"].index_add_(0, sid, coeff * g_r)
    return out


@plane_scope()
def boundary_gradients(scene: Scene, basis: CameraBasis, params: RenderParams,
                       cot_image, generator: torch.Generator,
                       n_tri_samples: int = 4096, n_sph_samples: int = 4096,
                       eps_px: float = 0.05,
                       topology=None) -> Dict[str, torch.Tensor]:
    """Monte-Carlo boundary-term gradients.

    Args:
      cot_image: (H, W, 3) upstream pixel cotangent ∂Loss/∂pixel.
      generator: ``torch.Generator`` on the scene's device (edge sampling
        is independent of the render RNG).
      n_tri_samples / n_sph_samples: MC sample counts (0 disables a family).
      eps_px: side-ray offset in pixels.
      topology: optional ``grad.topology.MeshTopology``, strongly
        recommended for meshes with shared edges: it switches edge sampling
        from uniform over (triangle, corner) slots, which counts every
        interior edge twice and spends most samples on interior edges, to
        importance sampling over physical silhouette, boundary and crease
        edges weighted by projected image length. Gradients land on the
        representative (triangle, corner) slots; pull them back to unique
        vertices with ``topology.pull_back_vertex_grads``.

    Returns a dict with keys tri_v0, tri_v1, tri_v2, sphere_center and
    sphere_radius, shaped like the scene fields, zeros where inapplicable.
    """
    draws = draw_edge_samples(scene, basis, params, generator,
                              n_tri_samples, n_sph_samples, topology)
    return gradients_from_draws(scene, basis, params, cot_image, draws,
                                eps_px, topology)
