"""Explicit light sampling (next-event estimation, NEE).

Port of ``ray_tracer_tpu.lights``: the light table, the solid-angle pdf
of the glossy lerp lobe, and the per-lane light sampler. Off unless
``RenderParams.nee`` is on.

Estimator: the renderer's implicit transport multiplies throughput by the
albedo per bounce while scattering along ``(1-s)·h + s·reflect`` with h a
hemisphere sample, i.e. an effective BRDF albedo · p_lobe(ω). NEE
integrates the same function over each light's solid angle with the
closed-form p_lobe (``glossy_mix_pdf``), so the converged image does not
change at any smoothness s < 1; perfect mirrors keep BSDF sampling.

The table holds the ``MAX_LIGHTS`` emitters of highest power, ordered as
``jax.lax.top_k`` orders them (a stable descending sort: the lower id
first among equal powers), with everything a lane needs about its light
in one (L, 20) ``packed`` row. Lanes look rows up by index gathers where
the reference contracts a one-hot (R, L) matrix with ``packed``: both are
exact, and a gather's backward is an index-add. ``slot`` maps every
primitive id to its table slot (-1 where the primitive is not a valid
entry), which answers the renderer's "is this hit a table light" and
"which row" in one gather.

Bounds on differentiable values go through ``utils/bounds.py``, so their
gradients split at a tie as JAX's do. Norms use ``torch.linalg.vector_norm``,
whose gradient at a zero vector is 0: the reference's ``jnp.linalg.norm``
gives NaN there, and its one-hot contractions spread that NaN over the
table (ROADMAP §C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import sampling
from .ops.intersect import cross
from .scene import Scene
from .utils.bounds import maximum

MAX_LIGHTS = 16
FOUR_PI = float(np.float32(4.0 * np.pi))
PI = float(np.float32(np.pi))
INV_TWO_PI = float(np.float32(1.0) / np.float32(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class LightTable:
    """Fixed-size emitter table.

    ``packed`` (L, 20): [p_light | area | emission(3) | prim_id | is_tri |
    center(3) | radius | v0(3) | v1(3) | v2(3)], the reference's layout.
    """

    packed: torch.Tensor       # (L, 20)
    prim_id: torch.Tensor      # (L,) int32 global primitive id
    cdf: torch.Tensor          # (L,) normalized inclusive power CDF
    has_lights: torch.Tensor   # () bool; a tensor, so no host sync
    entry_valid: torch.Tensor  # (L,) bool: a real (power > 0) emitter
    slot: torch.Tensor         # (SP + TP,) int64 table slot, -1 if none


def _norm(x):
    """Euclidean norm over the last axis, keeping it (gradient 0 at 0)."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _unit(v):
    """v / max(|v|, 1e-12) over the last axis."""
    return v / maximum(_norm(v), 1e-12)


def build_light_table(scene: Scene) -> LightTable:
    """Select the MAX_LIGHTS highest-power emitters."""
    SP = scene.padded_spheres
    n = SP + scene.padded_tris
    # prim ids ride an f32 column of the packed table: exact only below 2^24
    if n >= 2 ** 24:
        raise ValueError(
            f"scene too large for NEE light table: {n} prim ids exceed "
            f"f32-exact integer range (2^24)")
    s_pow_mask = ((scene.sphere_valid > 0.5)
                  & (scene.sphere_emission_strength > 0.0))
    s_area = FOUR_PI * scene.sphere_radius ** 2
    s_emit = scene.sphere_emission * scene.sphere_emission_strength[:, None]
    s_power = torch.where(s_pow_mask, s_emit.mean(1) * s_area, 0.0)

    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    t_area = 0.5 * _norm(cross(e1, e2))[:, 0]
    t_pow_mask = ((scene.tri_valid > 0.5)
                  & (scene.tri_emission_strength > 0.0))
    t_emit = scene.tri_emission * scene.tri_emission_strength[:, None]
    t_power = torch.where(t_pow_mask, t_emit.mean(1) * t_area, 0.0)

    power = torch.cat([s_power, t_power])
    emit = torch.cat([s_emit, t_emit])
    area = torch.cat([s_area, t_area])
    L = min(MAX_LIGHTS, n)
    # top_k's order: descending power, the lower id first among ties
    top = torch.sort(power.detach(), descending=True, stable=True)[1][:L]
    top_power = power[top]
    is_tri = top >= SP

    total = top_power.sum()
    has = total > 0.0
    cdf = torch.cumsum(top_power, 0) / torch.where(has, total, 1.0)
    cdf_prev = torch.cat([cdf.new_zeros((1,)), cdf[:-1]])

    sidx = torch.where(is_tri, 0, top)
    tidx = torch.where(is_tri, top - SP, 0)
    packed = torch.cat([
        (cdf - cdf_prev)[:, None],                 # 0  p_light
        area[top][:, None],                        # 1
        emit[top],                                 # 2:5  emission
        top.to(torch.float32)[:, None],            # 5  prim_id
        is_tri.to(torch.float32)[:, None],         # 6  is_tri
        scene.sphere_center[sidx],                 # 7:10
        scene.sphere_radius[sidx][:, None],        # 10
        scene.tri_v0[tidx],                        # 11:14
        scene.tri_v1[tidx],                        # 14:17
        scene.tri_v2[tidx],                        # 17:20
    ], dim=1)
    entry_valid = top_power.detach() > 0.0
    slots = torch.arange(L, device=top.device)
    slot = torch.full((n,), -1, dtype=torch.int64, device=top.device)
    slot.scatter_(0, top, torch.where(entry_valid, slots, -1))
    return LightTable(packed=packed, prim_id=top.to(torch.int32), cdf=cdf,
                      has_lights=has, entry_valid=entry_valid, slot=slot)


def glossy_mix_pdf(wi_unit, refl, normal, s, cosine_sampling: bool):
    """Solid-angle pdf of the glossy lerp lobe ``(1-s)·h + s·r`` at the
    unit direction ``wi_unit``: the exact effective BRDF weight for NEE.

    The lerp maps the unit h-sphere to a sphere of radius (1-s) centred at
    s·r. For c = ω·r, points t·ω on it satisfy t² - 2·t·s·c + s² - (1-s)²
    = 0, so t± = s·c ± √disc with disc = s²(c²-1) + (1-s)². Each root
    t > 0 maps back to h = (t·ω - s·r)/(1-s) and adds
    p_h(h) · t² / ((1-s)·√disc) where h·n > 0, p_h the hemisphere density
    (1/2π uniform, cos/π cosine-weighted).

    Args: wi_unit (R, 3); refl (R, 3) unit mirror direction; normal (R, 3)
    unit shading normal; s (R,) in [0, 1); cosine_sampling.
    Returns (R,) pdf, 0 outside the lobe's support.
    """
    c = (wi_unit * refl).sum(-1)
    one_s = maximum(1.0 - s, 1e-6)
    disc = s * s * (c * c - 1.0) + one_s * one_s
    sq = torch.sqrt(maximum(disc, 1e-20))

    def root_contrib(t):
        h = (t[:, None] * wi_unit - s[:, None] * refl) / one_s[:, None]
        cos_hn = (h * normal).sum(-1)
        if cosine_sampling:
            p_h = maximum(cos_hn, 0.0) / PI
        else:
            p_h = torch.where(cos_hn > 0.0, INV_TWO_PI, 0.0)
        return torch.where(t > 1e-6, p_h * t * t / (one_s * sq), 0.0)

    pdf = root_contrib(s * c + sq) + root_contrib(s * c - sq)
    return torch.where(disc > 0.0, pdf, 0.0)


def sample_lights(lights: LightTable, scene: Scene, state, p):
    """Sample one light point per lane.

    Args: lights; scene (unused: the geometry rides ``lights.packed``;
    kept for the reference's signature); state (R,) RNG state; p (R, 3)
    shadow-ray origins.

    Draws, on every lane: one uniform (the light), one unit-sphere
    direction (a sphere light's point), two uniforms (a triangle light's
    point). Returns (state, dict): wi (R, 3) unnormalized direction to the
    light point, dist (R,), radiance (R, 3), inv_pdf_w (R,)
    ``area·|cos_l|/d² / P(light)``, light_prim (R,) int32, ok (R,) bool (a
    light was sampled and faces p).
    """
    state, u = sampling.uniform(state)
    # CDF inversion: the count of steps below u. The CDF is a cumsum of
    # non-negative powers, so it is sorted and the count is searchsorted's
    # left insertion point.
    li = torch.searchsorted(lights.cdf.detach(), u).clamp(
        max=lights.cdf.shape[0] - 1)
    row = lights.packed[li]                                   # (R, 20)
    p_light, area, radiance = row[:, 0], row[:, 1], row[:, 2:5]
    light_prim = row[:, 5].to(torch.int32)
    kind = row[:, 6]
    c, r = row[:, 7:10], row[:, 10]
    v0, v1, v2 = row[:, 11:14], row[:, 14:17], row[:, 17:20]

    # sphere light: uniform point on the surface
    state, sdir = sampling.unit_sphere(state)
    p_sphere = c + sdir * r[:, None]

    # triangle light: uniform barycentric point
    state, u1 = sampling.uniform(state)
    state, u2 = sampling.uniform(state)
    su = torch.sqrt(maximum(u1, 1e-12))
    b0 = 1.0 - su
    b1 = su * (1.0 - u2)
    b2 = su * u2
    p_tri = v0 * b0[:, None] + v1 * b1[:, None] + v2 * b2[:, None]
    n_tri = _unit(cross(v1 - v0, v2 - v0))

    is_tri = (kind > 0.5)[:, None]
    lp = torch.where(is_tri, p_tri, p_sphere)
    ln = torch.where(is_tri, n_tri, sdir)

    wi = lp - p
    d2 = (wi * wi).sum(-1)
    dist = torch.sqrt(maximum(d2, 1e-20))
    wi_unit = wi / dist[:, None]
    # only the emitting face looking toward p contributes
    cos_l = (-wi_unit * ln).sum(-1)
    front = cos_l > 1e-6

    inv_pdf_w = (area * torch.abs(cos_l) / maximum(d2, 1e-20)
                 / maximum(p_light, 1e-12))
    ok = lights.has_lights & front & (p_light > 0.0)
    return state, dict(wi=wi, dist=dist, radiance=radiance,
                       inv_pdf_w=inv_pdf_w, light_prim=light_prim, ok=ok)
