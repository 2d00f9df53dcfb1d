"""Branchless material scattering.

Port of ``ray_tracer_tpu.materials``: every lane computes the
diffuse⊕glossy direction and the dielectric direction, and a ``where`` on
the material flag selects. Dielectrics (smoothness -1) use IOR 1.5,
Schlick reflectance against a uniform draw, and Snell refraction.
"""

from __future__ import annotations

import torch

from . import sampling
from .utils.bounds import clip, maximum, minimum

IOR_GLASS = 1.5

# Width of the coherent-scatter share tile when RenderParams.coherent_tile
# is 0. The reference takes its TPU kernel's ray tile there, which is 512;
# the port fixes the same width as a constant, whatever its own kernel's
# block size, so both packages draw the same sample streams.
DEFAULT_SHARE_TILE = 512


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _unit(v):
    return v / maximum(torch.sqrt(_dot(v, v)), 1e-12)


def reflect(d, n):
    """Mirror reflection."""
    return d - 2.0 * _dot(d, n) * n


def refract(unit_d, n, refraction_ratio):
    """Snell refraction (squared perpendicular length)."""
    cos_theta = minimum(_dot(-unit_d, n), 1.0)
    r_perp = refraction_ratio * (unit_d + cos_theta * n)
    r_perp_len2 = _dot(r_perp, r_perp)
    r_par = -torch.sqrt(maximum(torch.abs(1.0 - r_perp_len2), 1e-12)) * n
    return r_perp + r_par


def schlick_reflectance(cosine, refraction_ratio):
    """Schlick's approximation of Fresnel reflectance."""
    r0 = (1.0 - refraction_ratio) / (1.0 + refraction_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)


def scatter(state, d, normal, smoothness, cosine_sampling: bool = False,
            share_tile: int = 0):
    """Scattered direction for every lane.

    Args:
      state: (R,) RNG state.
      d: incoming (unnormalized) directions (R, 3).
      normal: outward unit normals at the hit (R, 3).
      smoothness: (R,); -1 marks a dielectric.
      share_tile: if > 0 and it divides R, each run of ``share_tile``
        lanes shares ONE unit-sphere draw for the diffuse lobe (coherent
        path tracing; each lane's direction stays marginally exact).

    Returns:
      (state, new_dir (R, 3), is_dielectric (R,) bool).
    """
    unit_d = _unit(d)
    is_dielectric = smoothness < 0.0

    # --- diffuse ⊕ glossy ------------------------------------------------
    sharing = bool(share_tile) and state.shape[0] % share_tile == 0
    if sharing:
        # one sphere draw per tile from a decorrelated copy of the tile's
        # first lane's state; every lane then advances once
        tstate = state[::share_tile] ^ 0x9E3779B1
        _, sph_t = sampling.unit_sphere(tstate)
        sph = sph_t.repeat_interleave(share_tile, dim=0)
        state, _ = sampling.next_u32(state)
    if cosine_sampling:
        if not sharing:
            state, sph = sampling.unit_sphere(state)
        v = normal + sph
        n2 = _dot(v, v)
        diffuse_dir = torch.where(
            n2 > 1e-12, v / torch.sqrt(maximum(n2, 1e-12)), normal)
    elif sharing:
        sflip = _dot(sph, normal)
        diffuse_dir = sph * torch.where(sflip >= 0.0, 1.0, -1.0)
    else:
        state, diffuse_dir = sampling.hemisphere(state, normal)
    specular_dir = reflect(unit_d, normal)
    s = clip(smoothness, 0.0, 1.0)[:, None]
    glossy_dir = diffuse_dir * (1.0 - s) + specular_dir * s

    # --- dielectric ------------------------------------------------------
    front_face = _dot(d, normal)[:, 0] <= 0.0
    ratio = torch.where(front_face, 1.0 / IOR_GLASS, IOR_GLASS)
    cos_theta = minimum(_dot(-unit_d, normal)[:, 0], 1.0)
    sin_theta = torch.sqrt(maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    state, u = sampling.uniform(state)
    use_reflect = cannot_refract | (schlick_reflectance(cos_theta, ratio) > u)
    refr = refract(unit_d, normal, ratio[:, None])
    refl = reflect(unit_d, normal)
    dielectric_dir = torch.where(use_reflect[:, None], refl, refr)

    new_dir = torch.where(is_dielectric[:, None], dielectric_dir, glossy_dir)
    return state, new_dir, is_dielectric
