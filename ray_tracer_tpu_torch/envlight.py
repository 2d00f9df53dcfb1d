"""Procedural sky / environment light.

Port of ``ray_tracer_tpu.envlight``: a horizon→zenith gradient with a
smoothstep ramp, a flat ground colour below the horizon, and a tight sun
lobe added at and above the horizon. The sun term's dot product with the
(unnormalized) sun direction is written as three multiplies and adds, so no
matrix product, and no TF32 setting, can touch it.
"""

from __future__ import annotations

import functools

import torch

from .utils.bounds import clip, maximum

SKY_HORIZON = (1.0, 1.0, 1.0)
SKY_ZENITH = (0.0788092, 0.36480793, 0.7264151)
GROUND_COLOR = (0.35, 0.3, 0.35)
SUN_INTENSITY = 0.1
SUN_FOCUS = 500.0
SUN_DIR = (0.1, 1.0, 0.1)  # unnormalized, as in the reference


def smoothstep(edge0, edge1, x):
    t = clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@functools.lru_cache(maxsize=None)
def _colors(device: torch.device):
    """(horizon, zenith, ground) colour tensors, made once per device."""
    return tuple(torch.tensor(c, dtype=torch.float32, device=device)
                 for c in (SKY_HORIZON, SKY_ZENITH, GROUND_COLOR))


def environment_light(dirs: torch.Tensor) -> torch.Tensor:
    """Sky radiance for (unnormalized) ray directions (N, 3) → (N, 3)."""
    horizon, zenith, ground = _colors(dirs.device)
    y = dirs[:, 1]
    s = smoothstep(0.0, 0.4, y)
    s_ok = s > 0.0
    sky_t = torch.where(s_ok, torch.pow(torch.where(s_ok, s, 1.0), 0.35),
                        0.0)[:, None]
    ground_to_sky = smoothstep(-0.01, 0.0, y)[:, None]
    sky = horizon * (1.0 - sky_t) + zenith * sky_t
    sun_cos = ((dirs[:, 0] * SUN_DIR[0] + dirs[:, 1] * SUN_DIR[1])
               + dirs[:, 2] * SUN_DIR[2])
    sun = torch.pow(maximum(sun_cos, 0.0), SUN_FOCUS) * SUN_INTENSITY
    return (ground * (1.0 - ground_to_sky)
            + sky * ground_to_sky
            + sun[:, None] * (ground_to_sky >= 1.0).to(torch.float32))
