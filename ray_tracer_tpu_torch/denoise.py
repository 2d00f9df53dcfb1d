"""Edge-avoiding à-trous wavelet denoiser (Dammertz et al. 2010).

Port of ``ray_tracer_tpu.denoise``, in plain PyTorch as the reference is
in plain jnp: each iteration is 25 shifted multiply-adds over the whole
image (B3-spline 5×5 taps, dilated 2^i), guided by the primary-ray normal
and depth AOVs (``renderer.render_aov``) so the blur stops at feature
edges:

    w = k · exp(-|c−c'|²/σ_c² - |n−n'|²/σ_n² - |z−z'|²/σ_z²)

Miss pixels carry n = 0 and z = 0, itself a feature edge, so silhouettes
against the sky stay sharp. Runs on the image's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops.closest_hit import plane_scope
from .utils.bounds import maximum

# B3-spline coefficients (1/16, 1/4, 3/8, 1/4, 1/16)
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _pad_edge(x, p: int):
    """(H, W, C) → (H + 2p, W + 2p, C), edges replicated."""
    xp = F.pad(x.permute(2, 0, 1)[None], (p, p, p, p), mode="replicate")
    return xp[0].permute(1, 2, 0)


def _tap(xp, p: int, dy: int, dx: int, H: int, W: int):
    """The (H, W) window of the padded image shifted by (dy, dx)."""
    return xp[p + dy:p + dy + H, p + dx:p + dx + W]


def denoise(img, normal, depth, iterations: int = 3,
            sigma_color: float = 0.5, sigma_normal: float = 0.3,
            sigma_depth: float = 0.15):
    """À-trous guided filter → denoised (H, W, 3).

    Args:
      img: (H, W, 3) linear radiance (the accumulated beauty pass).
      normal: (H, W, 3) primary-ray normals (render_aov "normal").
      depth: (H, W, 1|3) primary-ray depth (render_aov "depth").
      iterations: à-trous levels (dilation 1, 2, 4, ...).
      sigma_*: edge-stopping bandwidths; depth is compared relative to the
        depth image's range (misses included), so the default works across
        scene scales.
    """
    depth = depth[..., :1]
    zrange = maximum(depth.amax() - depth.amin(), 1e-6)
    z = depth / zrange
    H, W = img.shape[0], img.shape[1]
    out = img
    for it in range(iterations):
        step = 1 << it
        p = 2 * step
        outp, np_, zp = (_pad_edge(x, p) for x in (out, normal, z))
        acc = torch.zeros_like(out)
        wsum = torch.zeros_like(out[..., :1])
        for iy in range(-2, 3):
            for ix in range(-2, 3):
                k = float(_B3[iy + 2] * _B3[ix + 2])
                c_s, n_s, z_s = (_tap(x, p, iy * step, ix * step, H, W)
                                 for x in (outp, np_, zp))
                dc = ((c_s - out) ** 2).sum(-1, keepdim=True)
                dn = ((n_s - normal) ** 2).sum(-1, keepdim=True)
                dz = (z_s - z) ** 2
                w = k * torch.exp(-dc / (sigma_color ** 2)
                                  - dn / (sigma_normal ** 2)
                                  - dz / (sigma_depth ** 2))
                acc = acc + w * c_s
                wsum = wsum + w
        out = acc / maximum(wsum, 1e-12)
    return out


@plane_scope()
def denoise_render(scene, basis, params, img, iterations: int = 3):
    """Render the guide AOVs (normal, depth) of ``scene`` and filter
    ``img`` with them."""
    from .renderer import render_aov

    normal = render_aov(scene, basis, params, "normal")
    depth = render_aov(scene, basis, params, "depth")
    return denoise(img, normal, depth, iterations=iterations)
