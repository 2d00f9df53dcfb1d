"""Per-lane counter-based RNG and sampling primitives.

Port of ``ray_tracer_tpu.sampling``: the reference's LCG state update
followed by a PCG-style output permutation, one state per ray. The stream
is a pure function of (pixel, frame), so the render path needs no
``torch.Generator``.

State representation: PyTorch on the CPU has no ``+``, ``>>``, ``<<`` or
``%`` on uint32, so the state is an int64 tensor holding a value in
[0, 2^32), masked back to 32 bits after every ``*`` and ``+``. No product
leaves int64: state < 2^32 and the LCG and mix multipliers are < 2^30,
so every product is < 2^62. The R2 multipliers are above 2^31, so
``r2_point`` multiplies by their 16-bit halves (each product < 2^48).
The outputs are bit-identical to the reference's uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_LCG_MUL = 747796405
_LCG_ADD = 2891336453
_MIX_MUL = 277803737
_FRAME_STRIDE = 71939
_U32_MAX_F = 4294967295.0   # float32(2^32 - 1) rounds to 2^32, as in JAX
TWO_PI = float(np.float32(2.0 * np.pi))   # the reference's float32 2π


def seed_state(pixel_index: torch.Tensor, frame_index: int) -> torch.Tensor:
    """Initial per-ray state: unique per pixel, strided by 71939 per
    frame (both taken mod 2^32)."""
    frame = int(frame_index) & MASK32
    return (pixel_index.to(torch.int64) + frame * _FRAME_STRIDE) & MASK32


# R2 low-discrepancy sequence (the plastic-number generalization of the
# golden ratio to 2D) in 0.32 fixed point: the n-th point is
# (n G1 mod 2^32, n G2 mod 2^32), exact modular arithmetic
R2_G1_U32 = 3242174889   # round(0.7548776662466927 * 2^32)
R2_G2_U32 = 2447445414   # round(0.5698402909980532 * 2^32)
_INV_2_32 = float(np.float32(1.0 / 4294967296.0))


def _mul_u32(n: torch.Tensor, g: int) -> torch.Tensor:
    """n * g mod 2^32 for n in [0, 2^32) and a 32-bit constant g, with no
    product past 2^48: n * g = n * g_hi * 2^16 + n * g_lo."""
    g_hi, g_lo = g >> 16, g & 0xFFFF
    return ((((n * g_hi) & 0xFFFF) << 16) + n * g_lo) & MASK32


def r2_point(n, rot_x: torch.Tensor, rot_y: torch.Tensor):
    """The n-th R2 point with a per-lane Cranley-Patterson rotation (both
    32-bit) → (ax, ay) float32 in [0, 1]."""
    n = torch.as_tensor(n, dtype=torch.int64, device=rot_x.device) & MASK32
    ax = ((_mul_u32(n, R2_G1_U32) + rot_x) & MASK32).to(torch.float32)
    ay = ((_mul_u32(n, R2_G2_U32) + rot_y) & MASK32).to(torch.float32)
    return ax * _INV_2_32, ay * _INV_2_32


def next_u32(state: torch.Tensor):
    """One generator step → (new_state, random 32-bit word), both int64."""
    state = (state * _LCG_MUL + _LCG_ADD) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * _MIX_MUL) & MASK32
    return state, (word >> 22) ^ word


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Stateless hash of 32-bit values: one generator step seeded at x."""
    return next_u32(x.to(torch.int64) & MASK32)[1]


def uniform(state: torch.Tensor):
    """float32 in [0, 1]: the word converted straight to float32, then
    divided by float32(2^32 - 1)."""
    state, bits = next_u32(state)
    return state, bits.to(torch.float32) / _U32_MAX_F


def normal(state: torch.Tensor):
    """Standard normal via Box-Muller; log(0) is guarded by a clamp."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    theta = TWO_PI * u1
    rho = torch.sqrt(-2.0 * torch.log(torch.clamp(u2, min=1e-10)))
    return state, rho * torch.cos(theta)


def unit_sphere(state: torch.Tensor):
    """Uniform direction on the unit sphere = normalized 3-Gaussian."""
    state, x = normal(state)
    state, y = normal(state)
    state, z = normal(state)
    v = torch.stack([x, y, z], dim=-1)
    n = torch.sqrt((x * x + y * y) + z * z)[:, None]
    return state, v / torch.clamp(n, min=1e-12)


def hemisphere(state: torch.Tensor, normal_vec: torch.Tensor):
    """Sphere sample flipped into the hemisphere around ``normal_vec``
    (the tangential case maps to +1)."""
    state, d = unit_sphere(state)
    s = (d * normal_vec).sum(-1, keepdim=True)
    return state, d * torch.where(s >= 0.0, 1.0, -1.0)


def unit_disk(state: torch.Tensor):
    """Uniform point in the unit disk, analytic polar form → (N, 2)."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return state, torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)
