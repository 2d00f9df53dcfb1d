"""The plain reference of the viewer's host side: the fly camera's step
(the reference project's camera controller, float64 numpy) and the
display encode (linear → sRGB, flipped, 8 bits).
"""

from __future__ import annotations

import math

import numpy as np

KEY_AXES = {"w": ("forward", 1.0), "s": ("forward", -1.0),
            "d": ("right", 1.0), "a": ("right", -1.0),
            " ": ("up", 1.0), "z": ("up", -1.0)}
AMOUNT, SPEED = 5.0, 3.0
SAFE_PITCH = math.pi / 2.0 - 1e-4


def fly(origin, look_at, key: str, dt: float):
    """The camera after one press of a fly key held for ``dt`` seconds →
    (origin, look_at) as float tuples."""
    o = np.asarray(origin, np.float64)
    look = np.asarray(look_at, np.float64)
    direction = look - o
    direction /= max(np.linalg.norm(direction), 1e-12)
    pitch = math.asin(float(np.clip(direction[1], -1.0, 1.0)))
    yaw = math.atan2(float(direction[0]), float(direction[2]))
    axis, sign = KEY_AXES[key]
    amount = sign * AMOUNT
    ys, yc = math.sin(yaw), math.cos(yaw)
    if axis == "forward":
        o = o + np.array([ys, 0.0, yc]) * amount * SPEED * dt
    elif axis == "right":
        o = o + np.array([yc, 0.0, -ys]) * amount * SPEED * dt
    else:
        o[1] += amount * SPEED * dt
    pitch = max(-SAFE_PITCH, min(SAFE_PITCH, pitch))
    look = o + np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch),
                         math.cos(pitch) * math.cos(yaw)])
    return tuple(map(float, o)), tuple(map(float, look))


def to_uint8(linear: np.ndarray) -> np.ndarray:
    """Linear radiance (any shape, last axis RGB) → 8-bit sRGB."""
    x = np.clip(np.asarray(linear, np.float32), 0.0, 1.0)
    srgb = np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)
