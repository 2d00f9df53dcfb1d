"""Thin-lens camera: host-side spec, ray-generation basis, primary rays.

Port of ``ray_tracer_tpu.camera`` (without the fly controller, which
belongs to the viewer). ``camera_basis`` is host numpy, as in the
reference; ``CameraBasis`` holds its vectors as float32 tensors and moves
with ``.to(device)``. Viewport math:

    height     = 2 * tan(fov/2),  width = aspect * height
    w, u, v    = view basis from (origin - look_at), vup
    horizontal = focus_dist * width  * u
    vertical   = focus_dist * height * v
    lower_left = origin - horizontal/2 - vertical/2 - focus_dist * w
    lens_radius = aperture / 2
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import sampling


@dataclasses.dataclass
class Camera:
    """Host-side camera spec."""

    origin: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: float = 45.0  # vertical field of view, degrees
    aspect: float = 1.0
    near: float = 0.1
    far: float = 100.0
    aperture: float = 0.0
    focus_dist: float = 1.0

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CameraBasis:
    """Ray-generation basis: (3,) float32 tensors and a 0-d lens radius."""

    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    lens_radius: torch.Tensor

    def to(self, device) -> "CameraBasis":
        return CameraBasis(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v), 1e-12)


def camera_basis(cam: Camera) -> CameraBasis:
    """The ray-generation basis, computed in numpy as the reference does
    (so both packages start from identical float32 vectors)."""
    origin = np.asarray(cam.origin, np.float32)
    look_at = np.asarray(cam.look_at, np.float32)
    vup = np.asarray(cam.vup, np.float32)

    theta = math.radians(cam.fov)
    height = 2.0 * math.tan(theta / 2.0)
    width = cam.aspect * height

    w = _normalize(origin - look_at)
    u = _normalize(np.cross(vup, w))
    v = np.cross(w, u)

    horizontal = (cam.focus_dist * width * u).astype(np.float32)
    vertical = (cam.focus_dist * height * v).astype(np.float32)
    lower_left = (origin - horizontal / 2.0 - vertical / 2.0
                  - cam.focus_dist * w).astype(np.float32)

    t = torch.from_numpy
    return CameraBasis(
        origin=t(origin), lower_left=t(lower_left), horizontal=t(horizontal),
        vertical=t(vertical), u=t(u.astype(np.float32)),
        v=t(v.astype(np.float32)), w=t(w.astype(np.float32)),
        lens_radius=torch.tensor(cam.aperture / 2.0, dtype=torch.float32))


def camera_rays(basis: CameraBasis, pix_x, pix_y, size_wh, state,
                jitter=None):
    """One primary ray per lane.

    Args:
      basis: CameraBasis on the rays' device.
      pix_x, pix_y: integer pixel coordinates (N,); y=0 is the bottom row.
      size_wh: (width, height) Python ints.
      state: (N,) RNG state (sampling module convention).
      jitter: optional (ax, ay) anti-aliasing offsets in [0, 1] from the
        caller (the QMC path, ``renderer.render_pixels``); they replace
        the two AA draws, and the state does not advance for them.

    Returns:
      (state, origins (N, 3), dirs (N, 3)); dirs are unnormalized. The state
      advances by the AA jitter (2 draws, unless ``jitter`` is given) and
      the lens sample (2 draws).
    """
    w, h = size_wh
    if jitter is None:
        state, ax = sampling.uniform(state)
        state, ay = sampling.uniform(state)
    else:
        ax, ay = jitter
    px = (pix_x.to(torch.float32) + ax) / float(w)
    py = (pix_y.to(torch.float32) + ay) / float(h)

    state, disk = sampling.unit_disk(state)
    rd = basis.lens_radius * disk  # (N, 2)
    offset = rd[:, 0:1] * basis.u + rd[:, 1:2] * basis.v

    origins = basis.origin + offset
    dirs = (basis.lower_left
            + px[:, None] * basis.horizontal
            + py[:, None] * basis.vertical
            - origins)
    return state, origins, dirs
