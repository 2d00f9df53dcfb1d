"""Thin-lens camera: host-side spec, ray-generation basis, primary rays,
and the fly controller.

Port of ``ray_tracer_tpu.camera``. ``camera_basis`` is host numpy, as in
the reference; ``CameraBasis`` holds its vectors as float32 tensors and
moves with ``.to(device)``. ``camera_basis_tensor`` is its differentiable
twin on tensors (camera-pose recovery). ``CameraController`` and
``update_camera`` are the host-side fly controller of the viewer. Viewport
math:

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
from .utils.bounds import maximum


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


def camera_basis_tensor(origin, look_at, vup=(0.0, 1.0, 0.0),
                        fov: float = 45.0, aspect: float = 1.0,
                        focus_dist=1.0, aperture: float = 0.0) -> CameraBasis:
    """Differentiable twin of ``camera_basis`` (the reference's
    ``camera_basis_jnp``): ``origin``, ``look_at`` and ``focus_dist`` may
    be float32 tensors that require grad, and the basis's vectors carry
    their graph, so ``torch.autograd`` flows from a pixel loss through
    ray generation to the pose (camera recovery by gradient descent).
    ``fov``, ``aspect`` and ``aperture`` stay Python floats. The basis
    lives on ``origin``'s device."""
    origin = torch.as_tensor(origin, dtype=torch.float32)
    dev = origin.device
    look_at = torch.as_tensor(look_at, dtype=torch.float32, device=dev)
    vup = torch.as_tensor(vup, dtype=torch.float32, device=dev)

    theta = math.radians(fov)
    height = 2.0 * math.tan(theta / 2.0)
    width = aspect * height

    def _norm(v):
        return v / maximum(torch.linalg.vector_norm(v), 1e-12)

    w = _norm(origin - look_at)
    u = _norm(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    focus_dist = torch.as_tensor(focus_dist, dtype=torch.float32, device=dev)

    horizontal = focus_dist * width * u
    vertical = focus_dist * height * v
    lower_left = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
    return CameraBasis(
        origin=origin, lower_left=lower_left, horizontal=horizontal,
        vertical=vertical, u=u, v=v, w=w,
        lens_radius=torch.tensor(aperture / 2.0, dtype=torch.float32,
                                 device=dev))


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


# ---------------------------------------------------------------------------
# Fly controller (the reference's src/core/camera.rs:122-165, 167-247).
# Host-side float64 numpy, a copy of the reference's.
# ---------------------------------------------------------------------------

_SAFE_PITCH = math.pi / 2.0 - 1e-4


@dataclasses.dataclass
class CameraController:
    """Input accumulator. A pressed key's amount is 5.0, with speed 3.0
    and sensitivity 0.35, as in the reference."""

    amount_left: float = 0.0
    amount_right: float = 0.0
    amount_forward: float = 0.0
    amount_backward: float = 0.0
    amount_up: float = 0.0
    amount_down: float = 0.0
    rotate_horizontal: float = 0.0
    rotate_vertical: float = 0.0
    scroll: float = 0.0
    speed: float = 3.0
    sensitivity: float = 0.35

    def press(self, key: str, pressed: bool = True) -> bool:
        """Keyboard mapping; returns whether the key was handled."""
        amount = 5.0 if pressed else 0.0
        mapping = {
            "w": "amount_forward", "up": "amount_forward",
            "s": "amount_backward", "down": "amount_backward",
            "a": "amount_left", "left": "amount_left",
            "d": "amount_right", "right": "amount_right",
            "space": "amount_up", "shift": "amount_down",
        }
        attr = mapping.get(key.lower())
        if attr is None:
            return False
        setattr(self, attr, amount)
        return True

    def mouse(self, dx: float, dy: float) -> None:
        self.rotate_horizontal = dx * 3.0
        self.rotate_vertical = dy * 3.0

    def scroll_line_delta(self, lines: float) -> None:
        """A wheel's line steps: ``scroll = -(lines * 10000)``, the
        reference's scale."""
        self.scroll = -(lines * 10000.0)

    def scroll_pixel_delta(self, pixels_y: float) -> None:
        """A touchpad's pixel delta: ``scroll = -pixels``."""
        self.scroll = -float(pixels_y)

    def scroll_by(self, delta: float) -> None:
        """Alias of the pixel path."""
        self.scroll_pixel_delta(delta)


def update_camera(cam: Camera, ctl: CameraController, dt: float) -> Camera:
    """One controller step; returns the moved camera and zeroes the
    controller's scroll and rotation. Pitch is clamped to
    +/-(pi/2 - 1e-4), the reference's deviation D6 (its source clamps
    radians against a degrees constant, which never binds)."""
    o = np.asarray(cam.origin, np.float64)
    look = np.asarray(cam.look_at, np.float64)
    direction = look - o
    direction /= max(np.linalg.norm(direction), 1e-12)
    pitch = math.asin(float(np.clip(direction[1], -1.0, 1.0)))
    yaw = math.atan2(float(direction[0]), float(direction[2]))

    ys, yc = math.sin(yaw), math.cos(yaw)
    forward = np.array([ys, 0.0, yc])
    right = np.array([yc, 0.0, -ys])
    o = o + forward * (ctl.amount_forward - ctl.amount_backward) \
        * ctl.speed * dt
    o = o + right * (ctl.amount_right - ctl.amount_left) * ctl.speed * dt

    ps, pc = math.sin(pitch), math.cos(pitch)
    scrollward = np.array([pc * yc, ps, pc * ys])
    n = np.linalg.norm(scrollward)
    if n > 1e-12:
        scrollward /= n
    o = o - scrollward * ctl.scroll * ctl.speed * ctl.sensitivity * dt
    ctl.scroll = 0.0

    o[1] += (ctl.amount_up - ctl.amount_down) * ctl.speed * dt

    yaw += ctl.rotate_horizontal * ctl.sensitivity * dt
    pitch += -ctl.rotate_vertical * ctl.sensitivity * dt
    ctl.rotate_horizontal = 0.0
    ctl.rotate_vertical = 0.0
    pitch = max(-_SAFE_PITCH, min(_SAFE_PITCH, pitch))

    look_at = o + np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch),
                            math.cos(pitch) * math.cos(yaw)])
    return cam.replace(origin=tuple(map(float, o)),
                       look_at=tuple(map(float, look_at)))
