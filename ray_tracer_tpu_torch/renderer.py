"""Wavefront path tracer: bounce-synchronous trace loop + progressive frames.

Port of ``ray_tracer_tpu.renderer`` (forward rendering without NEE,
Russian roulette or compaction). All rays advance one bounce per step of
a Python loop over ``bounces + 1`` segments: one closest-hit query, then
masked elementwise shading. A ray that misses adds the sky once, on the
segment it dies, and stays dead.

Radiance recurrence per segment:
    incoming   += emission * strength * throughput    (on hit)
    throughput *= albedo                               (on hit; dielectric
                                                        forces white)
    incoming   += env(d) * throughput                  (on miss, skybox on)

Progressive accumulation:
    frame >= 1:  image = image * (1 - w) + frame_img * w,  w = 1/(frame + 1)
    else:        image = frame_img

Everything runs on the scene's device; the camera basis is moved there.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import materials, sampling
from .camera import Camera, CameraBasis, camera_basis, camera_rays
from .envlight import environment_light
from .ops.intersect import intersect, resolve_backend
from .scene import Scene
from .utils.bounds import minimum
from .utils.config import RenderParams


def resolved_backend(params: RenderParams, scene: Scene) -> str:
    return resolve_backend(params.backend, scene.device)


def check_supported(params: RenderParams) -> None:
    """Raise NotImplementedError, naming the feature, for every switched-on
    knob whose feature is not ported yet."""
    for name, on in (("nee", params.nee),
                     ("compaction", params.compaction),
                     ("rr_start", params.rr_start),
                     ("qmc", params.qmc),
                     ("remat", params.remat)):
        if on:
            raise NotImplementedError(f"RenderParams.{name} is not ported "
                                      f"yet")


def trace(scene: Scene, o, d, state, params: RenderParams):
    """Trace a wavefront of rays to completion.

    Args:
      scene: Scene.
      o, d: (R, 3) ray origins / (unnormalized) directions.
      state: (R,) RNG state.
      params: RenderParams.

    Returns: (state, radiance (R, 3)).
    """
    check_supported(params)
    backend = resolved_backend(params, scene)
    if params.coherent_scatter:
        share = params.coherent_tile or materials.DEFAULT_SHARE_TILE
    else:
        share = 0
    throughput = torch.ones_like(o)
    incoming = torch.zeros_like(o)
    alive = torch.ones(o.shape[:1], dtype=torch.bool, device=o.device)
    for _ in range(params.bounces + 1):
        h = intersect(scene, o, d, t_min=params.t_min, backend=backend,
                      alive=alive)
        active_hit = (alive & h.hit)[:, None]
        active_miss = (alive & ~h.hit)[:, None]

        # scatter every lane (branchless); only active-hit lanes keep it
        state, new_dir, is_dielectric = materials.scatter(
            state, d, h.normal, h.smoothness,
            cosine_sampling=params.cosine_sampling, share_tile=share)
        albedo = torch.where(is_dielectric[:, None], 1.0, h.albedo)

        emitted = h.emission * h.emission_strength[:, None]
        incoming = incoming + torch.where(active_hit, emitted * throughput,
                                          0.0)
        throughput = torch.where(active_hit, throughput * albedo, throughput)
        if params.skybox:
            incoming = incoming + torch.where(
                active_miss, environment_light(d) * throughput, 0.0)

        o = torch.where(active_hit, h.point, o)
        d = torch.where(active_hit, new_dir, d)
        alive = active_hit[:, 0]
    return state, incoming


def render_pixels(scene: Scene, basis: CameraBasis, params: RenderParams,
                  frame_index: int, pixel_ids):
    """Render flat pixel ids (y * W + x, y=0 bottom row) → (N, 3)."""
    check_supported(params)
    W, H = params.width, params.height
    x = pixel_ids % W
    y = pixel_ids // W
    state = sampling.seed_state(pixel_ids, abs(int(frame_index)))
    total = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                        device=pixel_ids.device)
    for _ in range(params.rays_per_pixel):
        state, o, d = camera_rays(basis, x, y, (W, H), state)
        state, rad = trace(scene, o, d, state, params)
        if params.clamp > 0.0:
            rad = minimum(rad, params.clamp)  # firefly suppression
        total = total + rad
    return total / float(params.rays_per_pixel)


@functools.lru_cache(maxsize=16)
def _blocked_order(W: int, H: int, bw: int = 16, bh: int = 8):
    """(order, inverse): pixel ids permuted so each run of 128 consecutive
    rays is a compact 16×8 pixel block instead of a scanline strip (tight
    ray groups cull better in the closest-hit kernel and share coherent
    scatter draws over compact regions). Host numpy, cached."""
    ys, xs = np.mgrid[0:H, 0:W]
    key = ((ys // bh) * (-(-W // bw)) + (xs // bw)) * (bw * bh) \
        + (ys % bh) * bw + (xs % bw)
    order = np.argsort(key.reshape(-1), kind="stable")
    inverse = np.argsort(order, kind="stable")
    return order, inverse


@functools.lru_cache(maxsize=16)
def _blocked_ids(W: int, H: int, device: torch.device):
    """_blocked_order as int64 tensors on ``device``, cached."""
    order, inverse = _blocked_order(W, H)
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(inverse).to(device))


def _unblock_image(img_flat, W: int, H: int, bw: int = 16, bh: int = 8):
    """Inverse of the blocked pixel order as reshape + permute (needs
    W % bw == H % bh == 0; render_frame gathers otherwise)."""
    return (img_flat.reshape(H // bh, W // bw, bh, bw, 3)
            .permute(0, 2, 1, 3, 4).reshape(H * W, 3))


def render_frame(scene: Scene, basis: CameraBasis, params: RenderParams,
                 frame_index: int):
    """One full frame → (H, W, 3) linear radiance, row 0 = bottom.

    Pixels go out in the blocked order whenever the kernel runs or
    coherent scatter is on (the same rule as the reference, so both
    packages put the same pixels in the same share tiles). With
    ``params.chunk_pixels > 0`` the frame is traced in sequential pixel
    chunks."""
    check_supported(params)
    device = scene.device
    basis = basis.to(device)
    W, H = params.width, params.height
    n = H * W
    blocked = (resolved_backend(params, scene) == "cuda"
               or params.coherent_scatter)
    if blocked:
        pixel_ids, inverse = _blocked_ids(W, H, device)
    else:
        pixel_ids = torch.arange(n, dtype=torch.int64, device=device)
    chunk = params.chunk_pixels
    if chunk and chunk < n:
        if n % chunk:
            # pad to whole chunks; surplus lanes repeat the last pixel
            pixel_ids = torch.cat([pixel_ids, pixel_ids.new_full(
                (chunk - n % chunk,), n - 1)])
        img = torch.cat([
            render_pixels(scene, basis, params, frame_index, ids)
            for ids in pixel_ids.split(chunk)])[:n]
    else:
        img = render_pixels(scene, basis, params, frame_index, pixel_ids)
    if blocked:
        if W % 16 == 0 and H % 8 == 0:
            img = _unblock_image(img, W, H)
        else:
            img = img[inverse]  # back to raster order
    return img.reshape(H, W, 3)


def render_aov(*args, **kwargs):
    raise NotImplementedError("render_aov is not ported yet")


def render_adaptive(*args, **kwargs):
    raise NotImplementedError("render_adaptive is not ported yet")


def accumulate(prev, frame_img, frame_index: int):
    """Progressive blend: w = 1/(frame + 1) in float32."""
    if frame_index < 1:
        return frame_img
    one = torch.tensor(1.0, dtype=torch.float32, device=frame_img.device)
    w = one / (float(frame_index) + one)
    return prev * (1.0 - w) + frame_img * w


def render_progressive(scene: Scene, basis: CameraBasis, params: RenderParams,
                       frames: int, start_frame: int = 0, image0=None):
    """``frames`` progressive frames from ``start_frame``, accumulated on the
    scene's device → (H, W, 3). Equal to ``render_frame`` + ``accumulate``
    per frame; ``image0`` continues an earlier accumulation."""
    H, W = params.height, params.width
    img = (torch.zeros((H, W, 3), dtype=torch.float32, device=scene.device)
           if image0 is None else image0)
    for k in range(frames):
        f = start_frame + k
        img = accumulate(img, render_frame(scene, basis, params, f), f)
    return img


class Renderer:
    """Progressive renderer with the reference's frame-counter semantics.

    >>> r = Renderer(scene, camera, RenderParams(width=256, height=256))
    >>> for _ in range(16): r.step()
    >>> img = r.image   # (H, W, 3) linear, accumulated
    """

    def __init__(self, scene: Scene, camera: Camera, params: RenderParams):
        self.scene = scene
        self.camera = camera.replace(aspect=params.aspect)
        self.params = params
        self.frames = -1
        self._image: Optional[torch.Tensor] = None
        self._basis = camera_basis(self.camera)

    def clear_accumulation(self):
        """frames = -1: the next step overwrites the image."""
        self.frames = -1

    def set_camera(self, camera: Camera):
        self.camera = camera.replace(aspect=self.params.aspect)
        self._basis = camera_basis(self.camera)
        self.clear_accumulation()

    def set_scene(self, scene: Scene):
        self.scene = scene
        self.clear_accumulation()

    def set_params(self, params: RenderParams):
        self.params = params
        # a resolution change also changes the aspect in the basis
        self.camera = self.camera.replace(aspect=params.aspect)
        self._basis = camera_basis(self.camera)
        self._image = None
        self.clear_accumulation()

    def step(self) -> torch.Tensor:
        """Render one frame and blend it in; returns the accumulated image."""
        if self.params.accumulate:
            self.frames += 1
        frame_img = render_frame(self.scene, self._basis, self.params,
                                 self.frames)
        if self._image is None or self.frames < 1:
            self._image = frame_img
        else:
            self._image = accumulate(self._image, frame_img, self.frames)
        return self._image

    @property
    def image(self) -> torch.Tensor:
        if self._image is None:
            self.step()
        return self._image


def render(scene: Scene, camera: Camera, params: RenderParams,
           frames: int = 1) -> torch.Tensor:
    """Render ``frames`` progressive frames → accumulated (H, W, 3)."""
    r = Renderer(scene, camera, params)
    for _ in range(max(1, frames)):
        img = r.step()
    return img
