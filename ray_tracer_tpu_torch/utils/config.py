"""Render configuration.

Same fields, defaults and validation as ``ray_tracer_tpu.utils.config``, so
a configuration reads the same in both packages. Only ``backend`` takes the
port's own values:

  * ``"auto"``  — ``"cuda"`` when the scene's tensors live on a CUDA device,
    ``"torch"`` otherwise;
  * ``"torch"`` — the plain PyTorch intersection oracle (brute force, on
    whatever device the scene lives on);
  * ``"cuda"``  — the hand-written closest-hit kernel
    (``ops/closest_hit.py``); raises on CPU tensors.

Knobs whose feature is not ported yet (``nee``, ``compaction``,
``rr_start``, ``qmc``, ``remat``) keep their fields so a configuration
round-trips, but the renderer raises ``NotImplementedError`` when one is
switched on (see ``renderer.check_supported``).
"""

from __future__ import annotations

import dataclasses

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static render parameters (hashable, immutable)."""

    width: int = 800
    height: int = 800
    # bounces + 1 ray segments per sample (the reference's inclusive loop)
    bounces: int = 3
    # samples per pixel per frame, averaged
    rays_per_pixel: int = 1
    # procedural sky light on miss
    skybox: bool = False
    # progressive accumulation (Renderer frame-counter semantics)
    accumulate: bool = True
    # self-intersection epsilon
    t_min: float = 1e-4
    # intersection backend: "auto" | "torch" | "cuda" (module docstring)
    backend: str = "auto"
    # trace the frame in chunks of this many pixels (0 = whole frame);
    # bounds the rays x primitives working set of the "torch" backend
    chunk_pixels: int = 0
    # not ported: wavefront compaction (False | True | "octant" | "morton")
    compaction: object = False
    # not ported: next-event estimation and its knobs
    nee: bool = False
    nee_smoothness_cutoff: float = 1.0
    mis: bool = True
    # not ported: low-discrepancy (R2) anti-aliasing
    qmc: bool = False
    # not ported: Russian roulette from this segment index (0 = off)
    rr_start: int = 0
    # not ported: backward-pass rematerialization
    remat: bool = False
    # firefly clamp on each sample's radiance (0 = off)
    clamp: float = 0.0
    # coherent path tracing: each share tile of rays shares one
    # unit-sphere draw for the diffuse lobe (materials.scatter)
    coherent_scatter: bool = False
    # share tile width; 0 = materials.DEFAULT_SHARE_TILE (512)
    coherent_tile: int = 128
    # cosine-weighted instead of uniform-hemisphere diffuse sampling
    cosine_sampling: bool = False

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.bounces < 0:
            raise ValueError("bounces must be >= 0")
        if self.rays_per_pixel < 1:
            raise ValueError("rays_per_pixel must be >= 1")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.compaction not in (False, True, "octant", "morton"):
            raise ValueError(f"unknown compaction {self.compaction!r}")
        if self.coherent_tile < 0:
            raise ValueError("coherent_tile must be >= 0 (0 = default tile)")
        if self.clamp < 0:
            raise ValueError("clamp must be >= 0 (0 = off)")

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)
