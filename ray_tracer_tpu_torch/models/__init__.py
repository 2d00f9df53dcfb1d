"""Model zoo: built-in scenes and model files as ready-to-render setups.

Port of ``ray_tracer_tpu.models``: ``scene(name)`` returns any built-in
scene, and ``asset(path)`` builds a renderable scene and a camera framing
its bounds from any model file the loaders read. Both build on the card
unless the caller passes ``device="cpu"``.

>>> from ray_tracer_tpu_torch import models
>>> scene, cam = models.scene("room")
>>> scene, cam = models.asset("assets/the_utah_teapot.glb")
"""

from __future__ import annotations

import numpy as np

from ..camera import Camera
from ..io import load_model
from ..scene import BUILTIN_SCENES, SCENE_IDS, SceneBuilder, builtin_scene

__all__ = ["scene", "asset", "BUILTIN_SCENES", "SCENE_IDS"]


def scene(name_or_id, aspect: float = 1.0, **kw):
    """Built-in scene by name ('balls', 'random_balls', 'room', 'metal')
    or upstream scene id 0-3."""
    return builtin_scene(name_or_id, aspect=aspect, **kw)


def asset(path: str, aspect: float = 1.0, albedo=(0.2, 0.2, 1.0),
          smoothness: float = 0.5, skirt=0.7, device="cuda"):
    """Load a model file into a scene with a camera framing its bounds.

    The default material is the upstream loaders' hardcoded one (colour
    (0.2, 0.2, 1.0), specular 0.5)."""
    b = SceneBuilder()
    load_model(path, b, placement="origin", albedo=tuple(albedo),
               smoothness=smoothness)
    lo, hi = b.bounds()
    s = b.build(device=device)
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    cam = Camera(origin=tuple(center + extent * np.array([skirt, 0.4, skirt])),
                 look_at=tuple(center), aspect=aspect, focus_dist=1.0)
    return s, cam
