"""Scene arrays made from a configuration's recipe and the run's seed.

Host numpy, the same arrays for the port's ``SceneBuilder`` and for the
plain reference. A recipe's ``kind`` names a module of this package,
``scenes/<kind>.py``, whose ``make(recipe, seed)`` gives the arrays
(``verts``, ``normals``, ``idx``, the mesh's ``albedo`` and
``smoothness``, and ``spheres`` as (centre, radius, albedo, smoothness))
and whose ``SMALL`` holds the recipe's keys at a size a test on the CPU
can hold. A new kind is a new file.
"""

from __future__ import annotations

import importlib

import numpy as np


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of the run's seed (any whole number) and a stream
    number, so that each use of the seed draws apart from the others."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def kind(name: str):
    """The module of the recipe kind ``name``."""
    return importlib.import_module(f"{__name__}.{name}")


def make(recipe: dict, seed: int) -> dict:
    """The arrays of ``recipe`` for ``seed``."""
    return kind(recipe["kind"]).make(recipe, seed)


def port_scene(arrays: dict, device):
    """The port's scene of the arrays, built by its ``SceneBuilder``."""
    import ray_tracer_tpu_torch as rt
    b = rt.SceneBuilder()
    b.add_mesh(arrays["verts"], arrays["normals"], arrays["idx"],
               albedo=arrays["albedo"], smoothness=arrays["smoothness"])
    for centre, radius, albedo, smooth in arrays["spheres"]:
        b.add_sphere(centre, radius, albedo, (0.0, 0.0, 0.0), 0.0, smooth)
    return b.build(device=device)


def port_view(config: dict, W: int, H: int):
    """The port's render settings and camera of a configuration at
    W × H: (RenderParams, Camera)."""
    import ray_tracer_tpu_torch as rt
    cam = config["camera"]
    return (rt.RenderParams(width=W, height=H, **config["render"]),
            rt.Camera(origin=tuple(cam["origin"]),
                      look_at=tuple(cam["look_at"]), fov=float(cam["fov"]),
                      aspect=W / H))
