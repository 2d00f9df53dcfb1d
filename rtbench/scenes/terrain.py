"""The ``terrain`` recipe: the heightfield of ``chip_smoke.heightfield`` (a
few random cosine waves over an n × n grid, 2 (n - 1)^2 triangles, wound
to face up) with the metal scene's three spheres resting on it, as
``chip_smoke.terrain_scene`` builds it. The waves' directions, lengths
and heights come from the recipe's ``wave_seed`` (0: chip_smoke's
terrain); the run's seed moves only their phases, so every seed has the
same sizes and the same kind of surface, shifted.
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes import seed_rng

# the recipe's keys at a size a test on the CPU can hold
SMALL = {"n": 12}


def heightfield(n, extent, y0, waves, rng, shift=None):
    """(verts, normals, idx) of (n - 1)^2 * 2 smooth terrain triangles over
    [-extent, extent]^2, wound to face -y. Each wave's phase moves by
    ``shift[k]`` (none where None)."""
    xs = np.linspace(-extent, extent, n)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    h = np.zeros_like(gx)
    for k in range(waves):
        kx, kz = rng.normal(size=2) * (2.5 / extent)
        amp, phase = rng.random(), rng.random() * 6.28
        if shift is not None:
            phase += shift[k]
        h += amp * np.cos(kx * gx + kz * gz + phase)
    h = y0 + h * (extent * 0.02)
    verts = np.stack([gx, h, gz], -1).reshape(-1, 3)
    dhdx = np.gradient(h, xs, axis=0)
    dhdz = np.gradient(h, xs, axis=1)
    nrm = np.stack([-dhdx, np.ones_like(h), -dhdz], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = (i[:-1, :-1].ravel(), i[1:, :-1].ravel(),
                  i[:-1, 1:].ravel(), i[1:, 1:].ravel())
    idx = np.concatenate([np.stack([a, b, c], -1),
                          np.stack([b, d, c], -1)]).reshape(-1)
    return verts, nrm.reshape(-1, 3), idx


def make(recipe: dict, seed: int) -> dict:
    """The terrain recipe's arrays: ``verts``, ``normals``, ``idx`` (wound
    to face the camera above), the mesh's ``albedo`` and ``smoothness``,
    and ``spheres`` as (centre, radius, albedo, smoothness), each resting
    on the surface below it."""
    n = int(recipe["n"])
    waves = int(recipe["waves"])
    verts, normals, idx = heightfield(
        n, float(recipe["extent"]), float(recipe["y0"]), waves,
        np.random.default_rng(int(recipe["wave_seed"])),
        seed_rng(seed, 0).random(waves) * 2.0 * np.pi)
    idx = idx.reshape(-1, 3)[:, ::-1].reshape(-1)
    spheres = []
    r = float(recipe["sphere_radius"])
    for s in recipe["spheres"]:
        x = float(s["x"])
        near = (np.hypot(verts[:, 0] - x, verts[:, 2])
                <= r + 2.0 * float(recipe["extent"]) / (n - 1))
        y = float(verts[near, 1].max()) + r
        spheres.append(((x, y, 0.0), r, tuple(s["albedo"]),
                        float(s["smoothness"])))
    return dict(verts=verts.astype(np.float32),
                normals=normals.astype(np.float32), idx=idx,
                albedo=tuple(recipe["albedo"]),
                smoothness=float(recipe["smoothness"]), spheres=spheres)
