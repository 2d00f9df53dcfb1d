"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Both packages build the same scenes from the same numpy inputs; the port
takes the reference's scene leaves through ``scene_from_numpy`` where a
test needs both to compute on identical data.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt


@pytest.fixture(scope="module")
def one_thread():
    """Run a module's tests on one intra-op thread, then restore the count.
    Their tensors are small and their ops many: under the suite's parallel
    workers, every worker's thread pool on every core costs them ~30× in
    scheduling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def heightfield(n, extent, y0, rng):
    """(n-1)^2 * 2 smooth terrain triangles over [-extent, extent]^2
    (the procedural mesh of tools/bench_blocked.py)."""
    xs = np.linspace(-extent, extent, n)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    h = np.zeros_like(gx)
    for _ in range(6):  # a few random cosine waves
        kx, kz = rng.normal(size=2) * (2.5 / extent)
        h += rng.random() * np.cos(kx * gx + kz * gz + rng.random() * 6.28)
    h = y0 + h * (extent * 0.02)
    verts = np.stack([gx, h, gz], -1).reshape(-1, 3)
    dhdx = np.gradient(h, xs, axis=0)
    dhdz = np.gradient(h, xs, axis=1)
    nrm = np.stack([-dhdx, np.ones_like(h), -dhdz], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normals = nrm.reshape(-1, 3)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = (i[:-1, :-1].ravel(), i[1:, :-1].ravel(),
                  i[:-1, 1:].ravel(), i[1:, 1:].ravel())
    idx = np.concatenate([np.stack([a, b, c], -1),
                          np.stack([b, d, c], -1)]).reshape(-1)
    return verts, normals, idx


def cpu(pkg):
    """Keyword arguments that build ``pkg``'s scene on the CPU: the port's
    builders default to the card, the reference's take no device."""
    return {"device": "cpu"} if pkg is trt else {}


# terrain_nee's emitters: a 2x2 quad high above the terrain with the room
# scene's ceiling-light material (white, strength 10.5), wound so that its
# geometric normal faces down at the terrain, and one small warm sphere
LIGHT_QUAD = np.array([(-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1)],
                      np.float32)
LIGHT_QUAD_INDICES = [0, 1, 2, 0, 2, 3]
LIGHT_SPHERE = ((2.0, 0.2, -1.5), 0.25, (1.0, 0.8, 0.6), 20.0)


def add_lights(b):
    """The two emitters of terrain_nee, added to builder ``b``."""
    b.add_mesh(LIGHT_QUAD, [(0.0, -1.0, 0.0)] * 4, LIGHT_QUAD_INDICES,
               albedo=(1.0, 1.0, 1.0), emission=(1.0, 1.0, 1.0),
               emission_strength=10.5, smoothness=0.0)
    center, radius, emission, strength = LIGHT_SPHERE
    b.add_sphere(center, radius, (1.0, 1.0, 1.0), emission, strength, 0.0)


def texture_images(res, seed=0):
    """(albedo, normal map), each (res, res, 3) uint8: a seeded two-colour
    checker of 8x8 cells times a left-to-right ramp, and the tangent-space
    normals of a periodic heightfield's slopes encoded as (n + 1) / 2 (the
    textures of chip_smoke.py's terrain_tex at res=512)."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    cell = max(res // 8, 1)
    colours = 0.3 + 0.6 * rng.random((2, 3))
    ramp = 0.4 + 0.6 * j / max(res - 1, 1)
    albedo = colours[(i // cell + j // cell) % 2] * ramp[..., None]
    # h(u, v) = a cos(2 pi (2 u + p)) + b cos(2 pi (3 v + q)), u = j / res
    a, b, p, q = 0.05, 0.04, rng.random(), rng.random()
    dh_du = -a * 4 * np.pi * np.sin(2 * np.pi * (2 * j / res + p))
    dh_dv = -b * 6 * np.pi * np.sin(2 * np.pi * (3 * i / res + q))
    nrm = np.stack([-dh_du, -dh_dv, np.ones_like(dh_du)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    to_u8 = (lambda x: np.clip(np.round(x * 255), 0, 255).astype(np.uint8))
    return to_u8(albedo), to_u8((nrm + 1) / 2)


TEX_REPEATS = 8   # the textured terrain's UVs span [-8, 8]: repeat wrap


def terrain(pkg, n=12, aspect=1.0, lights=False, textured=False,
            texture_resolution=16):
    """Terrain scene in package ``pkg`` (either package): a heightfield of
    2 (n-1)^2 triangles with glass, diffuse and glossy spheres resting on
    it, and with ``lights`` terrain_nee's two emitters (``add_lights``).
    With ``textured`` (terrain_tex) the heightfield carries UVs u = x / 4 *
    8, v = z / 4 * 8 and ``texture_images``' albedo (sRGB) and normal map
    at ``texture_resolution``; the spheres and lights stay untextured.
    Returns (scene, camera)."""
    verts, normals, idx = heightfield(n, 4.0, -1.0, np.random.default_rng(0))
    # heightfield's winding faces -y and the intersection culls back faces:
    # reverse it so the terrain faces the camera above it
    idx = idx.reshape(-1, 3)[:, ::-1].reshape(-1)
    b = pkg.SceneBuilder(texture_resolution=texture_resolution)
    tex = {}
    if textured:
        albedo_map, normal_map = texture_images(texture_resolution)
        tex = dict(uvs=verts[:, [0, 2]] / 4.0 * TEX_REPEATS,
                   tex=b.add_texture(albedo_map, srgb=True),
                   normal_tex=b.add_texture(normal_map, srgb=False))
    b.add_mesh(verts, normals, idx, albedo=(0.7, 0.5, 0.3), smoothness=0.3,
               **tex)
    for x, albedo, smooth in ((-1.2, (0.8, 0.8, 0.8), -1.0),
                              (0.0, (0.7, 0.3, 0.3), 0.0),
                              (1.2, (0.8, 0.6, 0.2), 0.15)):
        # rest on the highest terrain vertex within reach of the sphere
        near = np.hypot(verts[:, 0] - x, verts[:, 2]) <= 0.5 + 8.0 / (n - 1)
        y = float(verts[near, 1].max()) + 0.5
        b.add_sphere((x, y, 0.0), 0.5, albedo, (0.0, 0.0, 0.0), 0.0, smooth)
    if lights:
        add_lights(b)
    cam = pkg.Camera(origin=(0.0, 1.5, 6.0), look_at=(0.0, -0.8, 0.0),
                     fov=45.0, aspect=aspect)
    return b.build(**cpu(pkg)), cam


def mesh80(pkg):
    """80 random triangles with random materials (as tests/test_fused.py)."""
    rng = np.random.default_rng(5)
    b = pkg.SceneBuilder()
    for t in rng.normal(size=(80, 3, 3)) * 4:
        b.add_mesh(t, rng.normal(size=(3, 3)), [0, 1, 2],
                   albedo=tuple(rng.random(3)),
                   emission=tuple(rng.random(3)),
                   emission_strength=float(rng.random()),
                   smoothness=float(rng.random()))
    cam = pkg.Camera(origin=(0.0, 0.0, 12.0), look_at=(0.0, 0.0, 0.0))
    return b.build(**cpu(pkg)), cam


def scene_pair(name, aspect=1.0):
    """(jax scene, port scene, jax camera) for a scene name; the port's
    scene is the reference's, carried across as numpy."""
    if name.startswith("terrain"):
        js, cam = terrain(jrt, aspect=aspect, lights="nee" in name,
                          textured="tex" in name)
    elif name == "mesh80":
        js, cam = mesh80(jrt)
    else:
        js, cam = jrt.builtin_scene(name, aspect=aspect)
    return js, to_port(js), cam


def to_port(jax_scene):
    return trt.scene_from_numpy(
        {k: np.asarray(v) for k, v in dataclasses.asdict(jax_scene).items()},
        device="cpu")


def probe_rays(cam, n, seed):
    """n rays: half through random points of the camera's image plane,
    half with random origins and directions. float32 numpy (o, d)."""
    rng = np.random.default_rng(seed)
    basis = jrt.camera_basis(cam)
    k = n // 2
    px, py = rng.random((2, k)).astype(np.float32)
    d_cam = (basis.lower_left + px[:, None] * basis.horizontal
             + py[:, None] * basis.vertical - basis.origin)
    o_cam = np.broadcast_to(basis.origin, d_cam.shape)
    o_rnd = rng.normal(size=(n - k, 3)) * 5
    d_rnd = rng.normal(size=(n - k, 3))
    o = np.concatenate([o_cam, o_rnd]).astype(np.float32)
    d = np.concatenate([d_cam, d_rnd]).astype(np.float32)
    return o, d


def tied(ts, n):
    """Port scene ``ts`` with triangles [n, 2n) made copies of [0, n): a
    ray that hits one of a pair hits the other at the same t. With n = 512
    the copies lie in the next super (8 clusters of 64), with n = 1024 in
    the next 1024-triangle block."""
    fields = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)}
    for k, v in fields.items():
        if k.startswith("tri_") and isinstance(v, torch.Tensor):
            v = v.clone()
            v[n:2 * n] = v[0:n]
            fields[k] = v
    return dataclasses.replace(ts, **fields)


def secondary_rays(ts, n, seed):
    """n rays as a bounce leaves them: origins uniform inside the bounds of
    the scene's real triangles (of its spheres where it has none), random
    directions. float32 numpy (o, d)."""
    rng = np.random.default_rng(seed)
    if ts.num_tris:
        pts = torch.cat([ts.tri_v0[:ts.num_tris], ts.tri_v1[:ts.num_tris],
                         ts.tri_v2[:ts.num_tris]]).cpu().numpy()
    else:
        pts = ts.sphere_center[:ts.num_spheres].cpu().numpy()
    lo, hi = pts.min(0), pts.max(0)
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    return o, rng.normal(size=(n, 3)).astype(np.float32)


def frac_off(a, b, tol=2e-2):
    """Fraction of pixels whose largest channel difference exceeds tol
    (the reference's image parity gate, bench.py section_parity)."""
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > tol).mean())


def t_(x):
    """numpy (or jax) array → CPU tensor over a writable copy."""
    return torch.from_numpy(np.array(x))


def test_terrain_faces_the_camera_and_has_bench_size():
    """The terrain's triangles face +y (towards the camera above it), its
    spheres rest on it, and at n=90 it has the 15,842 triangles of the
    chip smoke run's terrain."""
    verts, _, idx = heightfield(90, 4.0, -1.0, np.random.default_rng(0))
    assert idx.size // 3 == 15_842
    scene, cam = terrain(trt)
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    ny = (e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2])[:scene.num_tris]
    assert bool((ny > 0).all())
    top = scene.tri_v0[:scene.num_tris, 1].max()
    assert bool((scene.sphere_center[:3, 1] - 0.5 >= scene.tri_v0[
        :scene.num_tris, 1].min()).all()) and float(top) < 0.0


def test_terrain_nee_lights_face_the_terrain():
    """terrain_nee's quad faces down (its geometric normal e1 x e2 has
    y < 0), so its light reaches the terrain below, and its sphere glows."""
    scene, _ = terrain(trt, lights=True)
    quad = (scene.tri_emission_strength > 0).nonzero()[:, 0]
    assert quad.numel() == 2
    e1 = scene.tri_v1[quad] - scene.tri_v0[quad]
    e2 = scene.tri_v2[quad] - scene.tri_v0[quad]
    assert bool(((e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]) < 0).all())
    assert int((scene.sphere_emission_strength > 0).sum()) == 1
    assert scene.num_spheres == 4 and scene.num_tris == 244


def test_probe_rays_are_half_camera_half_random():
    _, cam = terrain(jrt)
    o, d = probe_rays(cam, 10, seed=0)
    assert o.shape == d.shape == (10, 3) and o.dtype == np.float32
    np.testing.assert_array_equal(o[:5], np.broadcast_to(
        np.asarray(cam.origin, np.float32), (5, 3)))
