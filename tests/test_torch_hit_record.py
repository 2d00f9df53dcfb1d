"""The hit-record kernels (``ops/hit_record.py``, ``csrc/hit_record.cu``):
the winner recompute from merged-table rows and its vector-Jacobian
product, held to the plain ``intersect.hit_attributes_from_rows`` and to
autograd through it.

On the CPU: which path serves which call (the kernels never run there:
the "torch" backend, CPU tensors and textured rows keep the plain
version) and the wrappers' refusal of CPU tensors. On the card
(``cuda``): the forward bit-equal to the plain version on lanes of every
kind, the VJP against ``torch.autograd.grad`` of the plain version, and a
64x64 training step of the 15,842-triangle terrain through both paths,
with and without remat.

Tolerance of the VJP: rtol 1e-5 with an absolute floor of 2e-4 x the
largest cotangent. The kernel evaluates autograd's derivatives in double
at the forward's float values; autograd rounds each step to float32, and
on grazing triangle hits (|cos| ~ 0.07, t ~ 9) its chain through 1/det^2
cancels: on 4,100 lanes of six seeds of these rays the largest gap beyond
rtol was 4.8e-5 x the largest cotangent, on the rows' cotangent (1.9e-6 on
o, 6.7e-6 on d), with the kernel's host build against CPU autograd.
This file imports no JAX.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch.ops import closest_hit as tch
from ray_tracer_tpu_torch.ops import hit_record as thr
from ray_tracer_tpu_torch.ops import intersect as tint

FIELDS = ("t", "point", "normal", "albedo", "emission", "emission_strength",
          "smoothness")
RTOL, FLOOR = 1e-5, 2e-4
# the terrain's camera and the main path's settings (bounces 3, one ray
# per pixel, the sky, coherent scatter)
ORIGIN, LOOK_AT, FOV = (0.0, 1.5, 6.0), (0.0, -0.8, 0.0), 45.0
RENDER = dict(bounces=3, rays_per_pixel=1, skybox=True,
              coherent_scatter=True, coherent_tile=0, backend="auto")
SMALL_N = 12   # the terrain's grid where a test runs on the CPU


def _terrain(device, n=90):
    """A heightfield of 2 (n - 1)^2 triangles (15,842 at n = 90) over
    [-4, 4]^2 at height -1, six cosine waves drawn from seed 0, wound to
    face the camera above it, with a glass, a diffuse and a glossy sphere
    of radius 0.5 resting on it."""
    rng = np.random.default_rng(0)
    xs = np.linspace(-4.0, 4.0, n)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    h = np.zeros_like(gx)
    for _ in range(6):
        kx, kz = rng.normal(size=2) * (2.5 / 4.0)
        h += rng.random() * np.cos(kx * gx + kz * gz + rng.random() * 6.28)
    h = -1.0 + h * (4.0 * 0.02)
    verts = np.stack([gx, h, gz], -1).reshape(-1, 3)
    nrm = np.stack([-np.gradient(h, xs, axis=0), np.ones_like(h),
                    -np.gradient(h, xs, axis=1)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = (i[:-1, :-1].ravel(), i[1:, :-1].ravel(),
                  i[:-1, 1:].ravel(), i[1:, 1:].ravel())
    idx = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    idx = idx[:, ::-1]   # faces +y, towards the camera
    builder = rt.SceneBuilder()
    builder.add_mesh(verts, nrm.reshape(-1, 3), idx.reshape(-1),
                     albedo=(0.7, 0.5, 0.3), smoothness=0.3)
    for x, albedo, smooth in ((-1.2, (0.8, 0.8, 0.8), -1.0),
                              (0.0, (0.7, 0.3, 0.3), 0.0),
                              (1.2, (0.8, 0.6, 0.2), 0.15)):
        near = np.hypot(verts[:, 0] - x, verts[:, 2]) <= 0.5 + 8.0 / (n - 1)
        y = float(verts[near, 1].max()) + 0.5
        builder.add_sphere((x, y, 0.0), 0.5, albedo, (0.0, 0.0, 0.0), 0.0,
                           smooth)
    return builder.build(device=device)


def _rays(R, seed, device):
    """Half camera rays spread over the view, half random rays from above
    the surface (secondary rays), 80% of them live."""
    rng = np.random.default_rng(seed)
    cam, look = np.array(ORIGIN), np.array(LOOK_AT)
    h = R // 2
    o = np.r_[cam + 0.05 * rng.standard_normal((h, 3)),
              rng.uniform([-3, -0.5, -3], [3, 0.8, 3], (R - h, 3))]
    d = np.r_[(look - cam) + 2.5 * rng.standard_normal((h, 3))
              * [1.0, 0.4, 1.0], rng.standard_normal((R - h, 3))]
    alive = torch.from_numpy(rng.random(R) < 0.8).to(device)
    return (torch.tensor(o, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device), alive)


def _lanes(device, R=4096, seed=0):
    """(scene, rows, o, d, prim_id, miss) of every kind of lane: the
    closest-hit kernel's sphere and triangle hits, misses and dead lanes
    (id 0, zero rows), then four made rows: a sphere its ray passes by
    (disc <= 0), a triangle with |det| < 1e-20, one whose vertex normals
    blend to zero, and a miss with id 0."""
    scene = _terrain(device)
    o, d, alive = _rays(R, seed, device)
    t, ids, rows = tch.nearest_hit_attrs(scene, o, d, 1e-4, alive)
    S = scene.padded_spheres
    made = [  # (row, id, miss)
        ([5.0, 5.0, 5.0, 0.25, 0.5, 0.5, 0.5, 0.1, 0.2, 0.3, 1.0, 0.4], 0,
         False),
        ([0.0, 0.0, 0.0, 1e-11, 0.0, 0.0, 0.0, 0.0, 1e-11] + [0.0] * 9
         + [0.3] * 8, S, False),
        ([-1.0, -1.0, -1.0, 3.0, 0.0, 0.0, 0.0, 0.0, 3.0] + [0.0] * 9
         + [0.3] * 8, S, False),
        ([], 0, True)]
    extra = torch.zeros((26, len(made)))
    for k, (row, _, _) in enumerate(made):
        extra[:len(row), k] = torch.tensor(row)
    k = len(made)
    rows = torch.cat([rows, extra.to(device)], 1)
    ids = torch.cat([ids, torch.tensor([m[1] for m in made],
                                       dtype=torch.int32, device=device)])
    miss = torch.cat([torch.isinf(t), torch.tensor([m[2] for m in made],
                                                   device=device)])
    o = torch.cat([o, torch.tensor([[0.0, 1.0, 5.0]] * k, device=device)])
    d = torch.cat([d, torch.tensor([[0.1, -0.3, -1.0]] * k, device=device)])
    hit = ~miss[:R]
    assert int((hit & (ids[:R] < S)).sum()) > 50          # sphere hits
    assert int((hit & (ids[:R] >= S)).sum()) > 500        # triangle hits
    assert int((~hit & alive).sum()) > 50                 # live misses
    assert not bool(hit[~alive].any())                    # dead lanes miss
    return scene, rows, o, d, ids, miss


def _count():
    return thr.hit_record.launches, thr.hit_record_vjp.launches


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_torch_backend_and_cpu_tensors_never_reach_the_kernels():
    """The "torch" backend's intersect and fused_intersect on CPU tensors,
    forward and backward, take the plain recompute: neither wrapper runs,
    and the fused path equals the plain one."""
    scene = _terrain("cpu", SMALL_N)
    o, d, alive = _rays(256, 1, "cpu")
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ("sphere_center", "tri_v0", "tri_albedo")}
    s = dataclasses.replace(scene, **leaves)
    before = _count()
    for h in (tint.intersect(s, o, d, backend="torch"),
              tint.fused_intersect(s, o, d, 1e-4, None)):
        loss = torch.where(h.hit[:, None], h.normal + h.albedo, 0.0).sum()
        torch.autograd.grad(loss, list(leaves.values()))
    rows, ids, miss = tint._winner_rows(scene, o, d, 1e-4, alive)
    assert not thr.takes(rows)
    got = tint.fused_intersect(scene, o, d, 1e-4, alive)
    want = tint.hit_attributes_from_rows(scene, rows, o, d, ids, miss, 1e-4)
    for f in FIELDS + ("hit",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert _count() == before


def test_only_untextured_rows_on_a_cuda_device_take_the_kernels():
    """The dispatch predicate: 26-column rows on a CUDA device take the
    kernels; a textured scene's 40-column rows keep the plain path with
    its texture shading, on the card too; CPU rows keep it whatever their
    width."""
    b = rt.SceneBuilder(texture_resolution=8)
    tid = b.add_texture(np.full((8, 8, 3), 0.5, np.float32))
    b.add_mesh([[0, 0, 0], [1, 0, 0], [0, 0, 1]], [[0, 1, 0]] * 3, [0, 1, 2],
               uvs=[[0, 0], [1, 0], [0, 1]], tex=tid)
    textured = b.build(device="cpu")
    plain = _terrain("cpu", SMALL_N)
    cuda = torch.device("cuda", 0)

    def rows(scene, device):
        return SimpleNamespace(shape=(tint.attr_width(scene), 64),
                               device=device)

    assert tint.attr_width(textured) == 40
    assert thr.takes(rows(plain, cuda))
    assert not thr.takes(rows(textured, cuda))
    for scene in (plain, textured):
        assert not thr.takes(rows(scene, torch.device("cpu")))


def test_wrappers_raise_on_cpu_tensors():
    """The kernels have no CPU version: CPU tensors raise, as input the
    kernels do not take does, and nothing is counted."""
    R = 8
    rows, o, d = torch.zeros(26, R), torch.zeros(R, 3), torch.ones(R, 3)
    ids, miss = torch.zeros(R, dtype=torch.int32), torch.ones(R, dtype=bool)
    before = _count()
    with pytest.raises(ValueError, match="no hit-record kernel"):
        thr.hit_record(rows, o, d, ids, miss, 8)
    with pytest.raises(ValueError, match="no hit-record kernel"):
        thr.hit_record_vjp(rows, o, d, ids, miss, 8, [None] * 7,
                           (True, True, True))
    assert _count() == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_forward_is_bit_equal_to_the_plain_version_on_cuda(cuda_device):
    """Every output of the forward kernel, hit flag included, equals the
    plain version's on sphere hits, triangle hits, live misses, dead
    lanes and the four made rows; one launch."""
    for seed in (0, 1):
        scene, rows, o, d, ids, miss = _lanes(cuda_device, seed=seed)
        before = _count()
        got = thr.hit_record(rows, o, d, ids, miss, scene.padded_spheres)
        assert _count() == (before[0] + 1, before[1])
        want = tint.hit_attributes_from_rows(scene, rows, o, d, ids, miss,
                                             1e-4)
        for f, g in zip(FIELDS + ("hit",), got):
            w = getattr(want, f)
            assert g.shape == w.shape and g.is_contiguous(), f
            assert torch.equal(g, w), (f, seed)
        assert all(bool(torch.isfinite(g).all()) for g in got[:7])


def _grads(hit_fn, inputs, want, subset, seed):
    """autograd.grad of the outputs in ``subset`` of ``hit_fn``'s Hit,
    with seeded normal cotangents, over the inputs ``want`` picks →
    (grads, largest cotangent)."""
    x = [t.clone().requires_grad_(w) for t, w in zip(inputs, want)]
    h = hit_fn(*x)
    outs = [getattr(h, FIELDS[k]) for k in subset]
    gen = torch.Generator(device=outs[0].device).manual_seed(seed)
    cots = [torch.randn(y.shape, generator=gen, device=y.device)
            for y in outs]
    g = torch.autograd.grad(outs, [v for v, w in zip(x, want) if w], cots)
    return g, max(float(c.abs().max()) for c in cots)


@pytest.mark.cuda
@pytest.mark.parametrize("subset,want", [
    (range(7), (True, True, True)),        # every cotangent
    ((0, 2), (True, True, True)),          # t and normal alone
    ((1, 3, 5), (True, True, True)),       # point, albedo, strength
    ((0, 1, 2), (False, True, True)),      # only o and d want a gradient
    (range(7), (True, False, False)),      # only the rows do
    ((6,), (True, False, False))])         # a material column alone
def test_vjp_matches_autograd_of_the_plain_version_on_cuda(
        cuda_device, subset, want):
    """The VJP kernel through intersect._HitRecord against
    torch.autograd.grad of hit_attributes_from_rows, with the other
    outputs' cotangents undefined: rtol 1e-5 with a floor of 2e-4 x the
    largest cotangent (the module's note); one VJP launch."""
    scene, rows, o, d, ids, miss = _lanes(cuda_device, seed=2)
    subset = tuple(subset)

    def kernel(r, oo, dd):
        return tint._kernel_hit_attributes(scene, r, oo, dd, ids, miss)

    def plain(r, oo, dd):
        return tint.hit_attributes_from_rows(scene, r, oo, dd, ids, miss,
                                             1e-4)

    before = _count()
    got, cmax = _grads(kernel, (rows, o, d), want, subset, seed=7)
    assert _count() == (before[0] + 1, before[1] + 1)
    ref, _ = _grads(plain, (rows, o, d), want, subset, seed=7)
    names = [n for n, w in zip(("rows", "o", "d"), want) if w]
    for name, g, w in zip(names, got, ref):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        gap = (g - w).abs() - RTOL * w.abs()
        assert float(gap.max()) <= FLOOR * cmax, (name, float(gap.max()))
    if want[0]:  # columns the branch never reads get exact zeros
        g_rows = got[0]
        sphere = ids < scene.padded_spheres
        assert not bool(g_rows[12:, sphere].any())


def _train_step(scene, size, remat, frame=5):
    """One make_train_step step at size x size → (loss, {leaf: grad})."""
    from ray_tracer_tpu_torch.grad.inverse import make_train_step
    params = rt.RenderParams(width=size, height=size, remat=remat, **RENDER)
    basis = rt.camera_basis(rt.Camera(origin=ORIGIN, look_at=LOOK_AT,
                                      fov=FOV, aspect=1.0))
    with torch.no_grad():
        target = rt.render_frame(scene, basis, params, frame)
    start = dataclasses.replace(scene, tri_albedo=scene.tri_albedo * 0.8,
                                sphere_albedo=scene.sphere_albedo * 0.8)
    init_fn, step_fn = make_train_step(params)
    trainable, opt = init_fn(start)
    trainable, opt, loss = step_fn(trainable, opt, start, basis, target,
                                   frame + 1)
    return float(loss), {k: p.grad.clone() for k, p in trainable.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_the_plain_path_on_cuda(cuda_device, remat,
                                                   monkeypatch):
    """A 64x64 training step on the 15,842-triangle terrain: the loss and every
    trainable leaf's gradient through the kernels equal the plain path's
    within the VJP's tolerance (the floor at 2e-4 of the leaf's largest
    gradient); the kernels run 4 forward launches a render (8 with remat:
    its backward recomputes each segment) and 4 VJP launches a step."""
    scene = _terrain(cuda_device)
    before = _count()
    loss, grads = _train_step(scene, 64, remat)
    fwd = 4 * (3 if remat else 2)  # target render, forward (+ recompute)
    assert _count() == (before[0] + fwd, before[1] + 4)
    monkeypatch.setattr(tint, "takes", lambda rows: False)
    before = _count()
    loss_ref, grads_ref = _train_step(scene, 64, remat)
    assert _count() == before
    assert loss == pytest.approx(loss_ref, rel=RTOL)
    nonzero = 0
    for k, w in grads_ref.items():
        g = grads[k]
        gap = (g - w).abs() - RTOL * w.abs()
        scale = float(w.abs().max())
        assert float(gap.max()) <= FLOOR * scale, (k, float(gap.max()), scale)
        nonzero += scale > 0
    assert nonzero >= 4
