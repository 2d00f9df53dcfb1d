"""The port's edge-sampled boundary gradients (grad/edges.py).

Two kinds of check. Given the reference's own draws (recomputed here with
``jax.random`` from the reference's key, splits and logits), the port's
``gradients_from_draws`` must give the reference's output: per output key
max |port − reference| <= DRAWS_TOL × max |reference| over the entries
where the reference is finite (its ``jnp.linalg.norm`` has a NaN gradient
at a zero vector, which padding spheres reach), the port finite
everywhere. With the port's own ``torch.Generator`` draws, the estimator
must meet the reference's own bars (``tests/test_edges.py``): finite
differences, occlusion, the double count it fixes, the variance budget
and an end-to-end silhouette recovery.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.grad import edges as je
from ray_tracer_tpu.grad import topology as jt
from ray_tracer_tpu_torch.grad import edges as te
from ray_tracer_tpu_torch.grad import inverse as tinv
from ray_tracer_tpu_torch.grad import topology as tt
from ray_tracer_tpu_torch.renderer import render_frame

from test_edges import LE, W, H, _cam, _ramp_cot, _sphere_scene, _tet_scene
from test_edges import PARAMS as J_PARAMS
from test_torch_common import t_, to_port, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DRAWS_TOL = 1e-5   # f32 per-sample math in another association, summed
PARAMS = trt.RenderParams(width=W, height=H, bounces=0, skybox=False,
                          backend="torch")


def _tri_scene(dx=0.0):
    verts = [(-1.0 + dx, -1.0, -5.0), (1.0 + dx, -1.0, -5.0),
             (0.0 + dx, 1.2, -5.0)]
    return (jrt.SceneBuilder()
            .add_mesh(verts, np.tile([[0, 0, 1.0]], (3, 1)), [0, 1, 2],
                      albedo=(0, 0, 0), emission=(1, 1, 1),
                      emission_strength=LE)
            .build(pad=8))


def _lens_cam():
    return jrt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=45.0,
                      aspect=1.0, focus_dist=1.0, aperture=0.25)


def _cot():
    return t_(_ramp_cot())


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _ramp_loss(ts, basis, frames=64):
    """E[Σ cot·img] over the AA jitter, estimated with many frames."""
    cot = _cot()
    tot = sum(float(torch.sum(cot * render_frame(ts, basis, PARAMS, i)))
              for i in range(frames))
    return tot / frames


def reference_draws(js, basis, params, key, n_tri, n_sph, topology=None):
    """The reference's draws for ``key`` (its splits, fold-ins and, with a
    topology, its logits) as the port's EdgeDraws."""
    W_, H_ = params.width, params.height
    k_tri, k_sph, k_rng, k_lens = jax.random.split(key, 4)

    def lens(k, n):
        k1, k2 = jax.random.split(k)
        return t_(jnp.stack([jax.random.uniform(k1, (n,)),
                             jax.random.uniform(k2, (n,))], -1))

    def state(k, n):
        return t_(np.asarray(jax.random.bits(k, (n,), dtype=jnp.uint32))
                  .astype(np.int64))

    d = {}
    if n_tri and js.num_tris:
        ke, kt = jax.random.split(k_tri)
        if topology is not None:
            topo = topology
            verts = jnp.stack([js.tri_v0, js.tri_v1, js.tri_v2], 1)
            va = verts[topo.edge_tri, topo.edge_k]
            vb = verts[topo.edge_tri, (topo.edge_k + 1) % 3]

            def front(ids):
                t = jnp.maximum(ids, 0)
                a = js.tri_v0[t]
                nf = jnp.cross(js.tri_v1[t] - a, js.tri_v2[t] - a)
                cen = (a + js.tri_v1[t] + js.tri_v2[t]) / 3.0
                return jnp.sum(nf * (basis.origin - cen), axis=-1) > 0.0

            cand = (jnp.where(topo.edge_tri2 >= 0,
                              front(topo.edge_tri) != front(topo.edge_tri2),
                              True) | (topo.edge_crease > 0.5))
            cand = cand & (js.tri_valid[topo.edge_tri] > 0.5)
            ell = jnp.linalg.norm(je.project_to_image(basis, vb, W_, H_)
                                  - je.project_to_image(basis, va, W_, H_),
                                  axis=-1)
            wgt = jnp.where(cand, jnp.clip(ell, 1e-3, 1e4), 0.0)
            logits = jnp.where(wgt > 0, jnp.log(jnp.maximum(wgt, 1e-30)),
                               -jnp.inf)
            eid = jax.random.categorical(ke, logits, shape=(n_tri,))
        else:
            eid = jax.random.randint(ke, (n_tri,), 0, 3 * js.padded_tris)
        d.update(edge_id=t_(np.asarray(eid).astype(np.int64)),
                 tparam=t_(jax.random.uniform(kt, (n_tri,))),
                 edge_lens=lens(jax.random.fold_in(k_lens, 0), n_tri),
                 edge_state=state(jax.random.fold_in(k_rng, 0), n_tri))
    if n_sph and js.num_spheres:
        ks, kp = jax.random.split(k_sph)
        d.update(
            sphere_id=t_(np.asarray(jax.random.randint(
                ks, (n_sph,), 0, js.padded_spheres)).astype(np.int64)),
            phi=t_(jax.random.uniform(kp, (n_sph,)) * 2.0 * np.pi),
            sphere_lens=lens(jax.random.fold_in(k_lens, 1), n_sph),
            sphere_state=state(jax.random.fold_in(k_rng, 1), n_sph))
    return te.EdgeDraws(**d)


def assert_close_where_finite(got, want, tol=DRAWS_TOL):
    """Per key: got finite; max |got − want| <= tol × max |want| where want
    is finite → the number of keys with a nonzero reference."""
    nonzero = 0
    for k, w in want.items():
        g, w = got[k].detach().cpu().numpy(), np.asarray(w)
        assert np.isfinite(g).all(), k
        ok = np.isfinite(w)
        scale = float(np.abs(w[ok]).max()) if ok.any() else 0.0
        err = float(np.abs(g[ok] - w[ok]).max()) if ok.any() else 0.0
        assert err <= tol * scale, (k, err, scale)
        nonzero += scale > 0
    return nonzero


def test_project_matches_reference_and_inverts_ray_generation():
    for cam in (_cam(), _lens_cam()):
        jb, tb = jrt.camera_basis(cam), trt.camera_basis(cam)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(64, 3)).astype(np.float32) + [0, 0, -5]
        o = (np.asarray(jb.origin) + rng.normal(size=(64, 3)).astype(
            np.float32) * float(jb.lens_radius))
        for origin in (None, o):
            want = np.asarray(je.project_to_image(
                jb, jnp.asarray(x), W, H,
                None if origin is None else jnp.asarray(origin)))
            got = te.project_to_image(tb, t_(x), W, H,
                                      None if origin is None else t_(origin))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-4)
    # a ray through pixel-space point (10.3, 20.7) projects back to it
    tb = trt.camera_basis(_cam())
    px, py = 10.3 / W, 20.7 / H
    d = tb.lower_left + px * tb.horizontal + py * tb.vertical - tb.origin
    pix = te.project_to_image(tb, tb.origin + 3.7 * d, W, H)
    np.testing.assert_allclose(pix.numpy(), [10.3, 20.7], atol=1e-3)


def test_lookup_cot_matches_reference():
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(H, W, 3)).astype(np.float32)
    pix = rng.uniform(-5, W + 5, size=(500, 2)).astype(np.float32)
    want = np.asarray(je._lookup_cot(jnp.asarray(cot), jnp.asarray(pix), W,
                                     H))
    got = te._lookup_cot(t_(cot), t_(pix), W, H)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).all(axis=1).any()    # some points fall outside


CASES = {  # scene, camera, triangle samples, sphere samples, topology
    "sphere": (_sphere_scene, _cam, 0, 3000, False),
    "triangle": (_tri_scene, _cam, 3000, 0, False),
    "tet_topology": (_tet_scene, _cam, 3000, 0, True),
    "thin_lens": (_sphere_scene, _lens_cam, 0, 3000, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_from_reference_draws_match_reference(case):
    make, cam_fn, n_tri, n_sph, topo = CASES[case]
    js = make()
    ts = to_port(js)
    cam = cam_fn()
    jb, tb = jrt.camera_basis(cam), trt.camera_basis(cam)
    jtopo = jt.build_topology(js) if topo else None
    ttopo = tt.build_topology(ts) if topo else None
    key = jax.random.PRNGKey(11)
    want = je.boundary_gradients(js, jb, J_PARAMS, _ramp_cot(), key,
                                 n_tri_samples=n_tri, n_sph_samples=n_sph,
                                 topology=jtopo)
    draws = reference_draws(js, jb, J_PARAMS, key, n_tri, n_sph, jtopo)
    got = te.gradients_from_draws(ts, tb, PARAMS, _cot(), draws,
                                  topology=ttopo)
    assert set(got) == set(want)
    assert assert_close_where_finite(got, want) >= (1 if n_tri else 2)


def test_side_rays_past_the_frame_stay_finite():
    """A triangle far above the frame: its edges' side rays leave the frame
    where the unnormalized sky directions make the sun lobe (pow(d·s,
    500)) overflow to inf, and the reference's 0 (the cotangent off the
    frame) times inf turns its gradient NaN there (ROADMAP §C, H6). The
    port's stays finite and equals the reference's wherever that is
    finite."""
    js = (jrt.SceneBuilder()
          .add_mesh([(-1.0, -1.0, -5.0), (1.0, -1.0, -5.0), (0.0, 1.2, -5.0),
                     (-1.0, 8.0, -5.0), (1.0, 8.0, -5.0), (0.0, 10.0, -5.0)],
                    np.tile([[0, 0, 1.0]], (6, 1)), [0, 1, 2, 3, 4, 5],
                    albedo=(0, 0, 0), emission=(1, 1, 1),
                    emission_strength=LE)
          .build(pad=8))
    ts = to_port(js)
    jparams = J_PARAMS.replace(skybox=True)
    jb, tb = jrt.camera_basis(_cam()), trt.camera_basis(_cam())
    key = jax.random.PRNGKey(5)
    want = je.boundary_gradients(js, jb, jparams, _ramp_cot(), key,
                                 n_tri_samples=2000, n_sph_samples=0)
    assert not all(np.isfinite(np.asarray(v)).all() for v in want.values())
    got = te.gradients_from_draws(
        ts, tb, PARAMS.replace(skybox=True), _cot(),
        reference_draws(js, jb, jparams, key, 2000, 0))
    assert assert_close_where_finite(got, want) >= 1


def test_sphere_boundary_gradient_matches_finite_difference():
    tb = trt.camera_basis(_cam())
    ts = to_port(_sphere_scene())
    bg = te.boundary_gradients(ts, tb, PARAMS, _cot(), _gen(0),
                               n_tri_samples=0, n_sph_samples=20000)
    g_cx, g_r = float(bg["sphere_center"][0, 0]), float(bg["sphere_radius"][0])
    h = 0.04
    fd_cx = (_ramp_loss(to_port(_sphere_scene(cx=+h)), tb)
             - _ramp_loss(to_port(_sphere_scene(cx=-h)), tb)) / (2 * h)
    fd_r = (_ramp_loss(to_port(_sphere_scene(r=1.0 + h)), tb)
            - _ramp_loss(to_port(_sphere_scene(r=1.0 - h)), tb)) / (2 * h)
    assert np.sign(g_cx) == np.sign(fd_cx) and abs(fd_cx) > 1e-5
    assert abs(g_cx - fd_cx) < 0.35 * abs(fd_cx), (g_cx, fd_cx)
    assert np.sign(g_r) == np.sign(fd_r) and abs(fd_r) > 1e-5
    assert abs(g_r - fd_r) < 0.35 * abs(fd_r), (g_r, fd_r)


def _total_dx(bg):
    return float(bg["tri_v0"][:, 0].sum() + bg["tri_v1"][:, 0].sum()
                 + bg["tri_v2"][:, 0].sum())


def test_triangle_boundary_gradient_matches_finite_difference():
    tb = trt.camera_basis(_cam())
    bg = te.boundary_gradients(to_port(_tri_scene()), tb, PARAMS, _cot(),
                               _gen(1), n_tri_samples=20000,
                               n_sph_samples=0)
    h = 0.04
    fd_dx = (_ramp_loss(to_port(_tri_scene(+h)), tb)
             - _ramp_loss(to_port(_tri_scene(-h)), tb)) / (2 * h)
    g_dx = _total_dx(bg)
    assert np.sign(g_dx) == np.sign(fd_dx) and abs(fd_dx) > 1e-5
    assert abs(g_dx - fd_dx) < 0.35 * abs(fd_dx), (g_dx, fd_dx)


def test_occluded_edges_contribute_nothing():
    b = trt.SceneBuilder()
    b.add_sphere((0, 0, -3.0), 1.5, (0.5, 0.5, 0.5))           # occluder
    b.add_sphere((0, 0, -8.0), 0.5, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=LE)                          # hidden
    ts = b.build(pad=8, device="cpu")
    bg = te.boundary_gradients(ts, trt.camera_basis(_cam()), PARAMS, _cot(),
                               _gen(2), n_tri_samples=0, n_sph_samples=8000)
    hidden = bg["sphere_center"][1].abs().max().item()
    visible = bg["sphere_center"][0].abs().max().item()
    assert hidden < 0.05 * max(visible, 1e-6) or hidden < 1e-5


def test_sphere_boundary_gradient_thin_lens_matches_fd():
    tb = trt.camera_basis(_lens_cam())
    bg = te.boundary_gradients(to_port(_sphere_scene()), tb, PARAMS, _cot(),
                               _gen(3), n_tri_samples=0, n_sph_samples=40000)
    g_cx = float(bg["sphere_center"][0, 0])
    h = 0.05
    fd_cx = (_ramp_loss(to_port(_sphere_scene(cx=+h)), tb, frames=192)
             - _ramp_loss(to_port(_sphere_scene(cx=-h)), tb, frames=192)
             ) / (2 * h)
    assert np.sign(g_cx) == np.sign(fd_cx) and abs(fd_cx) > 1e-5
    assert abs(g_cx - fd_cx) < 0.4 * abs(fd_cx), (g_cx, fd_cx)


def test_shared_edge_double_count_fixed_by_topology():
    """On a closed mesh the uniform-over-slots sampler lands at ~2x the
    finite difference, the physical-edge sampler on it."""
    ts = to_port(_tet_scene())
    topo = tt.build_topology(ts)
    tb = trt.camera_basis(_cam())
    h = 0.04
    fd = (_ramp_loss(to_port(_tet_scene(+h)), tb)
          - _ramp_loss(to_port(_tet_scene(-h)), tb)) / (2 * h)
    assert abs(fd) > 1e-5

    def mean_dx(**kw):
        return np.mean([_total_dx(te.boundary_gradients(
            ts, tb, PARAMS, _cot(), _gen(s), n_tri_samples=4000,
            n_sph_samples=0, **kw)) for s in range(4)])

    g_topo, g_legacy = mean_dx(topology=topo), mean_dx()
    assert abs(g_topo - fd) < 0.25 * abs(fd), (g_topo, fd)
    assert 1.6 < g_legacy / fd < 2.6, (g_legacy, fd)


def test_silhouette_sampler_variance_budget():
    """At an equal sample count the silhouette sampler cuts the standard
    deviation of the boundary gradient at least to 0.6x uniform slots'."""
    ts = to_port(_tet_scene())
    topo = tt.build_topology(ts)
    tb = trt.camera_basis(_cam())

    def run(seed, **kw):
        return _total_dx(te.boundary_gradients(
            ts, tb, PARAMS, _cot(), _gen(seed), n_tri_samples=2000,
            n_sph_samples=0, **kw))

    g_t = np.array([run(s, topology=topo) for s in range(8)])
    g_u = np.array([run(s) for s in range(8)])
    assert g_t.std() < 0.6 * g_u.std(), (g_t.std(), g_u.std())


def test_no_candidate_edge_gives_zeros_without_raising():
    """A closed tetrahedron around the camera: every face is seen from
    inside, no edge flips and none is a crease, so no edge is a candidate;
    the reference's categorical over all −inf logits gives zeros, and so
    must the port (torch.multinomial alone would raise)."""
    v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                 np.float32) * 4.0
    nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
    ts = (trt.SceneBuilder()
          .add_mesh(v, nrm, [0, 1, 2, 0, 2, 3, 0, 3, 1, 1, 3, 2],
                    albedo=(0, 0, 0), emission=(1, 1, 1),
                    emission_strength=LE)
          .build(pad=8, device="cpu"))
    topo = tt.build_topology(ts)
    tb = trt.camera_basis(_cam())
    wgt = te._edge_weights(ts, tb, topo, W, H)[0]
    assert float(wgt.sum()) == 0.0
    bg = te.boundary_gradients(ts, tb, PARAMS, _cot(), _gen(0),
                               n_tri_samples=500, n_sph_samples=0,
                               topology=topo)
    for k, v in bg.items():
        assert torch.equal(v, torch.zeros_like(v)), k


@pytest.mark.parametrize("topology", [False, True])
def test_train_step_adds_the_boundary_gradient(topology):
    """make_train_step(edge_samples, topology): the step's gradient is the
    interior gradient plus boundary_gradients at the step's scene, with the
    generator seeded as documented (grad.inverse.edge_generator)."""
    ts = to_port(_tet_scene())
    topo = tt.build_topology(ts) if topology else None
    tb = trt.camera_basis(_cam())
    params = PARAMS.replace(bounces=1, skybox=True)
    fields = ("tri_v0", "tri_v1", "tri_v2", "tri_albedo")
    target = 0.5 * render_frame(ts, tb, params, 3)
    init_fn, step_fn = tinv.make_train_step(
        params, lambda leaves: torch.optim.SGD(leaves, lr=0.0),
        edge_samples=300, topology=topo)
    trainable, opt = init_fn(ts, fields)
    step_fn(trainable, opt, ts, tb, target, 5)
    got = {k: p.grad.clone() for k, p in trainable.items()}

    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    full = dataclasses.replace(ts, **leaves)
    img = render_frame(full, tb, params, 5)
    interior = dict(zip(fields, torch.autograd.grad(
        torch.mean((img - target) ** 2), list(leaves.values()))))
    bg = te.boundary_gradients(
        full, tb, params, 2.0 * (img.detach() - target) / img.numel(),
        tinv.edge_generator(5, "cpu"), n_tri_samples=300, n_sph_samples=300,
        topology=topo)
    assert any(bool(bg[k].any()) for k in ("tri_v0", "tri_v1", "tri_v2"))
    for k in fields:
        want = interior[k] + bg[k] if k in bg else interior[k]
        torch.testing.assert_close(got[k], want, rtol=1e-5, atol=1e-8)


def test_end_to_end_silhouette_recovery():
    """Recover a translated emissive sphere from its silhouette: interior
    gradients are exactly zero here, so only the boundary term moves it
    (the reference's test, Adam 5e-2 and 3000 edge samples, 50 steps)."""
    tb = trt.camera_basis(_cam())
    target = render_frame(to_port(_sphere_scene()), tb, PARAMS, 0)
    start = to_port(_sphere_scene(cx=0.8, cy=-0.5))
    init_fn, step_fn = tinv.make_train_step(
        PARAMS, lambda leaves: torch.optim.Adam(leaves, lr=5e-2),
        edge_samples=3000)
    trainable, opt = init_fn(start, fields=("sphere_center",))
    for i in range(50):
        trainable, opt, _ = step_fn(trainable, opt, start, tb, target, i)
    rec = trainable["sphere_center"][0].detach().numpy()
    err = np.linalg.norm(rec - np.array([0.0, 0.0, -5.0]))
    assert err < 0.25, (rec, err)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_estimator_on_the_kernels_path_matches_plain_path(cuda_device):
    """On the card, the estimator's side-ray traces through the closest-hit
    kernel against the plain path on the same draws: per key within
    DRAWS_TOL of the plain path's largest entry."""
    from ray_tracer_tpu_torch.ops import closest_hit as tch
    # the tetrahedron at the kernels' padding (whole 64-triangle clusters)
    v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                 np.float32) * 0.8 + np.array([0, 0, -5.0], np.float32)
    nrm = v - v.mean(0)
    ts = (trt.SceneBuilder()
          .add_mesh(v, nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
                    [0, 1, 2, 0, 2, 3, 0, 3, 1, 1, 3, 2], albedo=(0, 0, 0),
                    emission=(1, 1, 1), emission_strength=LE)
          .build(device=cuda_device))
    topo = tt.build_topology(ts)
    tb = trt.camera_basis(_cam())
    params = PARAMS.replace(bounces=1, skybox=True)
    cot = _cot().to(cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    draws = te.draw_edge_samples(ts, tb, params, g, 4096, 0, topo)
    before = tch.nearest_hit_attrs.launches
    got = te.gradients_from_draws(ts, tb, params.replace(backend="cuda"), cot,
                                  draws, topology=topo)
    assert tch.nearest_hit_attrs.launches == before + 2 * (params.bounces + 1)
    want = te.gradients_from_draws(ts, tb, params, cot, draws,
                                   topology=topo)
    assert assert_close_where_finite(got, {k: v.cpu().numpy()
                                           for k, v in want.items()}) >= 1
