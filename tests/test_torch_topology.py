"""The port's mesh topology (grad/topology.py) against the reference's.

``build_topology`` must give the reference's eight arrays element for
element; the vertex-field plumbing its values and ``jax.grad``'s
gradients (tolerances below); ``sobolev_precondition`` the reference's CG
iterates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.grad import topology as jt
from ray_tracer_tpu_torch.grad import topology as tt
from ray_tracer_tpu_torch.ops import closest_hit as tch
from ray_tracer_tpu_torch.renderer import render_frame

from test_edges import _tet_scene
from test_invert_vertices import octasphere
from test_torch_common import t_, terrain, to_port, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
from test_torch_grad import kernel_path_on_cpu

# f32 values of the plumbing: the same operations in another summation
# order (index_add vs .at[].add) differ by a few ulps of the largest term
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
# CG: 20-60 iterations of f32 dot products summed in another order
CG_TOL = 2e-4


def _quad(normals=None, idx=(0, 1, 2, 0, 2, 3), extra=()):
    verts = [(-1, -1, -5), (1, -1, -5), (1, 1, -5), (-1, 1, -5)] + list(extra)
    if normals is None:
        normals = np.tile([[0, 0, 1.0]], (len(verts), 1))
    return (jrt.SceneBuilder()
            .add_mesh(verts, normals, list(idx), albedo=(0.5, 0.5, 0.5))
            .build(pad=8))


def _crease_quad():
    """tests/test_edges.py's crease quad: the shared edge's corner 2 has
    another shading normal in the second triangle."""
    normals = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0.7, 0, 0.7],
                        [0.7, 0, 0.7]], np.float32)
    return _quad(normals, (0, 1, 2, 0, 4, 3), extra=[(1, 1, -5)])


def _octasphere():
    verts, faces = octasphere(subdiv=2)
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return jrt.SceneBuilder().add_mesh(verts, normals,
                                       faces.reshape(-1)).build()


SCENES = {"tet": _tet_scene, "quad": _quad, "crease_quad": _crease_quad,
          "octasphere": _octasphere,
          "terrain12": lambda: terrain(jrt, n=12)[0]}


def _pair(name):
    js = SCENES[name]()
    ts = to_port(js)
    return js, ts, jt.build_topology(js), tt.build_topology(ts)


@pytest.mark.parametrize("name", list(SCENES))
def test_build_topology_equals_reference(name):
    js, ts, jtopo, ttopo = _pair(name)
    for f in dataclasses.fields(jtopo):
        want = np.asarray(getattr(jtopo, f.name))
        got = getattr(ttopo, f.name).numpy()
        assert got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert ttopo.num_verts == jtopo.num_verts
    assert ttopo.num_edges == jtopo.num_edges
    if name == "tet":      # 4 vertices + the all-zero padding corner
        assert (ttopo.num_verts, ttopo.num_edges) == (5, 6)
    if name == "crease_quad":
        assert float(ttopo.edge_crease.max()) == 1.0
    if name == "terrain12":  # an open mesh: boundary edges
        assert int((ttopo.edge_tri2 < 0).sum()) == 4 * 11


def _field(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(
        np.float32) * 0.1


def _close_where_finite(got, want, rtol=VALUE_RTOL, atol=VALUE_ATOL):
    """got (torch) against want (jax) where want is finite; got finite
    everywhere (the reference's jnp.linalg.norm has a NaN gradient at the
    padding vertex's zero normal sum)."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol,
                               atol=atol * max(np.abs(want[ok]).max(), 1.0))
    return int((~ok).sum())


@pytest.mark.parametrize("name", ["tet", "octasphere", "terrain12"])
def test_vertex_plumbing_values_and_grads_match_jax(name):
    js, ts, jtopo, ttopo = _pair(name)
    off = _field(jtopo.num_verts, 0)
    w = np.random.default_rng(1).normal(size=(3, js.padded_tris, 3)).astype(
        np.float32)

    def j_loss(o, normals=True):
        s = jt.apply_vertex_offsets(js, jtopo, o, recompute_normals=normals)
        return sum(jnp.sum(getattr(s, f"tri_{c}{k}") * w[k])
                   for c in (("v", "n") if normals else ("v",))
                   for k in range(3))

    def t_loss(o, normals=True):
        s = tt.apply_vertex_offsets(ts, ttopo, o, recompute_normals=normals)
        return sum(torch.sum(getattr(s, f"tri_{c}{k}") * t_(w[k]))
                   for c in (("v", "n") if normals else ("v",))
                   for k in range(3))

    js1 = jt.apply_vertex_offsets(js, jtopo, jnp.asarray(off))
    ts1 = tt.apply_vertex_offsets(ts, ttopo, t_(off))
    for k in ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2"):
        _close_where_finite(getattr(ts1, k), getattr(js1, k))
    assert ts1.tri_v0 is not ts.tri_v0 and torch.equal(ts.tri_v0,
                                                       to_port(js).tri_v0)
    for normals in (True, False):
        o = t_(off).requires_grad_(True)
        t_loss(o, normals).backward()
        g_j = jax.grad(lambda x: j_loss(x, normals))(jnp.asarray(off))
        nan = _close_where_finite(o.grad, g_j, rtol=1e-4, atol=1e-5)
        if not normals:
            assert nan == 0

    # pull_back_vertex_grads is the transpose of the position gather
    tg = {f"tri_v{k}": w[k] for k in range(3)}
    got = tt.pull_back_vertex_grads(
        ttopo, {k: t_(v) for k, v in tg.items()}, ts.tri_valid)
    want = jt.pull_back_vertex_grads(
        jtopo, {k: jnp.asarray(v) for k, v in tg.items()}, js.tri_valid)
    _close_where_finite(got, want)
    o = t_(off).requires_grad_(True)
    t_loss(o, normals=False).backward()
    torch.testing.assert_close(got, o.grad, rtol=VALUE_RTOL, atol=1e-6)

    # smooth_normals on deformed positions, the Laplacian and the prior
    _close_where_finite(tt.laplacian_apply(ttopo, t_(off)),
                        jt.laplacian_apply(jtopo, jnp.asarray(off)))
    for k, (a, b) in enumerate(zip(
            tt.smooth_normals(ttopo, ts1.tri_v0, ts1.tri_v1, ts1.tri_v2,
                              ts.tri_valid),
            jt.smooth_normals(jtopo, js1.tri_v0, js1.tri_v1, js1.tri_v2,
                              js.tri_valid))):
        _close_where_finite(a, b)
    o = t_(off).requires_grad_(True)
    e = tt.dirichlet_energy(ttopo, o)
    e.backward()
    e_j, g_j = jax.value_and_grad(
        lambda x: jt.dirichlet_energy(jtopo, x))(jnp.asarray(off))
    assert float(e.detach()) == pytest.approx(float(e_j), rel=VALUE_RTOL)
    _close_where_finite(o.grad, g_j)
    # zero for a constant field
    assert float(tt.dirichlet_energy(
        ttopo, t_(np.broadcast_to(off[:1], off.shape).copy()))) == 0.0


@pytest.mark.parametrize("lam", [0.0, 2.0, 25.0])
@pytest.mark.parametrize("iters", [20, 60])
def test_sobolev_precondition_matches_reference(lam, iters):
    js, ts, jtopo, ttopo = _pair("octasphere")
    g = _field(jtopo.num_verts, 3) * 10
    want = np.asarray(jt.sobolev_precondition(jtopo, jnp.asarray(g), lam,
                                              iters=iters))
    g_t = t_(g)
    got = tt.sobolev_precondition(ttopo, g_t, lam, iters=iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=CG_TOL,
                               atol=CG_TOL * np.abs(want).max())
    if lam == 0.0:
        assert got is g_t
    # a 0-d tensor λ gives the float λ's iterates
    torch.testing.assert_close(
        tt.sobolev_precondition(ttopo, t_(g), torch.tensor(lam), iters),
        got, rtol=0, atol=0)


def test_sobolev_precondition_solves_metric():
    """tests/test_invert_vertices.py's solve and roughness test on the
    port: (I + λL) p = g to CG tolerance, λ = 0 the identity, and the
    preconditioned gradient much less rough across edges per unit
    energy."""
    verts, faces = octasphere(subdiv=1)
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    scene = (trt.SceneBuilder()
             .add_mesh(verts, normals, faces.reshape(-1),
                       albedo=(0.5, 0.5, 0.5))
             .build(device="cpu"))
    topo = tt.build_topology(scene)
    g = t_(np.random.default_rng(3).normal(size=(topo.num_verts, 3)))
    lam = 25.0
    p = tt.sobolev_precondition(topo, g, lam, iters=60)
    back = p + lam * tt.laplacian_apply(topo, p)
    np.testing.assert_allclose(back.numpy(), g.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert torch.equal(tt.sobolev_precondition(topo, g, 0.0), g)

    def rough_per_energy(x):
        d = x[topo.edge_va] - x[topo.edge_vb]
        return float(torch.mean(d * d)) / float(torch.mean(x * x))

    assert rough_per_energy(p) < 0.2 * rough_per_energy(g)


def test_offsets_render_fresh_planes_on_the_kernel_path(monkeypatch):
    """A render after apply_vertex_offsets on the kernels' path (CPU
    stand-ins) reads the deformed scene's planes: equal to a render from
    a cleared plane cache, and different from the undeformed scene's."""
    _, ts, _, ttopo = _pair("octasphere")
    calls = kernel_path_on_cpu(monkeypatch)
    cam = trt.Camera(origin=(0.0, 0.5, 3.0), look_at=(0.0, 0.0, 0.0))
    basis = trt.camera_basis(cam)
    params = trt.RenderParams(width=24, height=16, bounces=1, skybox=True,
                              backend="cuda")
    before = render_frame(ts, basis, params, 0)
    moved = tt.apply_vertex_offsets(ts, ttopo,
                                    t_(_field(ttopo.num_verts, 5) * 3))
    got = render_frame(moved, basis, params, 0)
    tch.clear_plane_cache()
    fresh = render_frame(moved, basis, params, 0)
    assert len(calls) == 3 * (params.bounces + 1)
    assert torch.equal(got, fresh)
    assert not torch.equal(got, before)
