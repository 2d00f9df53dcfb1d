"""The packed planes of the port's closest-hit kernels and their cache.

The kernels read a scene through packed planes (``ops/closest_hit.py``):
the geometry plane, the cluster boxes, the super boxes over runs of 8
clusters, the block boxes of the streaming kernel. The super boxes are held
to the reference's (``_super_aabbs`` over ``_pad_clusters_for_supers``) on
the same scene leaves, exactly, on the real supers: both take the min and
max of the same stored values. Every real triangle must lie inside the box
of its cluster, super and block, which is what makes the culling safe. The
cache lives one top-level call (``plane_scope``): inside a scope it must
hand back the same planes while a scene's tensors are unchanged and pack
anew after any in-place update or a new scene; outside one every query
packs, so a write between two calls is seen whatever its route.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu_torch.ops import blocked_hit as tbh
from ray_tracer_tpu_torch.ops import closest_hit as tch

from ray_tracer_tpu_torch import renderer as tr
from ray_tracer_tpu_torch.ops.intersect import merged_width

from test_torch_blocked import _mesh
from test_torch_common import scene_pair, terrain, to_port
from test_torch_grad import kernel_path_on_cpu


def _scenes(name):
    """(reference scene, port scene): room (one real cluster), the terrain
    at n=112 (386 clusters: the 49th super holds two) and a random mesh of
    700 triangles (11 clusters: the second super holds three)."""
    if name == "room":
        return scene_pair("room")[:2]
    if name == "terrain112":
        js = terrain(jrt, n=112)[0]
        return js, to_port(js)
    return _mesh(700, seed=8)


SCENES = ["room", "terrain112", "mesh700"]


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    return (request.param,) + tuple(_scenes(request.param))


def test_geometry_plane_is_the_first_twelve_columns(pair):
    _, _, ts = pair
    tri = tch._pack_tris(ts)
    geo = tch._pack_geo(tri)
    assert geo.shape == (ts.padded_tris, tch.GEO_COLS) == (ts.padded_tris, 12)
    assert geo.is_contiguous() and geo.dtype == torch.float32
    assert torch.equal(geo, tri[:, :12])
    planes = tch.ScenePlanes(ts)
    assert torch.equal(planes.geo, geo) and torch.equal(planes.tri, tri)


def test_super_boxes_match_reference(pair):
    name, js, ts = pair
    n_clusters = -(-ts.num_tris // tch.CLUSTER)
    n_super = -(-n_clusters // tch.SUPER)
    clu_j, sup_j = jpk._pad_clusters_for_supers(
        jpk._cluster_aabbs(js, tch.CLUSTER), tch.SUPER)
    sup_p = tch._super_aabbs(tch._cluster_aabbs(ts)[:n_clusters])
    assert sup_p.shape == (n_super, 8)
    np.testing.assert_array_equal(sup_p.numpy(), np.asarray(sup_j)[:n_super])
    assert np.isfinite(sup_p.numpy()).all()
    if name != "room":   # the last real super is part padding
        assert n_clusters % tch.SUPER
    planes = tch.ScenePlanes(ts)
    assert planes.n_clusters == n_clusters
    assert torch.equal(planes.sup, sup_p)


@pytest.mark.parametrize("level", ["cluster", "super", "block1024",
                                   "block8192", "block192"])
def test_real_triangles_lie_inside_their_boxes(pair, level):
    _, _, ts = pair
    planes = tch.ScenePlanes(ts)
    n = ts.num_tris
    per_box = {"cluster": 1, "super": tch.SUPER, "block1024": 16,
               "block8192": 128, "block192": 3}[level]
    boxes = {"cluster": planes.clu, "super": planes.sup}.get(level)
    if boxes is None:
        boxes = planes.block_boxes(per_box)
        assert boxes.shape == (tbh.block_layout(
            ts, per_box * tch.CLUSTER)[2], 8)
    box_of = torch.arange(n) // (tch.CLUSTER * per_box)
    lo, hi = boxes[box_of, 0:3], boxes[box_of, 3:6]
    for v in (ts.tri_v0, ts.tri_v1, ts.tri_v2):
        assert bool((v[:n] >= lo).all()) and bool((v[:n] <= hi).all())
    # tight: every real box's bound is attained by one of its vertices
    vs = torch.cat([ts.tri_v0[:n], ts.tri_v1[:n], ts.tri_v2[:n]])
    real = int(box_of.max()) + 1
    for k in range(3):
        assert bool(torch.isin(boxes[:real, k], vs[:, k]).all())
        assert bool(torch.isin(boxes[:real, 3 + k], vs[:, k]).all())


def test_cache_returns_the_same_planes_for_an_unchanged_scene():
    _, ts = _scenes("room")
    with tch.plane_scope():
        before = tch.scene_planes.packs
        planes = tch.scene_planes(ts)
        assert tch.scene_planes.packs == before + 1
        assert tch.scene_planes(ts) is planes
        # a copy of the dataclass over the same tensors is the same scene
        assert tch.scene_planes(dataclasses.replace(ts)) is planes
        assert planes.block_boxes(16) is planes.block_boxes(16)
        assert tch.scene_planes.packs == before + 1
        tch.clear_plane_cache()
        assert tch.scene_planes(ts) is not planes
        assert tch.scene_planes.packs == before + 2


def test_cache_lives_one_top_level_call():
    """Outside a scope every query packs and nothing is kept; nested scopes
    share one entry, and leaving the outermost drops it."""
    _, ts = _scenes("room")
    before = tch.scene_planes.packs
    first = tch.scene_planes(ts)
    assert tch.scene_planes(ts) is not first
    assert tch.scene_planes.packs == before + 2 and not tch._plane_cache
    with tch.plane_scope():
        planes = tch.scene_planes(ts)
        with tch.plane_scope():
            assert tch.scene_planes(ts) is planes
        assert tch.scene_planes(ts) is planes and tch._plane_cache
    assert not tch._plane_cache and tch.scene_planes.packs == before + 3
    with pytest.raises(RuntimeError), tch.plane_scope():
        tch.scene_planes(ts)
        raise RuntimeError("a call that fails")
    assert not tch._plane_cache and tch._scope_depth == 0


@pytest.mark.parametrize("field", ["tri_v0", "tri_albedo", "sphere_radius",
                                   "tri_valid"])
def test_cache_repacks_after_an_in_place_update(field):
    _, ts = _scenes("room")
    with tch.plane_scope():
        planes = tch.scene_planes(ts)
        before = tch.scene_planes.packs
        getattr(ts, field).mul_(0.5)
        again = tch.scene_planes(ts)
        assert again is not planes and tch.scene_planes.packs == before + 1
        fresh = tch.ScenePlanes(ts)
        for k in ("sph", "geo", "tri", "clu", "sup"):
            assert torch.equal(getattr(again, k), getattr(fresh, k)), k
        assert tch.scene_planes(ts) is again


def test_cache_repacks_for_a_new_scene_and_a_replaced_leaf():
    _, ts = _scenes("room")
    with tch.plane_scope():
        planes = tch.scene_planes(ts)
        before = tch.scene_planes.packs
        _, other = _scenes("room")          # equal values, other tensors
        assert tch.scene_planes(other) is not planes
        moved = dataclasses.replace(ts, tri_v0=ts.tri_v0 + 1.0)
        got = tch.scene_planes(moved)
        assert tch.scene_planes.packs == before + 2
        assert torch.equal(got.geo[:, 0:3], ts.tri_v0 + 1.0)
        # one entry per device: the first scene packs again
        assert tch.scene_planes(ts) is not planes
        assert tch.scene_planes.packs == before + 3


def test_cache_holds_no_graph_and_follows_an_optimizer_step():
    """Leaves that require grad pack into planes that do not; an
    optimizer's in-place step makes the next query pack anew, with the
    stepped values."""
    _, ts = _scenes("room")
    leaves = {k: getattr(ts, k).clone().requires_grad_(True)
              for k in ("tri_v0", "tri_albedo", "sphere_center")}
    scene = dataclasses.replace(ts, **leaves)
    with tch.plane_scope():
        planes = tch.scene_planes(scene)
        for k in ("sph", "geo", "tri", "clu", "sup"):
            x = getattr(planes, k)
            assert not x.requires_grad and x.grad_fn is None, k
        assert not planes.block_boxes(16).requires_grad
        assert tch.scene_planes(scene) is planes
        opt = torch.optim.Adam(list(leaves.values()), lr=1e-2)
        for p in leaves.values():
            p.grad = torch.ones_like(p)
        before = tch.scene_planes.packs
        opt.step()
        stepped = tch.scene_planes(scene)
        assert stepped is not planes and tch.scene_planes.packs == before + 1
        assert not stepped.geo.requires_grad
        assert torch.equal(stepped.geo[:, 0:3], leaves["tri_v0"].detach())
        assert not torch.equal(stepped.geo, planes.geo)


def _table_from_planes(planes):
    """The merged attribute table as the kernel copies it out of the
    packed planes (its copy maps), zero where it holds no column."""
    sph_map, tri_map = tch._attr_copy_maps()
    parts = []
    for plane, pairs in ((planes.sph, sph_map), (planes.tri, tri_map)):
        table = plane.new_zeros((plane.shape[0], merged_width(False)))
        for row, col in pairs:
            table[:, row] = plane[:, col]
        parts.append(table)
    return torch.cat(parts)


def planes_path_on_cpu(monkeypatch):
    """The kernels' path on the CPU, with the closest hits computed from
    the scene's cached planes as the kernel reads them: the plain version
    fed ``scene_planes(scene)``'s sphere and triangle planes and the
    winner rows copied out of them. A stale cache shows in the image."""
    kernel_path_on_cpu(monkeypatch)
    real = tch.nearest_hit_attrs_reference
    queries = []

    def from_planes(scene, o, d, t_min=1e-4, alive=None, want_attrs=True):
        planes = tch.scene_planes(scene)
        queries.append(planes)
        with monkeypatch.context() as m:
            m.setattr(tch, "_pack_spheres", lambda s: planes.sph)
            m.setattr(tch, "_pack_tris", lambda s: planes.tri)
            m.setattr(tch, "_pack_attrs",
                      lambda s: _table_from_planes(planes))
            return real(scene, o, d, t_min, alive, want_attrs)

    monkeypatch.setattr(tch, "nearest_hit_attrs_reference", from_planes)
    return queries


WRITE_PARAMS = dict(width=24, height=16, bounces=1, skybox=True)


@pytest.mark.parametrize("route", ["data", "set_"])
def test_cache_sees_a_write_through_data(route, monkeypatch):
    """A write that autograd does not see (through ``.data``, which keeps
    ``_version``, or ``set_``) between two renders on the kernels' path is
    seen: the planes live one call. The second image is the written
    scene's (the plain path's render of it) and differs from the first."""
    _, ts, cam = scene_pair("metal")
    queries = planes_path_on_cpu(monkeypatch)
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    params = trt.RenderParams(backend="cuda", **WRITE_PARAMS)
    first = tr.render_frame(ts, basis, params, 0)
    assert len(queries) == params.bounces + 1
    assert len({id(q) for q in queries}) == 1     # one packing a call
    if route == "data":
        ts.sphere_albedo.data.mul_(0.5)
    else:
        ts.sphere_albedo.set_(ts.sphere_albedo * 0.5)
    second = tr.render_frame(ts, basis, params, 0)
    want = tr.render_frame(ts, basis, params.replace(backend="torch"), 0)
    assert torch.equal(second, want)
    assert not torch.equal(second, first)


def test_cache_sees_an_in_place_write_within_a_scope(monkeypatch):
    """Within one scope, an in-place write that autograd sees (it bumps
    ``_version``) repacks the next query: the second render inside the
    scope shows it."""
    _, ts, cam = scene_pair("metal")
    planes_path_on_cpu(monkeypatch)
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    params = trt.RenderParams(backend="cuda", **WRITE_PARAMS)
    with tch.plane_scope():
        before = tch.scene_planes.packs
        first = tr.render_frame(ts, basis, params, 0)
        ts.sphere_albedo.mul_(0.5)
        second = tr.render_frame(ts, basis, params, 0)
        assert tch.scene_planes.packs == before + 2
    want = tr.render_frame(ts, basis, params.replace(backend="torch"), 0)
    assert torch.equal(second, want)
    assert not torch.equal(second, first)
