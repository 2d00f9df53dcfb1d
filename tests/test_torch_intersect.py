"""Port parity: closest-hit search and winner recompute.

The port's plain closest-hit version (the CUDA kernel's CPU counterpart)
is held to the reference's Pallas kernel, run in interpret mode on the CPU
as the reference's own tests run it (nearest_hit_attrs_pallas
auto-interprets off-TPU), and the port's oracle to ``nearest_hit_jnp``.

Tolerances: hit masks and winner ids are exact; the winners' merged-table
rows are exact (both sides copy the same stored values). Distances t are
held at rtol 1e-4: XLA's CPU compiler contracts a*b + c into fused
multiply-adds, the port rounds every product (as its kernel, built with
-fmad=false, does), and near-tangent sphere hits amplify that last-bit
difference through sqrt(b² - 4ac) (measured up to 2.7e-5 relative).
The kernel itself is held bit-exact to the plain version on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.ops import intersect as jint
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu_torch.ops import closest_hit as tch
from ray_tracer_tpu_torch.ops import intersect as tint

from test_torch_common import (probe_rays, scene_pair, secondary_rays, t_,
                               terrain, tied)

SCENES = ["room", "random_balls", "mesh80", "terrain"]
T_RTOL = 1e-4


def _inputs(name, n=768, seed=1):
    js, ts, cam = scene_pair(name)
    o, d = probe_rays(cam, n, seed)
    alive = np.random.default_rng(seed + 1).random(n) < 0.7
    return js, ts, o, d, alive


def _check_hits(t_p, id_p, t_j, id_j):
    hit = ~np.isinf(t_j)
    np.testing.assert_array_equal(~np.isinf(t_p), hit)
    assert hit.sum() > 20
    np.testing.assert_array_equal(id_p[hit], id_j[hit])
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=T_RTOL)
    return hit


@pytest.mark.parametrize("name", SCENES)
def test_plain_closest_hit_matches_pallas(name):
    js, ts, o, d, alive = _inputs(name)
    t_j, id_j, rows_j = (np.asarray(x) for x in jpk.nearest_hit_attrs_pallas(
        js, jnp.asarray(o), jnp.asarray(d), 1e-4, alive=jnp.asarray(alive)))
    t_p, id_p, rows_p = (x.numpy() for x in tch.nearest_hit_attrs_reference(
        ts, t_(o), t_(d), 1e-4, t_(alive)))
    assert rows_p.shape == rows_j.shape == (26, len(o))
    hit = _check_hits(t_p, id_p, t_j, id_j)
    assert not hit[~alive].any()                   # dead lanes never hit
    np.testing.assert_array_equal(rows_p, rows_j)  # incl. zero miss rows
    for t, ids, rows in ((t_p, id_p, rows_p), (t_j, id_j, rows_j)):
        assert np.all(ids[~hit] == 0) and not rows[:, ~hit].any()


def test_plain_closest_hit_ids_only_matches_pallas():
    """The want_attrs=False variant (nearest_hit_pallas)."""
    js, ts, o, d, alive = _inputs("room", seed=4)
    t_j, id_j = (np.asarray(x) for x in jpk.nearest_hit_pallas(
        js, jnp.asarray(o), jnp.asarray(d), 1e-4, alive=jnp.asarray(alive)))
    out = tch.nearest_hit_attrs_reference(ts, t_(o), t_(d), 1e-4, t_(alive),
                                          want_attrs=False)
    assert len(out) == 2
    hit = _check_hits(out[0].numpy(), out[1].numpy(), t_j, id_j)
    assert np.all(out[1].numpy()[~hit] == 0)


@pytest.mark.parametrize("name", SCENES)
def test_oracle_nearest_hit_matches_jnp(name):
    js, ts, o, d, _ = _inputs(name, seed=7)
    t_j, id_j = (np.asarray(x) for x in jint.nearest_hit_jnp(
        js, jnp.asarray(o), jnp.asarray(d), 1e-4))
    t_p, id_p = (x.numpy() for x in tint.nearest_hit(ts, t_(o), t_(d), 1e-4))
    assert id_p.dtype == np.int32
    _check_hits(t_p, id_p, t_j, id_j)


def test_oracle_chunking_is_invisible(monkeypatch):
    """nearest_hit's ray chunks do not change its answer."""
    _, ts, o, d, _ = _inputs("terrain", seed=9)
    whole = tint.nearest_hit(ts, t_(o), t_(d), 1e-4)
    monkeypatch.setattr(tint, "_PAIR_BUDGET", 1000)
    chunked = tint.nearest_hit(ts, t_(o), t_(d), 1e-4)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SCENES)
def test_hit_attributes_from_rows_matches(name):
    """Same winners and rows through both recomputes, field by field."""
    js, ts, o, d, _ = _inputs(name, seed=11)
    t_j, id_j = jint.nearest_hit_jnp(js, jnp.asarray(o), jnp.asarray(d), 1e-4)
    miss = np.isinf(np.asarray(t_j))
    rows = np.asarray(jint._pack_attrs(js))[np.asarray(id_j)].T
    np.testing.assert_array_equal(
        tint._pack_attrs(ts).numpy(), np.asarray(jint._pack_attrs(js)))
    hj = jint.hit_attributes_from_rows(js, jnp.asarray(rows), jnp.asarray(o),
                                       jnp.asarray(d), id_j,
                                       jnp.asarray(miss), 1e-4)
    hp = tint.hit_attributes_from_rows(ts, t_(rows), t_(o), t_(d),
                                       t_(np.asarray(id_j)), t_(miss), 1e-4)
    hit = ~miss
    np.testing.assert_array_equal(hp.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(hp.prim_id.numpy(), np.asarray(hj.prim_id))
    for field in ("albedo", "emission", "emission_strength", "smoothness"):
        np.testing.assert_array_equal(getattr(hp, field).numpy(),
                                      np.asarray(getattr(hj, field)),
                                      err_msg=field)
    for field in ("t", "point", "normal"):
        np.testing.assert_allclose(getattr(hp, field).numpy()[hit],
                                   np.asarray(getattr(hj, field))[hit],
                                   rtol=T_RTOL, atol=1e-5, err_msg=field)
    assert np.isfinite(hp.normal.numpy()).all()


def test_packers_match_reference():
    js, ts, _, _, _ = _inputs("terrain")
    np.testing.assert_array_equal(tch._pack_spheres(ts).numpy(),
                                  np.asarray(jpk._pack_spheres(js)))
    tri_p, tri_j = tch._pack_tris(ts).numpy(), np.asarray(jpk._pack_tris(js))
    geo = np.r_[0:9, 12:32]            # all but the geometric normal
    np.testing.assert_array_equal(tri_p[:, geo], tri_j[:, geo])
    np.testing.assert_allclose(tri_p[:, 9:12], tri_j[:, 9:12], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(tch._cluster_aabbs(ts).numpy(),
                                  np.asarray(jpk._cluster_aabbs(js, 64)))
    assert tch._attr_copy_maps() == jpk._attr_copy_maps(False)
    cmap = tch._copy_map_tensor(torch.device("cpu"))
    assert cmap.shape == (2, 26) and cmap.dtype == torch.int32


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    _, ts, o, d, alive = _inputs("room", n=64)
    before = tch.nearest_hit_attrs.launches
    got = tch.nearest_hit_attrs(ts, t_(o), t_(d), 1e-4, t_(alive))
    want = tch.nearest_hit_attrs_reference(ts, t_(o), t_(d), 1e-4, t_(alive))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tch.nearest_hit_attrs.launches == before


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _assert_kernel_matches(ts, o, d, alive, label):
    """Both want_attrs variants of the kernel against the plain version."""
    for want_attrs in (True, False):
        got = tch.nearest_hit_attrs(ts, o, d, 1e-4, alive, want_attrs)
        ref = tch.nearest_hit_attrs_reference(ts, o, d, 1e-4, alive,
                                              want_attrs)
        same = got[1] == ref[1]
        assert int((~same).sum()) <= 2, label
        assert torch.equal(got[0][same], ref[0][same]), label
        if want_attrs:
            assert torch.equal(got[2][:, same], ref[2][:, same]), label
    return got


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda(cuda_device):
    """The CUDA kernel against its plain version on the card: ids, t and
    rows exact except where culling at a box boundary changes a winner; on
    camera and random rays, on secondary rays (origins inside the scene,
    random directions, where the lanes of a warp diverge), and on a mesh
    whose triangles tie across supers (the lower id of each pair wins)."""
    for name in SCENES:
        _, ts, o, d, alive = _inputs(name, n=4096)
        ts = ts.to(cuda_device)
        alive = t_(alive).to(cuda_device)
        for label, rays in ((name, (o, d)), (name + " secondary",
                                             secondary_rays(ts, 4096, 31))):
            o_c, d_c = (t_(x).to(cuda_device) for x in rays)
            _assert_kernel_matches(ts, o_c, d_c, alive, label)
    from test_torch_blocked import _mesh, _random_rays
    ts = tied(_mesh()[1], 512).to(cuda_device)
    o, d = (t_(x).to(cuda_device) for x in _random_rays(4096, seed=17))
    t, ids = _assert_kernel_matches(ts, o, d, None, "tied across supers")
    ids = ids - ts.padded_spheres
    assert int((torch.isfinite(t) & (ids >= 0) & (ids < 512)).sum()) > 10
    assert not bool((torch.isfinite(t) & (ids >= 512) & (ids < 1024)).any())


@pytest.mark.cuda
def test_kernel_refuses_a_scene_whose_boxes_exceed_shared_memory(cuda_device):
    """The resident kernel keeps every cluster and super box in shared
    memory: a scene of 5,228 clusters (the terrain at n=410, 334,562
    triangles) needs more than the card's 227 KB, and the wrapper raises
    instead of launching; the streaming kernel takes the same scene."""
    from ray_tracer_tpu_torch.ops import blocked_hit as tbh
    ts = terrain(trt, n=410)[0].to(cuda_device)
    o, d = (t_(x).to(cuda_device) for x in secondary_rays(ts, 256, 3))
    before = tch.nearest_hit_attrs.launches
    with pytest.raises(ValueError, match="shared memory"):
        tch.nearest_hit_attrs(ts, o, d)
    assert tch.nearest_hit_attrs.launches == before
    t, ids, rows = tbh.nearest_hit_blocked(ts, o, d)
    assert t.shape == (256,) and rows.shape == (26, 256)


@pytest.mark.cuda
def test_textured_kernel_matches_plain_version_on_cuda(cuda_device):
    """The kernel's textured variant (40-column rows copied from the
    48-column triangle planes) against its plain version on the card, on
    the textured terrain (camera and random rays, then secondary rays) and
    on its copy tied across supers: 0 mismatches in t, id and all 40 row
    columns; its launches counted apart from the untextured variants'."""
    ts, cam = terrain(trt, n=60, textured=True)
    o, d = probe_rays(cam, 4096, seed=5)
    alive = t_(np.random.default_rng(6).random(4096) < 0.7).to(cuda_device)
    for label, s in (("terrain_tex", ts), ("tied", tied(ts, 512))):
        s = s.to(cuda_device)
        for rays in ((o, d), secondary_rays(s, 4096, 31)):
            o_c, d_c = (t_(x).to(cuda_device) for x in rays)
            before = (tch.nearest_hit_attrs.launches,
                      tch.nearest_hit_attrs.tex_launches)
            got = tch.nearest_hit_attrs(s, o_c, d_c, 1e-4, alive)
            assert (tch.nearest_hit_attrs.launches,
                    tch.nearest_hit_attrs.tex_launches) == (
                        before[0], before[1] + 1)
            ref = tch.nearest_hit_attrs_reference(s, o_c, d_c, 1e-4, alive)
            assert got[2].shape == (40, 4096)
            for g, w in zip(got, ref):
                assert torch.equal(g, w), label
            assert int(torch.isfinite(got[0]).sum()) > 500
            assert bool((got[2][38] == 0).any())    # textured winners
