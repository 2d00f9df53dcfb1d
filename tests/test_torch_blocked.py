"""Port parity: the streaming closest-hit search (large scenes) and the
dispatch that sends scenes past the crossover to it.

The port's plain streaming version (the CUDA kernel's CPU counterpart) is
held to the reference's streaming Pallas kernel, forced onto a small random
mesh with 1024-triangle blocks and run in interpret mode on the CPU as the
reference's own tests run it (``tests/test_blocked.py``), and to
``nearest_hit_jnp`` on axis-parallel rays (ROADMAP §C.1: the reference's
streaming kernel can drop a block there).

Tolerances: hit masks are exact; t within ``T_RTOL`` (XLA's CPU compiler
contracts multiply-adds, the port rounds every product, as its kernel,
built with -fmad=false, does); ids equal except where the two t agree
within that tolerance (the reference's streaming kernel resolves ties
across blocks in its visiting order, the port by the lowest id), at most
``MAX_MISMATCHES`` lanes; rows bit-equal where the ids agree and zero on
misses. The plain streaming version equals the closest-hit plain version
bit for bit, ties included. On the card the kernel is held to its plain
version (``cuda``-marked test, and ``chip_smoke.py``).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.ops import intersect as jint
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu_torch.ops import anyhit as tah
from ray_tracer_tpu_torch.ops import blocked_hit as tbh
from ray_tracer_tpu_torch.ops import closest_hit as tch
from ray_tracer_tpu_torch.ops import intersect as tint

from test_torch_common import (probe_rays, secondary_rays, t_, terrain,
                               tied, to_port)
from test_torch_intersect import T_RTOL
from test_torch_scatter import _float_leaves, _grads, _hit_loss

SMALL_BLOCK = 1024
# the reference's streaming kernel at the same block size, on any scene
STREAMING_CFG = jpk.KConfig(tri_block=SMALL_BLOCK, blocked="force")
MAX_MISMATCHES = 2
CROSSOVER = 24_576   # padded triangles, the last count on the resident side


def _mesh(n_tris=2400, seed=3):
    """The random mesh of tests/test_blocked.py (2,432 padded triangles:
    three blocks of 1024) with six spheres, in both packages."""
    rng = np.random.default_rng(seed)
    b = jrt.SceneBuilder()
    for _ in range(n_tris):
        c = rng.normal(size=3) * 4.0
        v = c + rng.normal(size=(3, 3))
        n = np.cross(v[1] - v[0], v[2] - v[0])
        n /= max(np.linalg.norm(n), 1e-9)
        b.add_mesh([tuple(x) for x in v], [tuple(n)] * 3, [0, 1, 2],
                   albedo=tuple(rng.random(3)),
                   smoothness=float(rng.random()))
    for _ in range(6):
        b.add_sphere(tuple(rng.normal(size=3) * 4.0), 0.5 + rng.random(),
                     albedo=tuple(rng.random(3)))
    js = b.build(pad=128)
    return js, to_port(js)


def _random_rays(n, seed, spread=8.0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _tied(ts):
    """``ts`` with triangles [1024, 2048) made copies of [0, 1024): a ray
    that hits one of a pair hits the other at the same t, in another
    1024-triangle block."""
    return tied(ts, 1024)


@pytest.fixture(scope="module")
def large():
    """The test terrain at n=112 (24,642 triangles, 24,704 padded): the
    smallest terrain past the crossover, in both packages, with 256 probe
    rays, about 70% of them alive."""
    js, cam = terrain(jrt, n=112)
    o, d = probe_rays(cam, 256, seed=21)
    alive = np.random.default_rng(22).random(256) < 0.7
    return js, to_port(js), o, d, alive


@pytest.mark.parametrize("want_attrs", [True, False], ids=["attrs", "ids"])
def test_plain_blocked_matches_pallas_streaming(want_attrs):
    js, ts = _mesh()
    o, d = _random_rays(384, seed=11)
    call = (jpk.nearest_hit_attrs_pallas if want_attrs
            else jpk.nearest_hit_pallas)
    want = [np.asarray(x) for x in call(js, jnp.asarray(o), jnp.asarray(d),
                                        1e-4, cfg=STREAMING_CFG)]
    got = [x.numpy() for x in tbh.nearest_hit_blocked_reference(
        ts, t_(o), t_(d), 1e-4, want_attrs=want_attrs, block=SMALL_BLOCK)]
    assert len(got) == len(want) == (3 if want_attrs else 2)
    hit = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    assert hit.sum() > 30
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=T_RTOL)
    same = got[1] == want[1]
    assert int((hit & ~same).sum()) <= MAX_MISMATCHES
    assert np.all(got[1][~hit] == 0) and np.all(want[1][~hit] == 0)
    if want_attrs:
        np.testing.assert_array_equal(got[2][:, same], want[2][:, same])
        assert not got[2][:, ~hit].any() and not want[2][:, ~hit].any()


def test_plain_blocked_matches_jnp_on_axis_parallel_rays():
    js, ts = _mesh(seed=4)
    rng = np.random.default_rng(12)
    o = (rng.normal(size=(384, 3)) * 6.0).astype(np.float32)
    d = np.zeros((384, 3), np.float32)
    d[np.arange(384), rng.integers(0, 3, 384)] = rng.choice([-1.0, 1.0], 384)
    t_j, id_j = (np.asarray(x) for x in jint.nearest_hit_jnp(
        js, jnp.asarray(o), jnp.asarray(d), 1e-4))
    t_p, id_p = (x.numpy() for x in tbh.nearest_hit_blocked_reference(
        ts, t_(o), t_(d), 1e-4, want_attrs=False, block=SMALL_BLOCK))
    hit = np.isfinite(t_j)
    np.testing.assert_array_equal(np.isfinite(t_p), hit)
    assert hit.sum() > 30
    np.testing.assert_array_equal(id_p[hit], id_j[hit])
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=T_RTOL)


@pytest.mark.parametrize("block", [SMALL_BLOCK, tbh.BLOCK])
def test_plain_blocked_equals_plain_closest_hit(block):
    """Bit for bit, ties across blocks included: the lower id of each
    tied pair wins in both."""
    _, ts = _mesh()
    ts = _tied(ts)
    o, d = _random_rays(384, seed=13)
    alive = t_(np.random.default_rng(14).random(384) < 0.8)
    got = tbh.nearest_hit_blocked_reference(ts, t_(o), t_(d), 1e-4, alive,
                                            block=block)
    want = tch.nearest_hit_attrs_reference(ts, t_(o), t_(d), 1e-4, alive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    t, ids = got[0], got[1] - ts.padded_spheres
    ties = torch.isfinite(t) & (ids >= 0) & (ids < 1024)
    assert int(ties.sum()) > 10


def test_plain_blocked_past_64_blocks_equals_plain_closest_hit():
    """A heightfield of 65 blocks of 1024 (n=183: 66,248 triangles), more
    than the kernel stages in one round of block boxes: the plain version
    equals the closest-hit plain version bit for bit on random and
    secondary rays."""
    ts = terrain(trt, n=183)[0]
    assert ts.num_tris == 66_248
    assert tbh.block_layout(ts, SMALL_BLOCK)[2] == 65
    o, d = (t_(np.concatenate([a, b])) for a, b in zip(
        _random_rays(256, seed=25, spread=4.0),
        secondary_rays(ts, 256, seed=26)))
    alive = t_(np.random.default_rng(24).random(512) < 0.8)
    got = tbh.nearest_hit_blocked_reference(ts, o, d, 1e-4, alive,
                                            block=SMALL_BLOCK)
    want = tch.nearest_hit_attrs_reference(ts, o, d, 1e-4, alive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(torch.isfinite(got[0]).sum()) > 50


def test_plain_blocked_alive_mask_ragged_and_all_dead():
    """Dead lanes miss (inf, 0, zero row); 200 rays (no multiple of the
    block or of a warp); an all-dead call and an empty one."""
    _, ts = _mesh(1200, seed=6)
    o, d = (t_(x) for x in _random_rays(200, seed=14))
    alive = torch.arange(200) % 3 != 0
    t, pid, rows = tbh.nearest_hit_blocked_reference(ts, o, d, 1e-4, alive,
                                                     block=SMALL_BLOCK)
    assert bool(torch.isinf(t[~alive]).all()) and not bool(pid[~alive].any())
    assert not bool(rows[:, ~alive].any())
    want = tch.nearest_hit_attrs_reference(ts, o, d, 1e-4, alive)
    assert all(torch.equal(g, w) for g, w in zip((t, pid, rows), want))
    assert int(torch.isfinite(t).sum()) > 10
    t, pid, rows = tbh.nearest_hit_blocked_reference(
        ts, o, d, 1e-4, torch.zeros(200, dtype=torch.bool))
    assert bool(torch.isinf(t).all()) and not bool(pid.any())
    assert not bool(rows.any())
    t, pid, rows = tbh.nearest_hit_blocked_reference(ts, o[:0], d[:0])
    assert t.shape == pid.shape == (0,) and rows.shape == (26, 0)


@pytest.mark.parametrize("padded", [24_320, CROSSOVER, 24_704])
def test_uses_blocked_is_the_reference_crossover(padded):
    scene = types.SimpleNamespace(padded_tris=padded)
    assert tbh.uses_blocked(scene) == (padded > CROSSOVER)
    assert tbh.uses_blocked(scene) == jpk._use_blocked(scene, jpk.KConfig())


@pytest.mark.parametrize("n,padded", [(111, 24_320), (112, 24_704)])
def test_terrain_straddles_the_crossover(n, padded, large):
    js = large[0] if n == 112 else terrain(jrt, n=n)[0]
    ts = large[1] if n == 112 else to_port(js)
    assert js.padded_tris == ts.padded_tris == padded
    assert tbh.uses_blocked(ts) == jpk._use_blocked(js, jpk.KConfig())
    assert tbh.uses_blocked(ts) == (n == 112)


def _spy(monkeypatch, module, name, calls):
    """Replace ``module.name`` by a pass-through that records (name,
    whether it returned rows)."""
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((name, isinstance(out, tuple) and len(out) == 3))
        return out

    monkeypatch.setattr(module, name, spy)


def test_large_scene_closest_hit_takes_the_streaming_version(large,
                                                            monkeypatch):
    """fused_intersect on a scene past the crossover goes through the
    streaming plain version (never the closest-hit one) and gives the
    oracle route's hits."""
    _, ts, o, d, alive = large
    o, d, alive = t_(o), t_(d), t_(alive)
    calls = []
    _spy(monkeypatch, tbh, "nearest_hit_blocked_reference", calls)
    _spy(monkeypatch, tch, "nearest_hit_attrs_reference", calls)
    h = tint.fused_intersect(ts, o, d, 1e-4, alive)
    assert calls == [("nearest_hit_blocked_reference", True)]
    ref = tint.intersect(ts, o, d, backend="torch")
    assert torch.equal(h.hit, ref.hit & alive) and int(h.hit.sum()) > 50
    for k in ("t", "point", "normal", "albedo", "smoothness"):
        assert torch.equal(getattr(h, k)[h.hit], getattr(ref, k)[h.hit]), k


def test_large_scene_gradient_matches_oracle_route(large):
    """The scene gradient through the streaming version's rows and the
    scatter-add backward equals the oracle route's (hit_attributes), every
    float leaf."""
    _, ts, o, d, _ = large
    leaves = _float_leaves(ts)
    s = dataclasses.replace(ts, **leaves)
    g_fused = _grads(_hit_loss(tint.fused_intersect(s, t_(o), t_(d), 1e-4,
                                                    None)), leaves)
    g_oracle = _grads(_hit_loss(tint.intersect(s, t_(o), t_(d),
                                               backend="torch")), leaves)
    for k in leaves:
        np.testing.assert_allclose(g_fused[k].numpy(), g_oracle[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert bool(g_fused["tri_v0"].any()) and bool(g_fused["tri_albedo"].any())


def test_large_scene_occlusion_takes_the_streaming_version(large,
                                                          monkeypatch):
    """The "cuda" backend's shadow query on a scene past the crossover is
    the streaming closest hit without rows against the segment's end (not
    the any-hit kernel), and agrees with the reference's jnp occluded."""
    js, ts, o, d, alive = large
    t, _ = tbh.nearest_hit_blocked_reference(ts, t_(o), t_(d),
                                             want_attrs=False)
    p = (o + d * np.where(np.isinf(t.numpy()), 0.0, t.numpy())[:, None])
    rng = np.random.default_rng(23)
    seg = (p.mean(0) + rng.normal(size=p.shape) * 3.0 - p).astype(np.float32)
    p = p.astype(np.float32)
    calls = []
    _spy(monkeypatch, tbh, "nearest_hit_blocked_reference", calls)
    _spy(monkeypatch, tah, "anyhit_reference", calls)
    got = tint.occluded_kernels(ts, t_(p), t_(seg), 1e-4, t_(alive)).numpy()
    assert calls == [("nearest_hit_blocked_reference", False)]
    want = np.asarray(jint.occluded(js, jnp.asarray(p), jnp.asarray(seg),
                                    backend="jnp"))
    assert not got[~alive].any()
    assert int((got != want)[alive].sum()) <= MAX_MISMATCHES
    assert 0.05 < got[alive].mean() < 0.95


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["resident", "streaming"])
def test_queries_look_up_the_kernel_wrappers_at_call_time(streaming,
                                                          monkeypatch):
    """The benchmark counts live lanes by replacing the wrappers as module
    attributes (``rtbench/core.live_lanes``): ``fused_intersect`` and
    ``occluded_kernels`` must reach each through its module at call time,
    on both sides of the crossover (forced here on a small mesh)."""
    _, ts = _mesh(300)
    o, d = (t_(x) for x in _random_rays(64, seed=24))
    alive = torch.ones(64, dtype=torch.bool)
    calls = []
    for module, name in ((tch, "nearest_hit_attrs"),
                         (tbh, "nearest_hit_blocked"), (tah, "anyhit")):
        def counted(*a, _name=name, _true=getattr(module, name), **kw):
            calls.append(_name)
            return _true(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    monkeypatch.setattr(tbh, "uses_blocked", lambda scene: streaming)
    tint.fused_intersect(ts, o, d, 1e-4, alive)
    tint.occluded_kernels(ts, o, d, 1e-4, alive)
    assert calls == (["nearest_hit_blocked"] * 2 if streaming
                     else ["nearest_hit_attrs", "anyhit"])


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    _, ts = _mesh(300)
    o, d = (t_(x) for x in _random_rays(64, seed=15))
    before = (tbh.nearest_hit_blocked.launches,
              tbh.nearest_hit_blocked.ids_launches)
    for want_attrs in (True, False):
        got = tbh.nearest_hit_blocked(ts, o, d, want_attrs=want_attrs)
        want = tbh.nearest_hit_blocked_reference(ts, o, d,
                                                 want_attrs=want_attrs)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tbh.nearest_hit_blocked.launches,
            tbh.nearest_hit_blocked.ids_launches) == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, ts = _mesh(300)
    o, d = (t_(x) for x in _random_rays(8, seed=16))
    with pytest.raises(ValueError, match="no streaming closest-hit kernel"):
        tbh.nearest_hit_blocked(ts, o.to("meta"), d.to("meta"))
    with pytest.raises(ValueError, match="multiple of the 64-triangle"):
        tbh.nearest_hit_blocked(ts, o, d, block=1000)


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
def test_kernel_matches_plain_version_on_cuda(cuda_device):
    """The CUDA kernel against its plain version and against the
    closest-hit kernel on the card, both want_attrs variants, blocks of
    1024 and 8192, ties across blocks and across supers included, on
    random rays and on secondary rays (origins inside the scene, random
    directions, where the lanes of a warp diverge): at most 2 id
    mismatches, t and rows bit-equal where the ids agree, dead and miss
    lanes (inf, 0, zero row); the same against the plain version on a
    scene of more than 64 blocks, whose boxes the kernel stages in
    rounds."""
    _, ts = _mesh()
    scenes = {"mesh": ts.to(cuda_device),
              "tied": _tied(ts).to(cuda_device),
              "tied-supers": tied(ts, 512).to(cuda_device),
              "terrain": terrain(trt, n=60)[0].to(cuda_device)}
    alive = t_(np.random.default_rng(18).random(4096) < 0.7).to(cuda_device)
    cases = [(name, s, _random_rays(4096, seed=17))
             for name, s in scenes.items()]
    cases += [(name + " secondary", s, secondary_rays(s, 4096, seed=19))
              for name, s in scenes.items()]
    for name, s, rays in cases:
        o, d = (t_(x).to(cuda_device) for x in rays)
        for block in (SMALL_BLOCK, tbh.BLOCK):
            for want_attrs in (True, False):
                before = tbh.nearest_hit_blocked.launches
                got = tbh.nearest_hit_blocked(s, o, d, 1e-4, alive,
                                              want_attrs, block)
                assert tbh.nearest_hit_blocked.launches == before + 1
                for want in (tbh.nearest_hit_blocked_reference(
                        s, o, d, 1e-4, alive, want_attrs, block),
                        tch.nearest_hit_attrs(s, o, d, 1e-4, alive,
                                              want_attrs)):
                    same = got[1] == want[1]
                    assert int((~same).sum()) <= MAX_MISMATCHES, name
                    assert torch.equal(got[0][same], want[0][same]), name
                    if want_attrs:
                        assert torch.equal(got[2][:, same],
                                           want[2][:, same]), name
                miss = torch.isinf(got[0])
                assert bool(miss[~alive].all())
                assert not bool(got[1][miss].any())
                if want_attrs:
                    assert not bool(got[2][:, miss].any())
    # past 64 blocks (one cluster a block: 109 blocks), the block boxes
    # staged in two rounds
    s = scenes["terrain"]
    assert tbh.block_layout(s, 64)[2] > 64
    for rays in (_random_rays(4096, seed=17), secondary_rays(s, 4096, 19)):
        o, d = (t_(x).to(cuda_device) for x in rays)
        for want_attrs in (True, False):
            got = tbh.nearest_hit_blocked(s, o, d, 1e-4, alive, want_attrs, 64)
            want = tbh.nearest_hit_blocked_reference(s, o, d, 1e-4, alive,
                                                     want_attrs, 64)
            same = got[1] == want[1]
            assert int((~same).sum()) <= MAX_MISMATCHES
            assert torch.equal(got[0][same], want[0][same])
            if want_attrs:
                assert torch.equal(got[2][:, same], want[2][:, same])
    # the tied scenes do tie: some winner has a copy a super or a block on
    for name, n in (("tied", 1024), ("tied-supers", 512)):
        o, d = (t_(x).to(cuda_device) for x in _random_rays(4096, seed=17))
        t, ids = tbh.nearest_hit_blocked(scenes[name], o, d,
                                         want_attrs=False)
        ids = ids - ts.padded_spheres
        assert int((torch.isfinite(t) & (ids >= 0) & (ids < n)).sum()) > 10
        assert not bool((torch.isfinite(t) & (ids >= n) & (ids < 2 * n)).any())


@pytest.mark.cuda
def test_textured_kernel_matches_plain_version_on_cuda(cuda_device):
    """The streaming kernel's textured variant (40-column rows) against
    its plain version and the closest-hit kernel's textured variant on the
    card, blocks of 1024 and 8192, on the 2,200-triangle textured mesh
    and the textured terrain, random and secondary rays: 0 mismatches in
    t, id and all 40 row columns."""
    from test_torch_texture import _textured_mesh
    scenes = {"mesh_tex": _textured_mesh()[1].to(cuda_device),
              "terrain_tex": terrain(trt, n=60,
                                     textured=True)[0].to(cuda_device)}
    alive = t_(np.random.default_rng(18).random(4096) < 0.7).to(cuda_device)
    for name, s in scenes.items():
        for rays in (_random_rays(4096, seed=17, spread=2.0),
                     secondary_rays(s, 4096, seed=19)):
            o, d = (t_(x).to(cuda_device) for x in rays)
            for block in (SMALL_BLOCK, tbh.BLOCK):
                before = tbh.nearest_hit_blocked.tex_launches
                got = tbh.nearest_hit_blocked(s, o, d, 1e-4, alive,
                                              block=block)
                assert tbh.nearest_hit_blocked.tex_launches == before + 1
                assert got[2].shape == (40, 4096)
                for want in (tbh.nearest_hit_blocked_reference(
                        s, o, d, 1e-4, alive, block=block),
                        tch.nearest_hit_attrs(s, o, d, 1e-4, alive)):
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), name
                assert int(torch.isfinite(got[0]).sum()) > 500, name
