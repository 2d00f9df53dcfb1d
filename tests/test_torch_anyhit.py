"""Port parity: the any-hit (shadow-ray) search and ``occluded``.

The port's plain any-hit version (the CUDA kernel's CPU counterpart) is
held to the reference's Pallas any-hit kernel, run in interpret mode on the
CPU as the reference's own tests run it (``anyhit_pallas`` auto-interprets
off-TPU), and the port's ``occluded(backend="torch")`` to the reference's
``occluded(backend="jnp")``.

Tolerance: at most 2 differing lanes per scene against the Pallas kernel,
since XLA's CPU compiler contracts multiply-adds and the port rounds every
product (as its kernel, built with -fmad=false, does), which can move a
grazing hit across a triangle edge or the segment's end. The oracle form
of ``occluded`` is held exactly. On the card the kernel is held to its
plain version on every lane (``cuda``-marked test, and ``chip_smoke.py``).
Ray counts stay below 16,384, where the reference's step lists would
engage, so that interpret mode stays fast.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.ops import intersect as jint
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu_torch.ops import anyhit as tah
from ray_tracer_tpu_torch.ops import intersect as tint

from test_torch_common import (probe_rays, scene_pair, secondary_rays, t_,
                               terrain, tied, to_port)

SCENES = ["room", "metal", "random_balls", "terrain"]
MAX_MISMATCHES = 2


def _segments(name, n=1024, seed=3):
    """Shadow segments: from the probe rays' first hits (or their origins,
    where they miss) to random points around the scene, about half of the
    lanes alive."""
    js, ts, cam = scene_pair(name)
    o, d = probe_rays(cam, n, seed)
    t, _ = jint.nearest_hit_jnp(js, jnp.asarray(o), jnp.asarray(d), 1e-4)
    t = np.where(np.isinf(np.asarray(t)), 0.0, np.asarray(t))
    p = (o + d * t[:, None]).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    target = (p.mean(0) + rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    alive = rng.random(n) < 0.5
    return js, ts, p, (target - p).astype(np.float32), alive


@pytest.mark.parametrize("scale", [1.0, 0.1], ids=["full", "short"])
@pytest.mark.parametrize("name", SCENES)
def test_plain_anyhit_matches_pallas(name, scale):
    js, ts, o, d, alive = _segments(name)
    d = (d * scale).astype(np.float32)
    want = np.asarray(jpk.anyhit_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                        alive=jnp.asarray(alive)))
    got = tah.anyhit_reference(ts, t_(o), t_(d), alive=t_(alive)).numpy()
    assert got.dtype == np.bool_ and got.shape == (len(o),)
    assert not got[~alive].any() and not want[~alive].any()
    assert int((got != want).sum()) <= MAX_MISMATCHES
    if scale == 1.0:
        assert 0.05 < got[alive].mean() < 0.95   # both answers occur


@pytest.mark.parametrize("name", SCENES)
def test_occluded_oracle_matches_jnp(name):
    js, ts, o, d, alive = _segments(name, seed=5)
    want = np.asarray(jint.occluded(js, jnp.asarray(o), jnp.asarray(d),
                                    backend="jnp", alive=jnp.asarray(alive)))
    got = tint.occluded(ts, t_(o), t_(d), backend="torch", alive=t_(alive))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale", [1.0, 0.1], ids=["full", "short"])
def test_plain_anyhit_matches_pallas_on_secondary_segments(scale):
    """Shadow segments as a bounce leaves them (origins inside the scene,
    random directions) on the terrain at n=24: 1,058 triangles and 3
    spheres, fewer real spheres than the 128 padded rows."""
    js = terrain(jrt, n=24)[0]
    ts = to_port(js)
    assert ts.num_tris == 1058 and ts.num_spheres == 3
    assert ts.padded_spheres == 128
    o, d = secondary_rays(ts, 512, seed=27)
    d = (d * scale).astype(np.float32)
    alive = np.random.default_rng(28).random(512) < 0.7
    want = np.asarray(jpk.anyhit_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                        alive=jnp.asarray(alive)))
    got = tah.anyhit_reference(ts, t_(o), t_(d), alive=t_(alive)).numpy()
    assert not got[~alive].any() and not want[~alive].any()
    assert int((got != want).sum()) <= MAX_MISMATCHES
    if scale == 1.0:
        assert 0.05 < got[alive].mean() < 0.95   # both answers occur


def test_plain_anyhit_chunking_is_invisible(monkeypatch):
    _, ts, o, d, alive = _segments("terrain", seed=9)
    whole = tah.anyhit_reference(ts, t_(o), t_(d), alive=t_(alive))
    monkeypatch.setattr(tint, "_PAIR_BUDGET", 1000)
    assert torch.equal(whole, tah.anyhit_reference(ts, t_(o), t_(d),
                                                   alive=t_(alive)))


def test_plain_anyhit_equals_oracle_where_the_tests_agree():
    """Without the alive mask and away from grazing hits the any-hit
    answer is the closest hit compared with the segment's end."""
    _, ts, o, d, _ = _segments("room", seed=13)
    got = tah.anyhit_reference(ts, t_(o), t_(d))
    t, _ = tint.nearest_hit(ts, t_(o), t_(d), 1e-4)
    assert int((got != (t < tah.SHADOW_T_MAX)).sum()) <= MAX_MISMATCHES


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    _, ts, o, d, alive = _segments("room", n=64)
    before = tah.anyhit.launches
    got = tah.anyhit(ts, t_(o), t_(d), alive=t_(alive))
    assert torch.equal(got, tah.anyhit_reference(ts, t_(o), t_(d),
                                                 alive=t_(alive)))
    assert tah.anyhit.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, ts, o, d, _ = _segments("room", n=8)
    with pytest.raises(ValueError, match="no any-hit kernel"):
        tah.anyhit(ts, t_(o).to("meta"), t_(d).to("meta"))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda(cuda_device):
    """The CUDA kernel against its plain version on the card, every lane,
    full and short segments; dead lanes False; bad input raises."""
    for name in SCENES:
        _, ts, o, d, alive = _segments(name, n=4096)
        ts = ts.to(cuda_device)
        o, d, alive = (t_(x).to(cuda_device) for x in (o, d, alive))
        for scale in (1.0, 0.1):
            before = tah.anyhit.launches
            got = tah.anyhit(ts, o, d * scale, alive=alive)
            want = tah.anyhit_reference(ts, o, d * scale, alive=alive)
            assert tah.anyhit.launches == before + 1
            assert torch.equal(got, want), name
            assert not bool(got[~alive].any()), name
    with pytest.raises(ValueError):
        tah.anyhit(ts, o.double(), d.double())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_hierarchy_scenes(cuda_device):
    """The streaming kernel's card-test scenes (the random mesh, its copies
    tied across 1024-triangle blocks and across supers, the terrain at
    n=60) on random and secondary rays (origins inside the scene: the
    lanes of a warp diverge and block at different clusters), segments as
    they are and scaled by 0.1: every lane equal to the plain version."""
    from test_torch_blocked import _mesh, _random_rays
    _, ts = _mesh()
    scenes = {"mesh": ts, "tied": tied(ts, 1024),
              "tied-supers": tied(ts, 512), "terrain": terrain(trt, n=60)[0]}
    alive = t_(np.random.default_rng(18).random(4096) < 0.7).to(cuda_device)
    for name, s in scenes.items():
        s = s.to(cuda_device)
        blocked = 0
        for rays in (_random_rays(4096, seed=17),
                     secondary_rays(s, 4096, seed=19)):
            o, d = (t_(x).to(cuda_device) for x in rays)
            for scale in (1.0, 0.1):
                got = tah.anyhit(s, o, d * scale, alive=alive)
                want = tah.anyhit_reference(s, o, d * scale, alive=alive)
                assert torch.equal(got, want), (name, scale)
                assert not bool(got[~alive].any()), name
                blocked += int(got.sum())
        assert blocked > 100, name


@pytest.mark.cuda
def test_kernel_refuses_a_scene_whose_boxes_exceed_shared_memory(cuda_device):
    """The kernel keeps every cluster and super box in shared memory, as
    the closest-hit kernel does: a scene of 5,228 clusters (the terrain at
    n=410, 334,562 triangles) does not fit and the wrapper raises instead
    of launching; the shadow query sends such a scene, past the streaming
    crossover, to the streaming kernel."""
    from ray_tracer_tpu_torch.ops import blocked_hit as tbh
    ts = terrain(trt, n=410)[0].to(cuda_device)
    o, d = (t_(x).to(cuda_device) for x in secondary_rays(ts, 256, 3))
    before = tah.anyhit.launches
    with pytest.raises(ValueError, match="shared memory"):
        tah.anyhit(ts, o, d)
    assert tah.anyhit.launches == before
    assert tbh.uses_blocked(ts)
    assert tint.occluded_kernels(ts, o, d, 1e-4, None).shape == (256,)
