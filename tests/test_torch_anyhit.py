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

from ray_tracer_tpu.ops import intersect as jint
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu_torch.ops import anyhit as tah
from ray_tracer_tpu_torch.ops import intersect as tint

from test_torch_common import probe_rays, scene_pair, t_

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
