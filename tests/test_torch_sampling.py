"""Port parity: the counter-based RNG, sampling and primary rays.

The generator is integer arithmetic, so its words, states and uniforms are
bit-exact against the reference. Samplers built on log/cos/sin/sqrt are
held at rtol 1e-6: the two libraries' transcendentals may differ in the
last bit.
"""

import numpy as np
import jax.numpy as jnp
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import sampling as js
from ray_tracer_tpu_torch import sampling as ts

from test_torch_common import t_

N = 100_000


def _states(seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    return u, torch.from_numpy(u.astype(np.int64))


def _u32(x):
    return x.numpy().astype(np.uint32)


def test_next_u32_and_uniform_bit_exact():
    ju, tu = _states(0)
    js_state, jw = js.next_u32(jnp.asarray(ju))
    ts_state, tw = ts.next_u32(tu)
    assert tw.dtype == torch.int64 and int(tw.min()) >= 0
    assert int(tw.max()) < 2 ** 32 and int(ts_state.max()) < 2 ** 32
    np.testing.assert_array_equal(_u32(ts_state), np.asarray(js_state))
    np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
    # several chained draws: the stream stays bit-exact
    jst, tst = jnp.asarray(ju), tu
    for _ in range(4):
        jst, jf = js.uniform(jst)
        tst, tf = ts.uniform(tst)
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(_u32(tst), np.asarray(jst))


def test_seed_state_and_hash_bit_exact():
    pix = np.arange(N, dtype=np.uint32) * np.uint32(37)
    for frame in (0, 1, 7, 123_456_789):
        want = js.seed_state(jnp.asarray(pix), frame)
        got = ts.seed_state(torch.from_numpy(pix.astype(np.int64)), frame)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    ju, tu = _states(1)
    np.testing.assert_array_equal(_u32(ts.hash_u32(tu)),
                                  np.asarray(js.hash_u32(jnp.asarray(ju))))


def test_sphere_hemisphere_disk_allclose():
    ju, tu = _states(2)
    jst, jv = js.unit_sphere(jnp.asarray(ju))
    tst, tv = ts.unit_sphere(tu)
    np.testing.assert_array_equal(_u32(tst), np.asarray(jst))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)

    nrm = np.random.default_rng(3).normal(size=(N, 3)).astype(np.float32)
    jst, jh = js.hemisphere(jnp.asarray(ju), jnp.asarray(nrm))
    tst, th = ts.hemisphere(tu, t_(nrm))
    np.testing.assert_array_equal(_u32(tst), np.asarray(jst))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)

    jst, jd = js.unit_disk(jnp.asarray(ju))
    tst, td = ts.unit_disk(tu)
    np.testing.assert_array_equal(_u32(tst), np.asarray(jst))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_camera_rays_allclose():
    """Thin-lens primary rays (random_balls has aperture 0.1). atol covers
    direction components near zero, where the reference's fused
    multiply-adds and the port's separately rounded products differ by
    an ulp of the summands rather than of the result."""
    _, jc = jrt.builtin_scene("random_balls", aspect=1.5)
    _, tc = trt.builtin_scene("random_balls", aspect=1.5, device="cpu")
    W, H = 96, 64
    pix = np.arange(W * H, dtype=np.uint32)
    jst = js.seed_state(jnp.asarray(pix), 3)
    tst = ts.seed_state(torch.from_numpy(pix.astype(np.int64)), 3)
    jst, jo, jd = jrt.camera_rays(jrt.camera_basis(jc), jnp.asarray(pix % W),
                                  jnp.asarray(pix // W), (W, H), jst)
    tp = torch.from_numpy(pix.astype(np.int64))
    tst, to, td = trt.camera_rays(trt.camera_basis(tc), tp % W, tp // W,
                                  (W, H), tst)
    np.testing.assert_array_equal(_u32(tst), np.asarray(jst))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
