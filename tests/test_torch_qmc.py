"""Port parity of QMC anti-aliasing (``RenderParams.qmc``), on the CPU.

The R2 sequence in 0.32 fixed point is exact modular arithmetic in both
packages. The port keeps uint32 values in int64, and the R2 multipliers
are above 2^31, so ``sampling.r2_point`` multiplies by their 16-bit
halves; the points are held bit-exact to the reference's over the whole
uint32 range. The camera's supplied jitter and the frames' rotations and
sample counter are held to the reference's as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import sampling as js
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu.renderer import render_progressive as j_progressive
from ray_tracer_tpu_torch import renderer as tr
from ray_tracer_tpu_torch import sampling as ts

from test_torch_common import frac_off, scene_pair, t_

GATE = 2e-3
SPECIAL_N = [0, 1, 2 ** 31, 2 ** 32 - 1]


def _u32(rng, n):
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(
        np.uint32)


def test_r2_constants_match_reference():
    assert ts.R2_G1_U32 == int(js.R2_G1_U32)
    assert ts.R2_G2_U32 == int(js.R2_G2_U32)
    assert np.float32(ts._INV_2_32) == js._INV_2_32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_r2_point_bit_exact(seed):
    """Every n of the special values and of 4,096 random ones, with random
    rotations, as an array of n and as one scalar n."""
    rng = np.random.default_rng(seed)
    n = np.concatenate([np.array(SPECIAL_N, np.uint32), _u32(rng, 4096)])
    rx, ry = _u32(rng, n.size), _u32(rng, n.size)
    want = js.r2_point(jnp.asarray(n), jnp.asarray(rx), jnp.asarray(ry))
    got = ts.r2_point(t_(n.astype(np.int64)), t_(rx.astype(np.int64)),
                      t_(ry.astype(np.int64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in SPECIAL_N:
        want = js.r2_point(jnp.uint32(k), jnp.asarray(rx), jnp.asarray(ry))
        got = ts.r2_point(k, t_(rx.astype(np.int64)),
                          t_(ry.astype(np.int64)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_camera_rays_with_jitter_bit_exact(aperture):
    """A supplied jitter replaces the two AA draws (the state does not
    advance for them); the lens draws stay. States are bit-exact; rays are
    bit-exact through a pinhole, and with a lens within test_torch_sampling's
    thin-lens bound (the reference fuses the lens offset's multiply-adds)."""
    rng = np.random.default_rng(7)
    cam = jrt.Camera(origin=(0.3, 1.0, 5.0), look_at=(0.0, 0.0, 0.0),
                     aperture=aperture, focus_dist=4.0, aspect=1.5)
    W, H, n = 48, 32, 1024
    pix = rng.integers(0, W * H, size=n).astype(np.uint32)
    state = _u32(rng, n)
    rx, ry = _u32(rng, n), _u32(rng, n)
    jit_j = js.r2_point(jnp.uint32(12345), jnp.asarray(rx), jnp.asarray(ry))
    sj, oj, dj = jrt.camera_rays(jrt.camera_basis(cam),
                                 jnp.asarray(pix % W), jnp.asarray(pix // W),
                                 (W, H), jnp.asarray(state), jitter=jit_j)
    jit_t = ts.r2_point(12345, t_(rx.astype(np.int64)),
                        t_(ry.astype(np.int64)))
    p = t_(pix.astype(np.int64))
    st, ot, dt = trt.camera_rays(trt.camera_basis(trt.Camera(**vars(cam))),
                                 p % W, p // W, (W, H),
                                 t_(state.astype(np.int64)), jitter=jit_t)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).astype(np.int64))
    if aperture:
        for g, w in ((ot, oj), (dt, dj)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    else:
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # two lens draws with the jitter, two AA draws more without it
    s = t_(state.astype(np.int64))
    for _ in range(2):
        s, _ = ts.next_u32(s)
    assert torch.equal(st, s)
    st2, _, _ = trt.camera_rays(trt.camera_basis(trt.Camera(**vars(cam))),
                                p % W, p // W, (W, H),
                                t_(state.astype(np.int64)))
    for _ in range(2):
        s, _ = ts.next_u32(s)
    assert torch.equal(st2, s)


@pytest.mark.parametrize("name,frame,rpp", [("room", 0, 1),
                                            ("terrain", 3, 2)])
def test_qmc_frame_matches_reference(name, frame, rpp):
    """A qmc=True frame against the reference's jnp frame, under the image
    gate; rays_per_pixel 2 and frame 3 walk the sample counter
    n = frame * rpp + s."""
    js_, ts_, cam = scene_pair(name)
    p = dict(width=32, height=32, bounces=2, skybox=True, qmc=True,
             rays_per_pixel=rpp, coherent_scatter=True, coherent_tile=0)
    want = np.asarray(j_render_frame(js_, jrt.camera_basis(cam),
                                     jrt.RenderParams(backend="jnp", **p),
                                     jnp.int32(frame)))
    got = tr.render_frame(ts_, trt.camera_basis(trt.Camera(**vars(cam))),
                          trt.RenderParams(**p), frame).numpy()
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert frac_off(got, want) < GATE
    plain = tr.render_frame(ts_, trt.camera_basis(trt.Camera(**vars(cam))),
                            trt.RenderParams(**dict(p, qmc=False)),
                            frame).numpy()
    assert frac_off(got, plain) > GATE  # the knob changes the image


def test_qmc_converges_faster_than_pcg():
    """The reference's convergence test: bounces=0 on an emissive
    silhouette, where radiance depends only on the AA sample. The port's
    16 QMC frames beat its 16 PCG frames by 2x against the reference's
    2048-frame QMC image."""
    def build(pkg):
        b = pkg.SceneBuilder()
        b.add_sphere((0, 0, -4), 1.0, (0, 0, 0), emission=(1, 1, 1),
                     emission_strength=1.0)
        kw = {"device": "cpu"} if pkg is trt else {}
        return b.build(pad=8, **kw)

    cam = dict(origin=(0, 0, 0), look_at=(0, 0, -1), fov=40.0, aspect=1.0)
    p = dict(width=24, height=24, bounces=0)
    ref = np.asarray(j_progressive(
        build(jrt), jrt.camera_basis(jrt.Camera(**cam)),
        jrt.RenderParams(backend="jnp", qmc=True, **p), 2048))
    scene, basis = build(trt), trt.camera_basis(trt.Camera(**cam))
    err = {qmc: float(np.abs(tr.render_progressive(
        scene, basis, trt.RenderParams(qmc=qmc, **p), 16).numpy()
        - ref).mean()) for qmc in (False, True)}
    assert err[True] < 0.5 * err[False], err
