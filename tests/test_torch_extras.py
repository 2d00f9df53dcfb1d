"""Port parity of the image extras, on the CPU: adaptive sampling
(``render_adaptive``), the à-trous denoiser (``denoise``,
``denoise_render``) and per-segment rematerialization
(``RenderParams.remat``), each against the reference's jnp path (and
``jax.grad``) on the same numpy inputs.

Tolerances are the reference's own: the adaptive mean rtol 1e-4 of the
progressive image, remat gradients rtol 1e-3 / atol 1e-7
(``tests/test_grad.py``), the denoiser rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.denoise import denoise as j_denoise
from ray_tracer_tpu.denoise import denoise_render as j_denoise_render
from ray_tracer_tpu import renderer as jr
from ray_tracer_tpu.grad.inverse import image_mse as j_image_mse
from ray_tracer_tpu_torch.denoise import denoise as t_denoise
from ray_tracer_tpu_torch import renderer as tr
from ray_tracer_tpu_torch.grad import DEFAULT_TRAINABLE
from ray_tracer_tpu_torch.grad.inverse import image_mse as t_image_mse

from test_torch_common import scene_pair, t_



def _bases(cam):
    return jrt.camera_basis(cam), trt.camera_basis(trt.Camera(**vars(cam)))


def _flat_emitter(pkg):
    b = pkg.SceneBuilder()
    b.add_sphere((0, 0, -3), 2.0, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=2.0)
    kw = {"device": "cpu"} if pkg is trt else {}
    cam = pkg.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=10.0,
                     aspect=1.0)
    return b.build(pad=8, **kw), cam


def test_adaptive_stops_after_one_chunk_on_a_flat_emitter():
    scene, cam = _flat_emitter(trt)
    p = trt.RenderParams(width=16, height=16, bounces=1)
    img, used = tr.render_adaptive(scene, trt.camera_basis(cam), p, 64,
                                   0.05, chunk=4)
    assert used == 4
    np.testing.assert_allclose(img.numpy(), 2.0, rtol=1e-5)


def test_adaptive_runs_to_the_cap_and_equals_progressive():
    """Target 0 is never met: 12 frames, whose mean equals the
    progressive accumulation of the same 12 frames (rtol 1e-4)."""
    _, ts, cam = scene_pair("room")
    jb, tb = _bases(cam)
    p = dict(width=16, height=16, bounces=2, skybox=True)
    img, used = tr.render_adaptive(ts, tb, trt.RenderParams(**p), 12, 0.0,
                                   chunk=4)
    assert used == 12
    ref = tr.render_progressive(ts, tb, trt.RenderParams(**p), 12)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("name,target,frames", [("metal", 0.5, 12),
                                                 ("terrain", 0.3, 16)])
def test_adaptive_uses_the_reference_frame_count(name, target, frames):
    """The frames used at a reachable target equal the reference's on the
    same scene (chunks of 2); the statistics of the same moments agree
    bit for bit."""
    js, ts, cam = scene_pair(name)
    jb, tb = _bases(cam)
    p = dict(width=16, height=16, bounces=2, skybox=True)
    _, used = tr.render_adaptive(ts, tb, trt.RenderParams(**p), 32, target,
                                 chunk=2)
    _, used_j = jr.render_adaptive(js, jb, jrt.RenderParams(backend="jnp",
                                                            **p),
                                   32, target, chunk=2)
    assert used == used_j == frames
    rng = np.random.default_rng(1)
    s = rng.random((8, 8, 3)).astype(np.float32) * 6
    s2 = s * s / 6 + rng.random((8, 8, 3)).astype(np.float32)
    mean_t, frac_t = tr._adaptive_stats(t_(s), t_(s2), 6, target)
    mean_j, frac_j = jr._adaptive_stats(jnp.asarray(s), jnp.asarray(s2), 6,
                                        target)
    np.testing.assert_array_equal(mean_t.numpy(), np.asarray(mean_j))
    assert float(frac_t) == float(frac_j)


def _denoise_inputs(seed, H=64, W=64):
    """A noisy two-region image with its normal and depth guides; a
    sixth of the pixels are misses (normal 0, depth 0)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((H, W, 1), np.float32)
    mask[:, W // 2:] = 1.0
    clean = mask * np.array([0.8, 0.2, 0.1]) + (1 - mask) * 0.05
    img = (clean + rng.normal(0, 0.15, clean.shape)).astype(np.float32)
    normal = np.where(mask > 0, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    normal = (normal + rng.normal(0, 0.05, normal.shape)).astype(np.float32)
    depth = (np.where(mask > 0, 2.0, 5.0)
             + rng.random((H, W, 1))).astype(np.float32)
    miss = rng.random((H, W)) < 1 / 6
    normal[miss], depth[miss] = 0.0, 0.0
    return img, normal, depth


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_denoise_matches_reference(iterations):
    img, normal, depth = _denoise_inputs(iterations)
    want = np.asarray(j_denoise(jnp.asarray(img), jnp.asarray(normal),
                                 jnp.asarray(depth), iterations=iterations))
    got = t_denoise(t_(img), t_(normal), t_(depth), iterations=iterations)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_denoise_gradient_matches_jax():
    """d(weighted sum of the filtered image) / d(image) against
    jax.grad."""
    img, normal, depth = _denoise_inputs(4, 32, 32)
    wts = np.random.default_rng(5).random(img.shape).astype(np.float32)

    def loss(x):
        return jnp.sum(j_denoise(x, jnp.asarray(normal), jnp.asarray(depth),
                                  iterations=2) * wts)

    want = np.asarray(jax.grad(loss)(jnp.asarray(img)))
    x = t_(img).requires_grad_(True)
    g, = torch.autograd.grad(
        (t_denoise(x, t_(normal), t_(depth), iterations=2) * t_(wts)).sum(),
        x)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6)


def test_denoise_render_end_to_end():
    """The reference's test: a 1-frame render filtered with its own AOV
    guides keeps its brightness within 5% and loses at least 40% of its
    high-frequency energy; and it matches the reference's denoise_render
    of the same image (rtol 1e-3 / atol 1e-4: its guides, the AOVs, agree
    within rtol 3e-4)."""
    js, ts, cam = scene_pair("metal")
    jb, tb = _bases(cam)
    p = dict(width=64, height=64, bounces=2, skybox=True)
    img = tr.render_frame(ts, tb, trt.RenderParams(**p), 0)
    out = trt.denoise_render(ts, tb, trt.RenderParams(**p), img).numpy()
    img = img.numpy()
    assert out.shape == img.shape and np.isfinite(out).all()
    assert abs(out.mean() - img.mean()) < 0.05 * max(img.mean(), 1e-6)

    def hf(x):
        return np.abs(np.diff(x, axis=0)).mean()

    assert hf(out) < 0.6 * hf(img)
    want = np.asarray(j_denoise_render(js, jb, jrt.RenderParams(
        backend="jnp", **p), jnp.asarray(img)))
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-4)


REMAT = dict(width=12, height=12, bounces=2, skybox=True)


@pytest.mark.parametrize("name", ["room", "terrain"])
def test_remat_forward_equal_and_gradients_match(name):
    """remat=True: the forward bit-equal to remat=False; the gradients of
    the image MSE over DEFAULT_TRAINABLE within rtol 1e-3 / atol 1e-7 of
    remat=False and of jax.grad with remat."""
    js, ts, cam = scene_pair(name)
    jb, tb = _bases(cam)
    p = REMAT
    frame = 1
    target = np.zeros((12, 12, 3), np.float32)
    grads, imgs = {}, {}
    for remat in (False, True):
        params = trt.RenderParams(remat=remat, **p)
        leaves = {k: getattr(ts, k).clone().requires_grad_(True)
                  for k in DEFAULT_TRAINABLE}
        imgs[remat] = tr.render_frame(dataclasses.replace(ts, **leaves), tb,
                                      params, frame).detach()
        loss = t_image_mse(leaves, ts, tb, params, frame, t_(target))
        grads[remat] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    assert torch.equal(imgs[False], imgs[True])
    gj = jax.grad(j_image_mse)(
        {k: getattr(js, k) for k in DEFAULT_TRAINABLE}, js, jb,
        jrt.RenderParams(backend="jnp", remat=True, **p), jnp.int32(frame),
        jnp.asarray(target))
    for k in DEFAULT_TRAINABLE:
        g1 = grads[True][k].numpy()
        assert np.isfinite(g1).all(), k
        np.testing.assert_allclose(g1, grads[False][k].numpy(), rtol=1e-3,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(g1, np.asarray(gj[k]), rtol=1e-3,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("nee", [False, True])
def test_remat_on_the_kernels_path_with_textures(nee, monkeypatch):
    """Under recompute the kernels' autograd Functions (the winner rows'
    scatter-add, the texture fetch's row-major scatter-add) give the
    gradients they give without it: textured terrain with its lights,
    with and without NEE + MIS, the kernels' path with its CPU
    stand-ins."""
    from test_torch_grad import kernel_path_on_cpu
    _, ts, cam = scene_pair("terrain_nee_tex")
    tb = trt.camera_basis(trt.Camera(**vars(cam)))
    fields = [k for k in ("tri_albedo", "tri_v0", "tri_uv0", "textures",
                          "sphere_center")]
    calls = kernel_path_on_cpu(monkeypatch)
    out = {}
    for remat in (False, True):
        params = trt.RenderParams(remat=remat, nee=nee, **REMAT)
        leaves = {k: getattr(ts, k).clone().requires_grad_(True)
                  for k in fields}
        img = tr.render_frame(dataclasses.replace(ts, **leaves), tb, params,
                              1)
        g = torch.autograd.grad((img ** 2).mean(), list(leaves.values()))
        out[remat] = (img.detach(), dict(zip(fields, g)))
    # the recompute runs each segment's hit query once more
    assert len(calls) == 3 * (REMAT["bounces"] + 1)
    assert torch.equal(out[False][0], out[True][0])
    for k in fields:
        torch.testing.assert_close(out[True][1][k], out[False][1][k],
                                   rtol=1e-3, atol=1e-7)
        assert bool(out[True][1][k].any()), k
