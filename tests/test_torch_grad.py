"""Port parity of the training path's gradients, on the CPU.

Whole-frame MSE gradients with respect to every float scene leaf, through
the port's plain path (``backend="torch"``) against ``jax.grad`` of the
reference's ``jnp`` path, on the same scene leaves and the same target.

The clamp repair: at a bound, ``torch.clamp`` passes the whole gradient
and ``jnp.clip`` half of it. Diffuse (smoothness 0) and mirror
(smoothness 1) materials sit exactly on the bounds of the glossy lerp's
``clip(smoothness, 0, 1)``, so with ``torch.clamp`` there every such
primitive got twice the reference's smoothness gradient: metal's
``sphere_smoothness`` differed by 100% of its size and terrain's by 14%.
The port now bounds differentiable values with ``torch.maximum`` /
``torch.minimum`` (``utils/bounds.py``), which split the gradient at a tie
as JAX does. Before that repair every case of this file fails (metal on
``sphere_smoothness``, by 100% of its size).

Tolerance: per leaf, max |Δ| ≤ 3e-4 × that leaf's max |g_jax| (the most
measured is below 1e-4). A gradient is only comparable where the images
agree: an FMA-level flip of one scatter decision moves one pixel's whole
bounce chain, and on room at frame 0 that one pixel of 256 moves the
gradients by up to 36%. So the tests render frame 1 and first assert that
no pixel differs by 1e-4 or more.

Each case runs the port twice: through the plain oracle, and through the
kernels' path with its CPU stand-ins (``fused_intersect``: the closest-hit
kernel's plain version forward, the winner-row Function's scatter-add
backward), which ``backend="cuda"`` takes on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import materials as j_materials
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu_torch import materials as t_materials
from ray_tracer_tpu_torch import renderer as tr
from ray_tracer_tpu_torch.ops import intersect as tint
from ray_tracer_tpu_torch.renderer import render_frame as t_render_frame

from test_torch_common import scene_pair, t_

PARAMS = dict(width=16, height=16, bounces=2, skybox=True,
              coherent_scatter=True, coherent_tile=0)
FRAME = 1
GRAD_TOL = 3e-4
IMAGE_TOL = 1e-4


def float_fields(js):
    return [f.name for f in dataclasses.fields(js)
            if hasattr(getattr(js, f.name), "dtype")
            and jnp.issubdtype(getattr(js, f.name).dtype, jnp.floating)]


def jax_grads(js, cam, fields, target, params=PARAMS, frame=FRAME):
    basis = jrt.camera_basis(cam)
    p = jrt.RenderParams(backend="jnp", **params)

    def loss(leaves):
        img = j_render_frame(dataclasses.replace(js, **leaves), basis, p,
                             jnp.int32(frame))
        return jnp.mean((img - target) ** 2), img

    (value, img), g = jax.value_and_grad(loss, has_aux=True)(
        {k: getattr(js, k) for k in fields})
    return float(value), np.asarray(img), {k: np.asarray(v)
                                           for k, v in g.items()}


def torch_grads(ts, cam, fields, target, params=PARAMS, frame=FRAME,
                backend="torch"):
    """Port loss, image and gradients; ``backend="cuda"`` on CPU tensors
    needs the kernels' path forced (``kernel_path_on_cpu``)."""
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    img = t_render_frame(dataclasses.replace(ts, **leaves),
                         trt.camera_basis(trt.Camera(**vars(cam))),
                         trt.RenderParams(backend=backend, **params), frame)
    loss = torch.mean((img - t_(target)) ** 2)
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), img.detach().numpy(), {
        k: np.zeros(leaves[k].shape, np.float32) if gk is None
        else gk.numpy() for k, gk in zip(fields, g)}


def assert_grads_close(got, want, tol=GRAD_TOL):
    nonzero = 0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)
        nonzero += scale > 0
    return nonzero


def kernel_path_on_cpu(monkeypatch):
    """Route CPU scenes through fused_intersect, where the kernels'
    wrappers take their plain versions."""
    for mod in (tr, tint):
        monkeypatch.setattr(mod, "resolve_backend", lambda b, dev: "cuda")
    calls = []
    winner_rows = tint._winner_rows
    monkeypatch.setattr(tint, "_winner_rows",
                        lambda *a: calls.append(a) or winner_rows(*a))
    return calls


@pytest.mark.parametrize("name", ["metal", "balls", "terrain", "room"])
def test_whole_frame_grads_match_jax(name, monkeypatch):
    js, ts, cam = scene_pair(name)
    fields = float_fields(js)
    # the MSE against half of another frame of the true scene
    target = 0.5 * np.asarray(j_render_frame(
        js, jrt.camera_basis(cam), jrt.RenderParams(backend="jnp", **PARAMS),
        jnp.int32(0)))
    lj, img_j, gj = jax_grads(js, cam, fields, target)
    lt, img_t, gt = torch_grads(ts, cam, fields, target)
    assert float(np.abs(img_t - img_j).max()) < IMAGE_TOL
    assert lt == pytest.approx(lj, rel=1e-5)
    assert all(np.isfinite(g).all() for g in gt.values())
    assert assert_grads_close(gt, gj) >= 4

    calls = kernel_path_on_cpu(monkeypatch)
    lf, img_f, gf = torch_grads(ts, cam, fields, target, backend="cuda")
    assert len(calls) == PARAMS["bounces"] + 1
    assert np.array_equal(img_f, img_t) and lf == lt
    assert assert_grads_close(gf, gj) >= 4


def test_scatter_smoothness_grad_at_the_bounds():
    """d(new_dir)/d(smoothness) at exactly 0 and 1 (the clip bounds), and
    inside them, against JAX: half the one-sided slope at a bound."""
    rng = np.random.default_rng(3)
    n = 8
    d = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    smooth = np.array([0.0, 1.0, 0.0, 1.0, 0.5, 0.25, 1.0, 0.0], np.float32)
    state = rng.integers(0, 2 ** 32, size=n).astype(np.uint32)
    w = rng.normal(size=(n, 3)).astype(np.float32)

    def j_obj(s):
        _, nd, _ = j_materials.scatter(jnp.asarray(state), jnp.asarray(d),
                                       jnp.asarray(nrm), s)
        return jnp.sum(nd * w)

    gj = np.asarray(jax.grad(j_obj)(jnp.asarray(smooth)))
    s_t = t_(smooth).requires_grad_(True)
    _, nd, _ = t_materials.scatter(torch.from_numpy(state.astype(np.int64)),
                                   t_(d), t_(nrm), s_t)
    (gt,) = torch.autograd.grad((nd * t_(w)).sum(), [s_t])
    assert np.abs(gj).min() > 0          # every lane has a slope
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5, atol=1e-6)
