"""Port parity of ``grad/inverse.py``: the chunked gradient, the training
step, and the reference's optimizer trajectory.

``torch.optim.Adam`` has optax.adam's update form and defaults, so from the
same scene, target and fresh optimizer state both packages take the same
steps; losses and trainable values are held at rtol 1e-4 over 3 steps.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.grad import make_train_step as j_make_train_step
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu_torch.grad import inverse as tinv
from ray_tracer_tpu_torch.renderer import render_frame, render_pixels

from test_torch_common import to_port, t_


def _one_sphere(pkg, albedo=(0.7, 0.3, 0.3)):
    """The reference's inverse-rendering test scene (tests/test_grad.py)."""
    scene = (pkg.SceneBuilder()
             .add_sphere((0, 0, -3), 1.0, albedo, emission=(1, 1, 1),
                         emission_strength=0.5)
             .build(pad=8))
    cam = pkg.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=30.0,
                     aspect=1.0)
    params = pkg.RenderParams(width=12, height=12, bounces=1, skybox=True,
                              backend="jnp" if pkg is jrt else "torch")
    return scene, pkg.camera_basis(cam), params


@pytest.mark.parametrize("chunks", [3, 4])
def test_chunked_grad_matches_whole_frame(chunks):
    """chunked_mse_value_and_grad reproduces the whole-frame loss and
    gradients up to f32 summation order; 3 chunks do not divide W*H, so
    the last one carries zero-weighted padding."""
    scene, cam = trt.scene_metal(aspect=2.0)
    params = trt.RenderParams(width=64, height=32, bounces=2, skybox=True,
                              backend="torch")
    basis = trt.camera_basis(cam)
    target = render_frame(scene, basis, params, 1)
    trainable, _ = tinv.split_scene(scene)
    leaves = {k: v.clone().requires_grad_(True) for k, v in trainable.items()}
    loss0 = tinv.image_mse(leaves, scene, basis, params, 0, target)
    g0 = torch.autograd.grad(loss0, list(leaves.values()), allow_unused=True)

    def rp(tr, ids):
        return render_pixels(tinv.merge_scene(scene, tr), basis, params, 0,
                             ids)

    loss1, g1 = tinv.chunked_mse_value_and_grad(trainable, rp, params,
                                                target, chunks)
    assert float(loss1) == pytest.approx(float(loss0.detach()), rel=1e-5)
    nonzero = 0
    for k, a in zip(leaves, g0):
        a = torch.zeros_like(leaves[k]) if a is None else a
        scale = max(1e-6, float(a.abs().max()))
        assert float((a - g1[k]).abs().max()) <= 1e-4 * scale, k
        nonzero += bool(a.any())
    assert nonzero >= 2


def test_chunked_inputs_pad_with_zero_weights():
    params = trt.RenderParams(width=10, height=10)
    target = torch.arange(300, dtype=torch.float32).reshape(10, 10, 3)
    ids, tgt, wts, denom = tinv._chunked_inputs(params, target, 3)
    assert ids.shape == (3, 34) and tgt.shape == (3, 34, 3)
    assert denom == 300.0 and float(wts.sum()) == 100.0
    order, _ = tinv._blocked_order(10, 10)
    assert ids.reshape(-1)[:100].tolist() == order.tolist()
    assert bool((ids.reshape(-1)[100:] == int(order[-1])).all())
    assert not wts.reshape(-1)[100:].any()


def test_train_step_recovers_albedo():
    """60 Adam steps from a wrong albedo: the loss falls below 10% of its
    first value and the albedo approaches the true one."""
    true_scene, basis, params = _one_sphere(trt, albedo=(0.8, 0.2, 0.6))
    target = render_frame(true_scene, basis, params, 0)
    wrong_scene, _, _ = _one_sphere(trt, albedo=(0.3, 0.7, 0.3))
    init_fn, step_fn = tinv.make_train_step(
        params, lambda p: torch.optim.Adam(p, lr=5e-2))
    trainable, opt_state = init_fn(wrong_scene, fields=("sphere_albedo",))
    losses = []
    for _ in range(60):
        trainable, opt_state, loss = step_fn(trainable, opt_state,
                                             wrong_scene, basis, target, 0)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, losses[::10]
    np.testing.assert_allclose(trainable["sphere_albedo"][0].detach(),
                               [0.8, 0.2, 0.6], atol=0.15)


def test_train_steps_match_reference():
    """Three default (Adam 1e-2) steps over DEFAULT_TRAINABLE from the same
    scene and target: the same losses and trainable values."""
    js_true, jb, jp = _one_sphere(jrt, albedo=(0.8, 0.2, 0.6))
    target = np.asarray(j_render_frame(js_true, jb, jp, jnp.int32(0)))
    js, _, _ = _one_sphere(jrt, albedo=(0.3, 0.7, 0.3))
    ts = to_port(js)
    _, tb, tp = _one_sphere(trt)

    j_init, j_step = j_make_train_step(jp, optax.adam(1e-2))
    j_tr, j_state = j_init(js)
    t_init, t_step = tinv.make_train_step(tp)
    t_tr, t_state = t_init(ts)
    assert list(t_tr) == list(j_tr) == list(tinv.DEFAULT_TRAINABLE)
    for _ in range(3):
        j_tr, j_state, j_loss = j_step(j_tr, j_state, js, jb,
                                       jnp.asarray(target), jnp.int32(0))
        t_tr, t_state, t_loss = t_step(t_tr, t_state, ts, tb, t_(target), 0)
        assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-4)
        for k in t_tr:
            np.testing.assert_allclose(t_tr[k].detach().numpy(),
                                       np.asarray(j_tr[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)


def test_train_step_grad_chunks_takes_the_same_step():
    scene, cam = trt.scene_metal(aspect=1.0)
    params = trt.RenderParams(width=32, height=32, bounces=1, skybox=True,
                              backend="torch")
    basis = trt.camera_basis(cam)
    target = render_frame(scene, basis, params, 1)
    outs = []
    for chunks in (0, 4):
        init_fn, step_fn = tinv.make_train_step(
            params, lambda p: torch.optim.SGD(p, lr=1e-2),
            grad_chunks=chunks)
        tr, state = init_fn(scene, ("sphere_albedo",))
        tr, _, loss = step_fn(tr, state, scene, basis, target, 0)
        outs.append((float(loss), tr["sphere_albedo"].detach().clone()))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(edge_samples=8),
                                dict(topology=object())])
def test_unported_training_options_raise(kw):
    params = trt.RenderParams(width=8, height=8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A1[13]"):
        tinv.make_train_step(params, **kw)


def test_sharded_gradient_and_mesh_loss_raise():
    scene, cam = trt.scene_metal()
    params = trt.RenderParams(width=8, height=8)
    with pytest.raises(NotImplementedError, match="A13"):
        tinv.sharded_chunked_mse_value_and_grad({}, None, params, None, 2,
                                                object())
    with pytest.raises(NotImplementedError, match="A13"):
        tinv.image_mse({}, scene, trt.camera_basis(cam), params, 0,
                       torch.zeros((8, 8, 3)), mesh=object())


def test_step_refuses_tensors_the_optimizer_does_not_own():
    scene, basis, params = _one_sphere(trt)
    init_fn, step_fn = tinv.make_train_step(params)
    trainable, state = init_fn(scene, ("sphere_albedo",))
    other = {"sphere_albedo": trainable["sphere_albedo"].detach().clone()}
    with pytest.raises(ValueError, match="optimizer"):
        step_fn(other, state, scene, basis, torch.zeros((12, 12, 3)), 0)


def test_split_and_merge_round_trip():
    scene, _ = trt.scene_metal()
    trainable, frozen = tinv.split_scene(scene, ("sphere_center",))
    assert frozen is scene and trainable["sphere_center"] is \
        scene.sphere_center
    moved = tinv.merge_scene(scene, {"sphere_center":
                                     scene.sphere_center + 1.0})
    assert torch.equal(moved.sphere_center, scene.sphere_center + 1.0)
    assert moved.tri_v0 is scene.tri_v0
