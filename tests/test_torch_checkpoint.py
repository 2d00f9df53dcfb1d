"""Port parity of ``utils/checkpoint.py``: round trips in the port, and
the JAX package's renderer and Adam training checkpoints resumed in the
port against the reference's own resumed frame and step."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.grad import make_train_step as j_make_train_step
from ray_tracer_tpu.utils import checkpoint as jck
from ray_tracer_tpu_torch.grad import inverse as tinv
from ray_tracer_tpu_torch.utils import checkpoint as tck

from test_torch_common import cpu, frac_off, one_thread, t_, to_port  # noqa: F401

GATE = 2e-3          # test_torch_render.py's image gate
ADAM_RTOL = 2e-5     # test_torch_recovery.py's bound on Adam's updates
STEP_RTOL = 1e-4     # test_torch_inverse.py's bound on a step's values

pytestmark = pytest.mark.usefixtures("one_thread")


def _renderer(pkg, backend):
    scene, cam = pkg.builtin_scene("metal", aspect=1.0, pad=8, **cpu(pkg))
    params = pkg.RenderParams(width=8, height=8, bounces=1, skybox=True,
                              backend=backend)
    return scene, cam, params


def test_renderer_round_trip_continues_accumulation(tmp_path):
    scene, cam, params = _renderer(trt, "torch")
    r = trt.Renderer(scene, cam, params)
    for _ in range(3):
        r.step()
    path = str(tmp_path / "ckpt.npz")
    tck.save_renderer(path, r)
    r2 = tck.load_renderer(path, scene)
    assert r2.frames == r.frames and r2.params == r.params
    assert r2.camera == r.camera
    assert torch.equal(r2.image, r.image)
    # continuing matches an uninterrupted run bit for bit
    assert torch.equal(r.step(), r2.step())


def test_renderer_round_trip_before_first_frame(tmp_path):
    scene, cam, params = _renderer(trt, "torch")
    r = trt.Renderer(scene, cam, params)
    path = str(tmp_path / "fresh.npz")
    tck.save_renderer(path, r)
    r2 = tck.load_renderer(path, scene)
    assert r2.frames == -1
    assert torch.equal(r2.step(), r.step())


def test_jax_renderer_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX-written checkpoint after 3 frames, resumed for one more frame
    in each package: the same frame counter, the backend translated, and
    the port's resumed image the reference's at the image gate."""
    js, cam, jp = _renderer(jrt, "jnp")
    r = jrt.Renderer(js, cam, jp)
    for _ in range(3):
        r.step()
    path = str(tmp_path / "jax.npz")
    jck.save_renderer(path, r)
    want = np.asarray(jck.load_renderer(path, js).step())
    t = tck.load_renderer(path, to_port(js))
    assert t.frames == 2 and t.params.backend == "torch"
    np.testing.assert_array_equal(t.image.numpy(), np.asarray(r.image))
    got = t.step().numpy()
    assert t.frames == 3
    assert frac_off(got, want) < GATE


def _one_sphere(pkg, albedo):
    """test_torch_inverse.py's scene: one emissive sphere."""
    scene = (pkg.SceneBuilder()
             .add_sphere((0, 0, -3), 1.0, albedo, emission=(1, 1, 1),
                         emission_strength=0.5)
             .build(pad=8, **cpu(pkg)))
    cam = pkg.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=30.0,
                     aspect=1.0)
    params = pkg.RenderParams(width=12, height=12, bounces=1, skybox=True,
                              backend="jnp" if pkg is jrt else "torch")
    return scene, pkg.camera_basis(cam), params


def test_training_round_trip(tmp_path):
    """Adam over two leaves, 2 steps, saved and loaded into a fresh
    template: the same leaves and state, and the same next step."""
    scene, basis, params = _one_sphere(trt, (0.3, 0.7, 0.3))
    target = torch.zeros((12, 12, 3))
    fields = ("sphere_albedo", "sphere_center")
    init_fn, step_fn = tinv.make_train_step(params)
    tr, opt = init_fn(scene, fields)
    for _ in range(2):
        tr, opt, _ = step_fn(tr, opt, scene, basis, target, 0)
    path = str(tmp_path / "train.npz")
    tck.save_training(path, tr, opt, step=2, extra={"note": "x"})
    t2, o2, step, extra = tck.load_training(path, init_fn(scene, fields))
    assert step == 2 and extra == {"note": "x"}
    for k in fields:
        assert torch.equal(t2[k], tr[k])
    a = step_fn(tr, opt, scene, basis, target, 0)[0]
    b = step_fn(t2, o2, scene, basis, target, 0)[0]
    for k in fields:
        assert torch.equal(a[k], b[k]), k


def test_jax_adam_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX-written Adam training checkpoint after 2 steps over
    DEFAULT_TRAINABLE, loaded into the port: the same leaves; one update
    from the same gradient equal to optax's (test_torch_recovery.py's
    bound); one full step equal to the reference's next step
    (test_torch_inverse.py's bound)."""
    js_true, jb, jp = _one_sphere(jrt, (0.8, 0.2, 0.6))
    from ray_tracer_tpu.renderer import render_frame as j_render_frame
    target = np.asarray(j_render_frame(js_true, jb, jp, jnp.int32(0)))
    js, _, _ = _one_sphere(jrt, (0.3, 0.7, 0.3))
    j_init, j_step = j_make_train_step(jp, optax.adam(1e-2))
    j_tr, j_state = j_init(js)
    for _ in range(2):
        j_tr, j_state, _ = j_step(j_tr, j_state, js, jb, jnp.asarray(target),
                                  jnp.int32(0))
    path = str(tmp_path / "jax_train.npz")
    jck.save_training(path, j_tr, j_state, step=2)

    ts = to_port(js)
    _, tb, tp = _one_sphere(trt, (0.3, 0.7, 0.3))
    t_init, t_step = tinv.make_train_step(tp)
    tr, opt, step, _ = tck.load_training(path, t_init(ts))
    assert step == 2
    for k in tr:
        np.testing.assert_array_equal(tr[k].detach().numpy(),
                                      np.asarray(j_tr[k]), err_msg=k)
    before = {k: v.detach().clone() for k, v in tr.items()}

    # one update from the same gradient
    rng = np.random.default_rng(0)
    g = {k: rng.normal(size=np.shape(v)).astype(np.float32)
         for k, v in j_tr.items()}
    upd, _ = optax.adam(1e-2).update({k: jnp.asarray(v) for k, v in g.items()},
                                     j_state, j_tr)
    for k, p in tr.items():
        p.grad = torch.from_numpy(g[k])
    opt.step()
    for k in tr:
        np.testing.assert_allclose((tr[k].detach() - before[k]).numpy(),
                                   np.asarray(upd[k]), rtol=ADAM_RTOL,
                                   atol=1e-9, err_msg=k)

    # the next full step of each package from the checkpoint
    tr, opt, _, _ = tck.load_training(path, t_init(ts))
    j_tr, j_state, j_loss = j_step(j_tr, j_state, js, jb, jnp.asarray(target),
                                   jnp.int32(0))
    tr, opt, loss = t_step(tr, opt, ts, tb, t_(target), 0)
    assert float(loss) == pytest.approx(float(j_loss), rel=STEP_RTOL)
    for k in tr:
        np.testing.assert_allclose(tr[k].detach().numpy(), np.asarray(j_tr[k]),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=k)


def test_training_checkpoint_refuses_other_fields(tmp_path):
    scene, basis, params = _one_sphere(trt, (0.3, 0.7, 0.3))
    init_fn, _ = tinv.make_train_step(params)
    tr, opt = init_fn(scene, ("sphere_albedo",))
    path = str(tmp_path / "a.npz")
    tck.save_training(path, tr, opt, step=0)
    with pytest.raises(ValueError, match="trains"):
        tck.load_training(path, init_fn(scene, ("sphere_center",)))
