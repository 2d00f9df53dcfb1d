"""The port's per-vertex recovery loop (ray_tracer_tpu_torch/tools/
invert_vertices.py) against the reference's (tools/invert_vertices.py).

The optimizer must reproduce ``optax.multi_transform`` (rtol 2e-5 on the
updates: the same f32 operations, with the schedules' cosines and the
bias corrections' powers from numpy's libm instead of XLA's, measured at
most 6.7e-6); the cameras the reference's bases exactly; and both
recovery loops, from the same start field on the reference's CPU test
configuration, must fall below 0.6 × the start RMS within the steps run
here, the port's final RMS within 25% of the reference's (their edge
draws differ, so their trajectories differ within Monte-Carlo noise).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.grad import topology as jt
from ray_tracer_tpu.io import load_model as j_load_model
from ray_tracer_tpu_torch.grad import topology as tt
from ray_tracer_tpu_torch.tools import invert_vertices as tiv

from test_invert_vertices import octasphere
from test_torch_common import to_port, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import invert_vertices as jiv  # noqa: E402  (the reference's tool)

RECOVERY_STEPS = 60    # of the reference test's 300: ~10 s a package here


def _reference_optimizer(steps, ext, lr_scale=0.004, albedo_phase=0.25):
    """tools/invert_vertices.py's optimizer, as it builds it."""
    a_phase = int(albedo_phase * steps)
    return optax.multi_transform(
        {"o": optax.chain(
            optax.clip_by_global_norm(float(10.0 * ext)),
            optax.adam(optax.cosine_decay_schedule(
                lr_scale * ext, steps, alpha=0.02))),
         "a": optax.chain(
            optax.clip_by_global_norm(10.0),
            optax.adam(optax.join_schedules(
                [optax.constant_schedule(0.0),
                 optax.cosine_decay_schedule(0.03, max(1, steps - a_phase),
                                             alpha=0.02)],
                [a_phase])))},
        {"o": "o", "a": "a"})


def test_optimizer_matches_optax():
    """12 fixed gradients through both optimizers, straddling the albedo's
    phase (steps 12, phase 0.25: the albedo's rate is 0 for 3 steps while
    its moments update), some of them past each group's clip norm."""
    steps, ext = 12, 2.0
    rng = np.random.default_rng(0)
    off = rng.normal(size=(20, 3)).astype(np.float32)
    alb = np.array([0.35, 0.6, 0.55], np.float32)
    ref = _reference_optimizer(steps, ext)
    state = ref.init({"o": jnp.asarray(off), "a": jnp.asarray(alb)})
    port = tiv.RecoveryOptimizer(torch.from_numpy(off), torch.from_numpy(alb),
                                 steps, ext)
    for i in range(steps):
        scale = 30.0 if i % 4 == 1 else 0.5     # some steps clip
        g_o = (rng.normal(size=off.shape) * scale).astype(np.float32)
        g_a = (rng.normal(size=alb.shape) * scale * 10).astype(np.float32)
        upd, state = ref.update({"o": jnp.asarray(g_o),
                                 "a": jnp.asarray(g_a)}, state)
        do, da = port.update(torch.from_numpy(g_o), torch.from_numpy(g_a))
        np.testing.assert_allclose(do.numpy(), np.asarray(upd["o"]),
                                   rtol=2e-5, atol=1e-9)
        np.testing.assert_allclose(da.numpy(), np.asarray(upd["a"]),
                                   rtol=2e-5, atol=1e-9)
        if i < 3:
            assert not da.any()
        else:
            assert da.abs().max() > 0


def test_ring_cameras_match_reference():
    center, ext = np.array([0.1, -0.2, 0.3]), 2.5
    for n in (4, 6):
        for want, got in zip(jiv.ring_cameras(center, ext, n),
                             tiv.ring_cameras(center, ext, n)):
            for f in dataclasses.fields(want):
                np.testing.assert_array_equal(
                    getattr(got, f.name).numpy(),
                    np.asarray(getattr(want, f.name)), err_msg=f.name)


def test_smooth_field_has_the_requested_rms():
    verts = torch.from_numpy(octasphere(2)[0])
    g = torch.Generator()
    g.manual_seed(1)
    field = tiv.smooth_field(g, verts, 2.0, rms=0.2)
    rms = float(torch.sqrt(torch.mean(torch.sum(field ** 2, -1))))
    assert rms == pytest.approx(0.2, rel=1e-5)
    g.manual_seed(1)
    assert torch.equal(tiv.smooth_field(g, verts, 2.0, rms=0.2), field)


def _octasphere_obj(path):
    verts, faces = octasphere(subdiv=2)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_recovery_scene_matches_reference_setup(tmp_path):
    """recovery_scene: the reference main's setup (load at the origin with
    TRUE_ALBEDO, strip textures, normals recomputed on the truth) from a
    model file."""
    path = _octasphere_obj(tmp_path / "octa.obj")
    ts, ttopo, center, ext = tiv.recovery_scene(path, device="cpu")
    b = jrt.SceneBuilder()
    j_load_model(path, b, placement="origin",
                 albedo=tuple(jiv.TRUE_ALBEDO), smoothness=0.0)
    lo, hi = b.bounds()
    js = b.build()
    js = dataclasses.replace(
        js, tri_tex=jnp.full_like(js.tri_tex, -1),
        tri_albedo=(jnp.broadcast_to(jnp.asarray(jiv.TRUE_ALBEDO),
                                     js.tri_albedo.shape)
                    * js.tri_valid[:, None]))
    jtopo = jt.build_topology(js)
    js = jt.apply_vertex_offsets(js, jtopo, jnp.zeros((jtopo.num_verts, 3)))
    np.testing.assert_array_equal(center, (lo + hi) / 2)
    assert ext == float(np.linalg.norm(hi - lo))
    assert ttopo.num_verts == jtopo.num_verts == 66
    for f in dataclasses.fields(js):
        want = getattr(js, f.name)
        got = getattr(ts, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f.name)
        else:
            assert got == want, f.name


def test_recovery_loop_matches_reference():
    """Both loops from the reference's start field, at the reference CPU
    test's configuration (octasphere subdiv 2, 64², 4 views, 1,024 edge
    samples, λ 2, frame_cycle 2, albedo from (0.35, 0.6, 0.55))."""
    verts, faces = octasphere(subdiv=2)
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    js = (jrt.SceneBuilder()
          .add_mesh(verts, normals, faces.reshape(-1),
                    albedo=tuple(jiv.TRUE_ALBEDO), smoothness=0.0)
          .build())
    ext = 2.0
    jtopo = jt.build_topology(js)
    js = jt.apply_vertex_offsets(js, jtopo,
                                 jnp.zeros((jtopo.num_verts, 3), jnp.float32))
    ts = to_port(js)
    ttopo = tt.build_topology(ts)
    start = jiv.smooth_field(jax.random.PRNGKey(1), jtopo.base_verts, ext,
                             rms=0.10 * ext)
    kw = dict(steps=RECOVERY_STEPS,
              start_albedo=np.array([0.35, 0.6, 0.55], np.float32),
              edge_samples=1024, frame_cycle=2, sobolev_lam=2.0, ext=ext,
              log=False)
    off_j, alb_j, loss_j = jiv.run_vertex_recovery(
        js, jtopo, jrt.RenderParams(width=64, height=64, bounces=1,
                                    skybox=True, backend="jnp"),
        jiv.ring_cameras(np.zeros(3), ext, n_views=4),
        start_offsets=start, **kw)
    off_t, alb_t, loss_t = tiv.run_vertex_recovery(
        ts, ttopo, trt.RenderParams(width=64, height=64, bounces=1,
                                    skybox=True, backend="torch"),
        tiv.ring_cameras(np.zeros(3), ext, n_views=4),
        start_offsets=np.asarray(start), **kw)

    def rms(o):
        return float(np.sqrt(np.mean(np.sum(o ** 2, -1)))) / ext

    # the first step sees the same start: the losses agree
    assert loss_t[0] == pytest.approx(loss_j[0], rel=1e-3)
    assert rms(off_j) < 0.6 * 0.10 and rms(off_t) < 0.6 * 0.10
    assert abs(rms(off_t) - rms(off_j)) < 0.25 * rms(off_j), (
        rms(off_t), rms(off_j))
    assert loss_t[-1] < 0.1 * loss_t[0]
    assert np.isfinite(off_t).all() and np.isfinite(alb_t).all()
