"""The port's rigid recovery loop (ray_tracer_tpu_torch/tools/
invert_teapot.py) against the reference's (tools/invert_teapot.py).

All on the reference test's cube (tests/test_invert.py: 12 triangles,
padded to 128, no floor). The optimizer must reproduce the reference's
``optax.multi_transform`` (rtol 2e-5 on the updates, as
test_torch_recovery.py holds the per-vertex loop's); one step's estimator
(loss, the finite-difference offset gradient and the masked albedo
gradient) the reference's formula through its ``render_frame``,
``render_aov`` and ``jax.vjp``, on the jnp path at 32², rpp 2, bounces 1:
loss within rtol 1e-5, both gradients within 1e-4 of their largest
entry (measured: 3.6e-6 for the offset's, 1.7e-6 for the albedo's; the
differences turn last-bit image differences into gradient ones); and
four steps of both loops (all three of the albedo's phases) the same
offsets and albedos within 1e-5 and losses within rtol 1e-5 (measured:
3e-7 and 2e-6).
"""

import dataclasses
import json
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
from ray_tracer_tpu.renderer import render_aov as j_render_aov
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu_torch.ops import closest_hit as tch
from ray_tracer_tpu_torch.scene import TENSOR_FIELDS
from ray_tracer_tpu_torch.tools import invert_teapot as tit

from test_invert import _cube_scene
from test_torch_common import one_thread, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import invert_teapot as jit_  # noqa: E402  (the reference's tool)

START_DIR = np.array([1.0, -0.6, 0.4], np.float32)
START_ALBEDO = np.array([0.35, 0.6, 0.55], np.float32)
SIZE = 32          # the estimator's and the four-step loop's frames
GRAD_TOL = 1e-4    # of the largest |entry| of each gradient


def _reference_optimizer(steps, ext):
    """tools/invert_teapot.py's optimizer, as it builds it."""
    return optax.multi_transform(
        {"o": optax.chain(
            optax.clip_by_global_norm(10.0),
            optax.adam(optax.cosine_decay_schedule(0.015 * ext, steps,
                                                   alpha=0.005))),
         "a": optax.chain(
            optax.clip_by_global_norm(10.0),
            optax.adam(optax.join_schedules(
                [optax.constant_schedule(0.0),
                 optax.constant_schedule(0.03),
                 optax.cosine_decay_schedule(0.03, steps - int(0.8 * steps),
                                             alpha=0.01)],
                [int(0.35 * steps), int(0.8 * steps)])))},
        {"o": "o", "a": "a"})


@pytest.fixture(scope="module")
def cube():
    """(reference scene, port scene, reference basis, port basis, extent):
    the reference test's cube and camera."""
    b = _cube_scene(tuple(jit_.TRUE_ALBEDO))
    lo, hi = b.bounds()
    js = b.build(pad=128)
    center, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    kw = dict(origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
              look_at=tuple(center), aspect=1.0, focus_dist=1.0)
    return (js, to_port(js), jrt.camera_basis(jrt.Camera(**kw)),
            trt.camera_basis(trt.Camera(**kw)), ext)


def _params(pkg, **kw):
    return pkg.RenderParams(width=SIZE, height=SIZE, bounces=1, skybox=True,
                            rays_per_pixel=2, **kw)


def test_optimizer_matches_optax():
    """20 seeded gradient pairs through both optimizers: the albedo's rate
    is 0 until step 7, 0.03 until 16, then decays (both boundaries of
    join_schedules crossed), and some steps clip (norms past 10)."""
    steps, ext = 20, 2 * np.sqrt(3.0)
    rng = np.random.default_rng(0)
    off = (0.12 * ext * START_DIR).astype(np.float32)
    ref = _reference_optimizer(steps, ext)
    state = ref.init({"o": jnp.asarray(off), "a": jnp.asarray(START_ALBEDO)})
    port = tit.RigidRecoveryOptimizer(torch.from_numpy(off),
                                      torch.from_numpy(START_ALBEDO), steps,
                                      ext)
    clipped = 0
    for i in range(steps):
        scale = 30.0 if i % 3 == 1 else 0.3
        g_o = (rng.normal(size=3) * scale).astype(np.float32)
        g_a = (rng.normal(size=3) * scale).astype(np.float32)
        clipped += (np.linalg.norm(g_o) > 10) + (np.linalg.norm(g_a) > 10)
        upd, state = ref.update({"o": jnp.asarray(g_o),
                                 "a": jnp.asarray(g_a)}, state)
        do, da = port.update(torch.from_numpy(g_o), torch.from_numpy(g_a))
        np.testing.assert_allclose(do.numpy(), np.asarray(upd["o"]),
                                   rtol=2e-5, atol=1e-9)
        np.testing.assert_allclose(da.numpy(), np.asarray(upd["a"]),
                                   rtol=2e-5, atol=1e-9)
        assert bool(da.any()) == (i >= 7)
    assert clipped >= 4
    assert [float(port.rates(c)[1]) for c in (6, 7, 15, 16)] == [
        0.0, pytest.approx(0.03), pytest.approx(0.03), pytest.approx(0.03)]


def _reference_step(js, basis, params):
    """The reference loop's estimator (tools/invert_teapot.py:154-215)
    without its optimizer → (hit_target, jitted step(offset, albedo,
    frame, fd_h) → (loss, g_off, g_alb))."""
    valid = js.tri_valid[:, None]

    def apply(offset, albedo):
        return dataclasses.replace(
            js, tri_v0=js.tri_v0 + offset * valid,
            tri_v1=js.tri_v1 + offset * valid,
            tri_v2=js.tri_v2 + offset * valid,
            tri_albedo=jnp.broadcast_to(albedo, js.tri_albedo.shape) * valid)

    hit_target = jax.jit(lambda: j_render_aov(js, basis, params, "hit"))()

    @jax.jit
    def step(offset, albedo, frame, fd_h):
        target = jax.lax.stop_gradient(j_render_frame(js, basis, params,
                                                      frame))

        def render_only(o, a):
            return j_render_frame(apply(o, a), basis, params, frame)

        img, vjp_fn = jax.vjp(render_only, offset, albedo)
        res = img - target
        loss = jnp.mean(res ** 2)
        w = j_render_aov(apply(jax.lax.stop_gradient(offset),
                               jax.lax.stop_gradient(albedo)),
                         basis, params, "hit") * hit_target
        _, g_alb = vjp_fn(2.0 * res * w / (3.0 * jnp.maximum(jnp.sum(w),
                                                             1.0)))

        def loss_at(off):
            return jnp.mean((render_only(off, albedo) - target) ** 2)

        eye = jnp.eye(3, dtype=jnp.float32)
        g_off = jnp.stack([
            (loss_at(offset + fd_h * eye[i]) - loss_at(offset - fd_h * eye[i]))
            / (2.0 * fd_h) for i in range(3)])
        return loss, g_off, g_alb

    return hit_target, step


def _close(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (got, want)


def test_step_gradients_match_reference(cube):
    """Frames 0 and 1 of the estimator from the loop's start, each with
    the loop's fd_h for that step of a 100-step run."""
    js, ts, jb, tb, ext = cube
    hit_j, step_j = _reference_step(js, jb, _params(jrt, backend="jnp"))
    params = _params(trt, backend="torch")
    hit_t = trt.render_aov(ts, tb, params, "hit")
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    offset = (np.float32(0.12 * ext) * START_DIR).astype(np.float32)
    for frame in (0, 1):
        h = 0.015 * ext * 0.1 ** (frame / 99)
        lj, gj_off, gj_alb = step_j(jnp.asarray(offset),
                                    jnp.asarray(START_ALBEDO),
                                    jnp.int32(frame), jnp.float32(h))
        lt, gt_off, gt_alb = tit.step_gradients(ts, offset, START_ALBEDO,
                                                frame, h, hit_t, params, tb)
        assert float(lt) == pytest.approx(float(lj), rel=1e-5)
        _close(gt_off.numpy(), gj_off)
        _close(gt_alb.numpy(), gj_alb)
        assert np.abs(gt_off.numpy()).max() > 0
        assert np.abs(gt_alb.numpy()).max() > 0


def test_step_gradients_on_the_kernels_path(cube, monkeypatch):
    """The estimator through the kernels' wrappers (their plain versions
    on the CPU) against the plain path's: the same loss and differences,
    the albedo's gradient within 1e-6 of its largest entry (the kernels'
    backward adds in the blocked pixel order); with the closest-hit
    queries a step makes: rpp x (bounces + 1) for each of the target, the
    forward and the six differences, and one for the coverage AOV."""
    from test_torch_grad import kernel_path_on_cpu
    _, ts, _, tb, ext = cube
    offset = (np.float32(0.12 * ext) * START_DIR).astype(np.float32)
    params = _params(trt, backend="torch")
    hit = trt.render_aov(ts, tb, params, "hit")
    want = tit.step_gradients(ts, offset, START_ALBEDO, 0, 0.05, hit,
                              params, tb)
    calls = kernel_path_on_cpu(monkeypatch)
    got = tit.step_gradients(ts, offset, START_ALBEDO, 0, 0.05, hit,
                             params.replace(backend="cuda"), tb)
    assert len(calls) == 2 * 2 * 8 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _close(got[2].numpy(), want[2].numpy(), 1e-6)


def test_run_recovery_matches_reference(cube):
    """Four steps of both loops from the reference test's start: albedo
    rates 0, 0.03, 0.03 and the decay (boundaries 1 and 3)."""
    js, ts, jb, tb, ext = cube
    start = np.float32(0.12 * ext) * START_DIR
    off_j, alb_j, loss_j = jit_.run_recovery(
        js, ext, _params(jrt, backend="jnp"), 4,
        jnp.asarray(start, jnp.float32), START_ALBEDO, jb, log=False)
    off_t, alb_t, loss_t = tit.run_recovery(
        ts, ext, _params(trt), 4, start, START_ALBEDO, tb, log=False)
    np.testing.assert_allclose(off_t, np.asarray(off_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(alb_t, np.asarray(alb_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert not np.allclose(alb_t, START_ALBEDO)      # the albedo moved
    assert np.linalg.norm(off_t) < np.linalg.norm(start)


def test_apply_rigid_makes_new_tensors(cube):
    """The moved scene's vertices are new tensors (the truth's are never
    written), its normals the truth's, its albedo uniform."""
    _, ts, _, _, _ = cube
    before = ts.tri_v0.clone()
    moved = tit.apply_rigid(ts, torch.tensor([0.5, 0.0, -0.25]),
                            torch.tensor([0.1, 0.2, 0.3]))
    assert torch.equal(ts.tri_v0, before)
    n = ts.num_tris
    assert torch.allclose(moved.tri_v1[:n] - ts.tri_v1[:n],
                          torch.tensor([0.5, 0.0, -0.25]))
    assert not moved.tri_v0[n:].any()          # padding stays put
    assert moved.tri_n0 is ts.tri_n0
    assert torch.equal(moved.tri_albedo[:n],
                       torch.tensor([[0.1, 0.2, 0.3]]).expand(n, 3))


def _cube_obj(path):
    """The cube as an OBJ with per-face normals."""
    v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    quads = [([0, 1, 3, 2], 1), ([4, 6, 7, 5], 2), ([0, 4, 5, 1], 3),
             ([2, 3, 7, 6], 4), ([0, 2, 6, 4], 5), ([1, 5, 7, 3], 6)]
    normals = ["-1 0 0", "1 0 0", "0 -1 0", "0 1 0", "0 0 -1", "0 0 1"]
    lines = [f"v {x} {y} {z}" for x, y, z in v]
    lines += [f"vn {n}" for n in normals]
    for q, n in quads:
        for a, b, c in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            lines.append(f"f {a + 1}//{n} {b + 1}//{n} {c + 1}//{n}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_recovery_setup_matches_reference_main(tmp_path):
    """recovery_setup: the reference main's scene (loaded at the origin
    with TRUE_ALBEDO and smoothness 0, textures stripped, the albedo
    broadcast) and camera, from a model file."""
    path = _cube_obj(tmp_path / "cube.obj")
    ts, tb, ext = tit.recovery_setup(path, device="cpu")
    b = jrt.SceneBuilder()
    jrt.io.load_model(path, b, placement="origin",
                      albedo=tuple(jit_.TRUE_ALBEDO), smoothness=0.0)
    lo, hi = b.bounds()
    js = b.build()
    js = dataclasses.replace(
        js, tri_tex=jnp.full_like(js.tri_tex, -1),
        tri_albedo=(jnp.broadcast_to(jnp.asarray(jit_.TRUE_ALBEDO),
                                     js.tri_albedo.shape)
                    * js.tri_valid[:, None]))
    assert ext == float(np.linalg.norm(hi - lo))
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.num_tris == js.num_tris == 12
    center = (lo + hi) / 2
    jb = jrt.camera_basis(jrt.Camera(
        origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
        look_at=tuple(center), aspect=1.0, focus_dist=1.0))
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(tb, f.name).numpy(),
                                      np.asarray(getattr(jb, f.name)),
                                      err_msg=f.name)
    assert tit.recovery_params(192) == trt.RenderParams(
        width=192, height=192, bounces=1, skybox=True, rays_per_pixel=2)


def test_main_on_a_model_file(tmp_path, monkeypatch, capsys):
    """``main [steps] [size] [outfile] [model]`` on the CPU
    (RTT_PLATFORM=cpu): the reference's JSON line, printed and written."""
    monkeypatch.setenv("RTT_PLATFORM", "cpu")
    path = _cube_obj(tmp_path / "cube.obj")
    out = tmp_path / "out" / "r.json"
    tit.main(["2", "16", str(out), path])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == printed
    assert printed["steps"] == 2 and printed["resolution"] == 16
    assert printed["tris"] == 12 and printed["device"] == "cpu"
    assert set(printed) == {
        "steps", "resolution", "seconds", "tris", "device",
        "start_offset_rel", "start_dir", "start_albedo",
        "offset_error_rel_extent", "albedo_error", "recovered"}
    assert printed["start_dir"] == pytest.approx([1.0, -0.6, 0.4])
    assert 0 < printed["offset_error_rel_extent"] < 0.2


@pytest.mark.skipif(not os.path.exists(tit.MODEL),
                    reason="the upstream teapot asset is not available")
def test_main_on_the_teapot(tmp_path, monkeypatch):
    """The default model, where the upstream's asset is present: 2 steps
    at 32² on the CPU."""
    monkeypatch.setenv("RTT_PLATFORM", "cpu")
    out = tmp_path / "t.json"
    tit.main(["2", "32", str(out)])
    assert json.loads(out.read_text())["tris"] == 15704


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_recovery_converges_on_the_card(cuda_device):
    """The reference test's run (tests/test_invert.py:41-68) through the
    kernels: 100 steps at 64², rpp 2, held to its bars: offset error <
    0.02 of the extent, albedo error < 0.05, last loss < 0.05 x the
    first; with the closest-hit (1 + 33 a step) and scatter-add (4 a step)
    launches and 1 + 8 packings a step the loop makes."""
    from ray_tracer_tpu_torch.ops import scatter_rows
    b = _cube_scene(tuple(jit_.TRUE_ALBEDO))
    lo, hi = b.bounds()
    js = b.build(pad=128)
    ts = trt.scene_from_numpy({k: np.asarray(v) for k, v in
                               dataclasses.asdict(js).items()},
                              device=cuda_device)
    center, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    basis = trt.camera_basis(trt.Camera(
        origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
        look_at=tuple(center), aspect=1.0, focus_dist=1.0))
    params = trt.RenderParams(width=64, height=64, bounces=1, skybox=True,
                              rays_per_pixel=2)
    tch.nearest_hit_attrs.launches = 0
    scatter_rows.scatter_rows_soa.launches = 0
    packs = tch.scene_planes.packs
    steps = 100
    off, alb, losses = tit.run_recovery(
        ts, ext, params, steps, np.float32(0.12 * ext) * START_DIR,
        START_ALBEDO, basis, log=False)
    assert tch.nearest_hit_attrs.launches == 1 + 33 * steps
    assert scatter_rows.scatter_rows_soa.launches == 4 * steps
    assert tch.scene_planes.packs - packs == 1 + 8 * steps
    off_err = float(np.linalg.norm(off)) / ext
    alb_err = float(np.abs(alb - jit_.TRUE_ALBEDO).max())
    assert off_err < 0.02, (off_err, losses[-3:])
    assert alb_err < 0.05, (alb_err, alb)
    assert losses[-1] < losses[0] * 0.05, losses[::10]
