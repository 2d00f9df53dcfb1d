"""Port parity of wavefront compaction (``RenderParams.compaction``).

Before each segment's hit query ``trace`` sorts its rays: by the origin's
24-bit Morton cell in the scene's box, then direction octant ("morton",
an argsort of ``_ray_sort_key``), or by direction octant alone
("octant"), dead rays last, and permutes every per-lane tensor with them;
radiance and RNG state go back to their slots at the end. The keys and
permutations are held bit-exact to the reference's. Compaction runs on
the kernels' backend only, as in the reference; the CPU tests switch it
on for the plain path through ``renderer.compaction_mode``, or run the
kernels' path with its CPU stand-ins. Each lane's result does not depend
on its slot, so with coherent scatter off a compacted frame equals the
uncompacted one bit for bit; with it on the share tiles draw over the
permuted lanes, as the reference's do.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import renderer as jr
from ray_tracer_tpu_torch import renderer as tr

from test_torch_common import frac_off, scene_pair, t_

GATE = 2e-3
SCENES = ["room", "terrain"]


def _rays(js, n, seed):
    """n rays with origins around the scene (some outside its box, where
    the key clips), random directions (some with zero components), about
    half of the lanes dead."""
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(x) for x in jr._scene_aabb(js))
    o = lo + (rng.random((n, 3)) * 1.2 - 0.1) * (hi - lo)
    d = rng.normal(size=(n, 3))
    d[rng.random((n, 3)) < 0.05] = 0.0
    alive = rng.random(n) < 0.5
    return o.astype(np.float32), d.astype(np.float32), alive


def compacting_on_cpu(monkeypatch):
    """Let compaction run on the plain ("torch") backend."""
    real = tr.compaction_mode
    monkeypatch.setattr(tr, "compaction_mode",
                        lambda params, backend: real(params, "cuda"))


def test_compaction_mode_follows_the_reference_gate():
    p = trt.RenderParams()
    assert tr.compaction_mode(p, "cuda") is None
    assert tr.compaction_mode(p.replace(compaction=True), "cuda") == "morton"
    for mode in ("morton", "octant"):
        assert tr.compaction_mode(p.replace(compaction=mode), "cuda") == mode
        assert tr.compaction_mode(p.replace(compaction=mode), "torch") is None


@pytest.mark.parametrize("name", SCENES)
def test_scene_aabb_bit_exact(name):
    js, ts, _ = scene_pair(name)
    for got, want in zip(tr._scene_aabb(ts), jr._scene_aabb(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", SCENES)
def test_ray_sort_key_bit_exact(name):
    js, ts, _ = scene_pair(name)
    o, d, alive = _rays(js, 4096, seed=3)
    want = np.asarray(jr._ray_sort_key(*jr._scene_aabb(js), jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(alive)))
    got = tr._ray_sort_key(*tr._scene_aabb(ts), t_(o), t_(d), t_(alive))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (want[~alive] == 0xFFFFFFFF).all()
    assert len(np.unique(want[alive])) > 100   # the key does sort
    # the permutation the morton mode applies (on int32 keys) is
    # jnp.argsort's, which is stable
    order = tr._morton_order(*tr._scene_aabb(ts), t_(o), t_(d), t_(alive))
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(want))))


@pytest.mark.parametrize("name", SCENES)
def test_octant_order_bit_exact(name):
    """The stable argsort of the bucket is the reference's counting-sort
    permutation, and jnp.argsort's of the same bucket."""
    js, _, _ = scene_pair(name)
    o, d, alive = _rays(js, 4096, seed=4)
    got = tr._octant_order(t_(d), t_(alive)).numpy()
    want = np.asarray(jr._octant_order(jnp.asarray(d), jnp.asarray(alive)))
    np.testing.assert_array_equal(got, want)
    octant = ((d[:, 0] > 0) + 2 * (d[:, 1] > 0) + 4 * (d[:, 2] > 0))
    bucket = np.where(alive, octant, 8)
    np.testing.assert_array_equal(got, np.asarray(jnp.argsort(
        jnp.asarray(bucket))))
    assert (bucket[got] == np.sort(bucket)).all()


def test_orders_are_stable_with_ties_and_dead_lanes():
    """Many equal keys (every ray from one origin, one octant) keep their
    lanes' order in both compactions, dead lanes last."""
    n = 1000
    o = torch.zeros((n, 3))
    d = torch.ones((n, 3))
    alive = torch.arange(n) % 3 != 0
    want = torch.cat([torch.nonzero(alive)[:, 0], torch.nonzero(~alive)[:, 0]])
    lo, hi = torch.full((3,), -1.0), torch.ones(3)
    assert torch.equal(tr._octant_order(d, alive), want)
    assert torch.equal(tr._morton_order(lo, hi, o, d, alive), want)


ROOM = dict(width=32, height=32, bounces=2, skybox=True)


def _frame(ts, cam, frame=0, **p):
    return tr.render_frame(ts, trt.camera_basis(trt.Camera(**vars(cam))),
                           trt.RenderParams(**p), frame)


@pytest.mark.parametrize("mode", ["octant", "morton"])
def test_compacted_nee_mis_frame_bit_equal(mode, monkeypatch):
    """The reference's test_mis_with_compaction_bitexact: NEE + MIS on
    room, compacted against uncompacted, coherent scatter off. The MIS
    carry rides the permutation with the rest of the lane's state."""
    _, ts, cam = scene_pair("room")
    p = dict(ROOM, nee=True)
    want = _frame(ts, cam, **p)
    compacting_on_cpu(monkeypatch)
    got = _frame(ts, cam, **p, compaction=mode)
    assert torch.equal(got, want)


def test_compaction_ignored_on_the_torch_backend():
    """Without the patch the plain backend ignores the knob, as the
    reference's jnp backend does: the image is bit-equal to off."""
    _, ts, cam = scene_pair("room")
    p = dict(ROOM, coherent_scatter=True, coherent_tile=0)
    want = _frame(ts, cam, **p)
    for mode in (True, "octant", "morton"):
        assert torch.equal(_frame(ts, cam, **p, compaction=mode), want)


def test_morton_coherent_matches_reference_kernel_backend(monkeypatch):
    """With coherent scatter on the share tiles draw over the sorted
    lanes: the port's compacted frame against the reference's compacted
    frame on its kernels' backend (Pallas, interpreted on the CPU), under
    the image gate, and against the uncompacted frame, which it differs
    from."""
    js, ts, cam = scene_pair("room")
    p = dict(ROOM, coherent_scatter=True, coherent_tile=0)
    want = np.asarray(jr.render_frame(
        js, jrt.camera_basis(cam),
        jrt.RenderParams(backend="pallas", compaction="morton", **p),
        jnp.int32(1)))
    off = _frame(ts, cam, 1, **p).numpy()
    compacting_on_cpu(monkeypatch)
    got = _frame(ts, cam, 1, **p, compaction="morton").numpy()
    assert frac_off(got, want) < GATE
    assert frac_off(got, off) > GATE


def _mse_grads(ts, cam, params, target, frame=1):
    fields = [k for k in ("sphere_albedo", "sphere_center", "sphere_radius",
                          "tri_albedo", "tri_v0", "tri_v1", "tri_v2",
                          "tri_emission", "sphere_smoothness")]
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    img = tr.render_frame(dataclasses.replace(ts, **leaves),
                          trt.camera_basis(trt.Camera(**vars(cam))),
                          trt.RenderParams(**params), frame)
    loss = torch.mean((img - target) ** 2)
    return img.detach(), dict(zip(fields, torch.autograd.grad(
        loss, list(leaves.values()))))


def _assert_grads_close(got, want, tol):
    for k, w in want.items():
        scale = float(w.abs().max())
        assert bool(torch.isfinite(got[k]).all()), k
        assert float((got[k] - w).abs().max()) <= tol * scale, k
    assert float(want["tri_v0"].abs().max()) > 0


@pytest.mark.parametrize("mode", ["octant", "morton"])
def test_compacted_gradient_matches_uncompacted(mode, monkeypatch):
    """An MSE gradient through compacted segments (the permutation's
    backward is the transpose gather) against the uncompacted one,
    coherent scatter off: per leaf within 1e-5 of its max |g|."""
    _, ts, cam = scene_pair("room")
    p = dict(ROOM, width=16, height=16)
    target = 0.5 * _frame(ts, cam, 0, **p)
    img0, g0 = _mse_grads(ts, cam, p, target)
    compacting_on_cpu(monkeypatch)
    img1, g1 = _mse_grads(ts, cam, dict(p, compaction=mode), target)
    assert torch.equal(img0, img1)
    _assert_grads_close(g1, g0, 1e-5)


def test_compaction_on_the_kernels_path(monkeypatch):
    """The kernels' path with its CPU stand-ins (the closest-hit kernel's
    plain version, the winner rows' scatter-add backward), which the card
    takes with compaction: the frame and its gradient against the same
    path uncompacted, coherent scatter off."""
    from test_torch_grad import kernel_path_on_cpu
    _, ts, cam = scene_pair("terrain")
    p = dict(ROOM, width=16, height=16, nee=False)
    target = 0.5 * _frame(ts, cam, 0, **p)
    img0, g0 = _mse_grads(ts, cam, p, target)
    calls = kernel_path_on_cpu(monkeypatch)
    img1, g1 = _mse_grads(ts, cam, dict(p, compaction="morton"), target)
    assert len(calls) == p["bounces"] + 1
    assert torch.equal(img0, img1)
    _assert_grads_close(g1, g0, 1e-5)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["terrain", "terrain_nee"])
def test_compacted_frame_bit_equal_on_cuda(name, cuda_device, monkeypatch):
    """On the card, through the kernels: each compacted frame equals the
    uncompacted one bit for bit with coherent scatter off (NEE + MIS on
    terrain_nee); with it on, the compacted frame stays under the image
    gate of the plain path's compacted frame on the same tensors."""
    _, ts, cam = scene_pair(name)
    ts = ts.to(cuda_device)
    p = dict(width=64, height=48, bounces=3, skybox=True, backend="cuda",
             nee="nee" in name)
    basis = trt.camera_basis(trt.Camera(**dict(vars(cam), aspect=64 / 48)))
    want = tr.render_frame(ts, basis, trt.RenderParams(**p), 0)
    for mode in ("octant", "morton"):
        got = tr.render_frame(ts, basis,
                              trt.RenderParams(compaction=mode, **p), 0)
        assert torch.equal(got, want), mode
    coherent = trt.RenderParams(compaction="morton", coherent_scatter=True,
                                coherent_tile=0, **p)
    got = tr.render_frame(ts, basis, coherent, 0)
    compacting_on_cpu(monkeypatch)
    plain = tr.render_frame(ts, basis, coherent.replace(backend="torch"), 0)
    assert frac_off(got.cpu(), plain.cpu()) < GATE
