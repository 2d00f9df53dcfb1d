"""Port parity of ``parallel/`` and the mesh branches of
``grad/inverse.py``: pixel ids, sharded renders, the mesh loss's and the
sharded chunked gradient, and a training step on a mesh.

The 2-rank cases run in one spawn of two real processes joined by gloo on
the CPU (``_torch_parallel_worker.py``); the reference's counterparts run
here on ``make_mesh(2)`` of the 8 virtual CPU devices (conftest.py). With
coherent scatter on, a share tile of 512 lanes only forms where 512 divides
the lanes a shard passes, so sharded frames are held to the reference's
sharded frames, not to single-device ones.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.grad import inverse as jinv
from ray_tracer_tpu.parallel import make_mesh as j_make_mesh
from ray_tracer_tpu.parallel import render_frame_distributed as j_render_dist
from ray_tracer_tpu.parallel.shard import _padded_ids as j_padded_ids
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu.renderer import render_pixels as j_render_pixels
from ray_tracer_tpu_torch.grad import inverse as tinv
from ray_tracer_tpu_torch.parallel import (distributed, make_mesh,
                                           render_frame_distributed,
                                           shard_map_fn)
from ray_tracer_tpu_torch.parallel.shard import _padded_ids

from test_torch_common import one_thread, t_, terrain, to_port  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
RENDERS = {
    "metal16": dict(scene="metal", frame=0, params=dict(
        width=16, height=16, bounces=2, skybox=True)),
    "metal13x7": dict(scene="metal", frame=0, params=dict(
        width=13, height=7, bounces=1, skybox=True)),
    # frame 3: at frames 0-2 the two packages' single-device NEE frames of
    # terrain_nee already differ by up to 6.3e-5 (the last-bit differences
    # of transcendentals that test_torch_nee.py routes around); at frame 3
    # they agree to 1.8e-6, so the bound isolates the sharding
    "terrain_nee": dict(scene="terrain_nee", frame=3, params=dict(
        width=16, height=16, bounces=2, skybox=True, nee=True,
        coherent_scatter=True, coherent_tile=0)),
}
pytestmark = pytest.mark.usefixtures("one_thread")

GRADS = dict(scene="metal", frame=0, chunks=2,
             fields=list(jinv.DEFAULT_TRAINABLE),
             params=dict(width=16, height=16, bounces=1, skybox=True))
TRAIN = dict(scene="room", grad_chunks=2, edge_samples=2,
             params=dict(width=16, height=16, bounces=1, skybox=True,
                         nee=True))
# gradient bounds, of each leaf's max |g| (where the reference is finite):
# against the port's own single-process gradient, where only the f32
# summation order differs, and against jax.grad of the reference's mesh
# loss, where the two packages' single-device gradients of this frame
# already differ by 5.1e-5 (sphere_center: last-bit differences of the
# shading, as test_torch_grad.py's 3e-4 allows)
SELF_REL, REFERENCE_REL = 1e-5, 1e-4


def reference_scenes():
    metal, metal_cam = jrt.builtin_scene("metal", aspect=1.0)
    room, room_cam = jrt.builtin_scene("room", aspect=1.0)
    tn, tn_cam = terrain(jrt, lights=True)
    return {"metal": (metal, metal_cam), "room": (room, room_cam),
            "terrain_nee": (tn, tn_cam)}


def j_basis(cam, params):
    return jrt.camera_basis(cam.replace(aspect=params.aspect))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the worker as ranks 0 and 1; (rank 0's, rank 1's) results and
    the reference's scenes."""
    tmp = tmp_path_factory.mktemp("ranks")
    scenes = reference_scenes()
    arrays = {f"{name}__{k}": np.asarray(v) for name, (s, _) in scenes.items()
              for k, v in dataclasses.asdict(s).items()}
    gp = jrt.RenderParams(backend="jnp", **GRADS["params"])
    s, cam = scenes[GRADS["scene"]]
    arrays["grad_target"] = np.asarray(j_render_frame(
        s, j_basis(cam, gp), gp, jnp.int32(1)))
    np.savez(tmp / "inputs.npz", **arrays)
    spec = {"cameras": {name: dataclasses.asdict(cam)
                        for name, (_, cam) in scenes.items()},
            "renders": RENDERS, "grads": GRADS, "train": TRAIN}
    (tmp / "inputs.json").write_text(json.dumps(spec))

    with socket.socket() as sock:          # a free port for rank 0
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
         str(r), str(port), str(tmp / "inputs"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(HERE)) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
        line = json.loads(out.strip().splitlines()[-1])
        assert line["ok"] and line["world"] == 2
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, scenes


def test_padded_ids_match_reference():
    """Blocked 16x8 order (coherent scatter on) and raster order, padded
    with the last id to a multiple of the ranks, at three sizes."""
    scene, _ = trt.builtin_scene("metal", device="cpu")
    for w, h in ((16, 16), (13, 7), (1920, 1080)):
        for coherent in (True, False):
            kw = dict(width=w, height=h, coherent_scatter=coherent)
            for n_dev in (1, 2, 3, 8):
                want, w_blocked, w_inv = j_padded_ids(
                    jrt.RenderParams(backend="jnp", **kw), n_dev)
                got, blocked, inv = _padded_ids(trt.RenderParams(**kw),
                                                n_dev, scene)
                assert blocked == w_blocked == coherent
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                if coherent:
                    np.testing.assert_array_equal(inv.numpy(), w_inv)


@pytest.mark.parametrize("case", sorted(RENDERS))
def test_two_rank_render_matches_reference(two_ranks, case):
    """The gathered frame is the reference's 2-device frame (its own
    bound, atol 1e-5), the same on both ranks and on the (host, chip)
    mesh."""
    ranks, scenes = two_ranks
    c = RENDERS[case]
    s, cam = scenes[c["scene"]]
    params = jrt.RenderParams(backend="jnp", **c["params"])
    want = np.asarray(j_render_dist(s, j_basis(cam, params), params,
                                    c["frame"], j_make_mesh(2)))
    got = ranks[0][f"render__{case}"]
    assert got.shape == (params.height, params.width, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(ranks[1][f"render__{case}"], got)
    np.testing.assert_array_equal(ranks[0][f"render_hc__{case}"], got)


def _assert_grads(got, want, rel):
    nonzero = 0
    for k, w in want.items():
        w = np.asarray(w)
        finite = np.isfinite(w)
        scale = float(np.abs(w[finite]).max()) if finite.any() else 0.0
        assert np.isfinite(got[k]).all(), k
        err = float(np.abs(got[k][finite] - w[finite]).max(initial=0.0))
        assert err <= rel * max(scale, 1e-12), (k, err, scale)
        nonzero += scale > 0
    assert nonzero >= 2


def _reference_grads():
    scenes = reference_scenes()
    s, cam = scenes[GRADS["scene"]]
    params = jrt.RenderParams(backend="jnp", **GRADS["params"])
    basis = j_basis(cam, params)
    target = j_render_frame(s, basis, params, jnp.int32(1))
    trainable, _ = jinv.split_scene(s, tuple(GRADS["fields"]))
    return s, basis, params, target, trainable


def _single_process_grads():
    """The port's whole-frame loss and gradients in this process."""
    js, basis, params, target, trainable = _reference_grads()
    ts = to_port(js)
    cam = reference_scenes()[GRADS["scene"]][1]
    tp = trt.RenderParams(**GRADS["params"])
    tb = trt.camera_basis(trt.Camera(**vars(cam)).replace(aspect=tp.aspect))
    leaves = {k: getattr(ts, k).clone().requires_grad_(True)
              for k in trainable}
    loss = tinv.image_mse(leaves, ts, tb, tp, GRADS["frame"],
                          t_(target))
    g = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: gk.numpy() for k, gk in zip(leaves, g)}


def test_mesh_loss_gradient_matches_reference(two_ranks):
    """image_mse(mesh=) on 2 ranks: loss and every leaf's gradient against
    the port's single-process gradient and jax.grad of the reference's
    image_mse(mesh=make_mesh(2)), on both ranks."""
    ranks, _ = two_ranks
    s, basis, params, target, trainable = _reference_grads()
    loss, g = jax.value_and_grad(jinv.image_mse)(
        trainable, s, basis, params, jnp.int32(GRADS["frame"]), target,
        mesh=j_make_mesh(2))
    own_loss, own = _single_process_grads()
    for r in ranks:
        got = {k: r[f"mse__{k}"] for k in g}
        assert float(r["mse_loss"]) == pytest.approx(own_loss, rel=1e-6)
        assert float(r["mse_loss"]) == pytest.approx(float(loss), rel=1e-5)
        _assert_grads(got, own, SELF_REL)
        _assert_grads(got, g, REFERENCE_REL)


def test_sharded_chunked_gradient_matches_reference(two_ranks):
    """sharded_chunked_mse_value_and_grad (2 ranks x 2 chunks, a per-chunk
    asynchronous all-reduce) against the port's single-process gradient
    and the reference's on make_mesh(2)."""
    ranks, _ = two_ranks
    s, basis, params, target, trainable = _reference_grads()

    def rp(tr, ids):
        return j_render_pixels(jinv.merge_scene(s, tr), basis, params,
                               jnp.int32(GRADS["frame"]), ids)

    loss, g = jinv.sharded_chunked_mse_value_and_grad(
        trainable, rp, params, target, GRADS["chunks"], j_make_mesh(2))
    own_loss, own = _single_process_grads()
    for r in ranks:
        got = {k: r[f"chunked__{k}"] for k in g}
        assert float(r["chunked_loss"]) == pytest.approx(own_loss, rel=1e-6)
        assert float(r["chunked_loss"]) == pytest.approx(float(loss),
                                                         rel=1e-5)
        _assert_grads(got, own, SELF_REL)
        _assert_grads(got, g, REFERENCE_REL)


def test_train_step_on_mesh_keeps_ranks_equal(two_ranks):
    """make_train_step(mesh, grad_chunks=2, edge_samples=2) on room with
    NEE (the reference's dryrun_multichip): a finite loss, the same on
    both ranks, and the same trainable on both ranks after the step."""
    ranks, _ = two_ranks
    assert np.isfinite(ranks[0]["train_loss"])
    assert ranks[0]["train_loss"] == ranks[1]["train_loss"]
    keys = [k for k in ranks[0] if k.startswith("train__")]
    assert len(keys) == len(tinv.DEFAULT_TRAINABLE)
    for k in keys:
        assert np.isfinite(ranks[0][k]).all(), k
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_host_chip_mesh_groups_ranks_by_host(two_ranks):
    ranks, _ = two_ranks
    assert ranks[0]["host_chip_shape"].tolist() == [1, 2]
    grid = distributed._host_grid([0, 1, 2, 3], ["a", "b", "a", "b"])
    assert grid.tolist() == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="uneven"):
        distributed._host_grid([0, 1, 2], ["a", "a", "b"])
    assert distributed.pixel_sharding_spec() == (distributed.HOST_AXIS,
                                                 distributed.CHIP_AXIS)


def test_initialize_alone_and_idempotent(monkeypatch):
    """Without a coordinator or torchrun's environment initialize()
    returns False; once a group exists it returns True, every time."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with monkeypatch.context() as m:
        m.setattr(dist, "is_initialized", lambda: False)
        assert distributed.initialize(device="cpu") is False
    make_mesh()
    assert distributed.initialize(device="cpu") is True
    assert distributed.initialize(device="cpu") is True
    with pytest.raises(ValueError, match="requested 2"):
        make_mesh(2)


@pytest.mark.parametrize("name,kw", [
    ("metal", dict(bounces=2)),
    ("room", dict(bounces=2, nee=True, coherent_scatter=True,
                  coherent_tile=0)),
])
def test_one_rank_mesh_equals_render_frame(name, kw):
    """render_frame_distributed on the one-rank default mesh runs the same
    collectives at world size 1 and gives render_frame's frame bit for
    bit; 13x7 pads nothing at one rank but takes the inverse gather."""
    scene, cam = trt.builtin_scene(name, device="cpu")
    for w, h in ((16, 16), (13, 7)):
        params = trt.RenderParams(width=w, height=h, skybox=True, **kw)
        basis = trt.camera_basis(cam.replace(aspect=params.aspect))
        want = trt.render_frame(scene, basis, params, 3)
        got = render_frame_distributed(scene, basis, params, 3)
        assert torch.equal(got, want)


def test_shard_map_fn_on_one_rank():
    mesh = make_mesh()
    out = shard_map_fn(lambda scale, x: x * scale, mesh)(2.0, torch.ones(5))
    assert torch.equal(out, torch.full((5,), 2.0))
    assert mesh.size == 1 and mesh.rank == 0 and mesh.shape == (1,)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_one_rank_mesh_on_the_kernels_path(cuda_device):
    """On the card the one-rank mesh's frame is render_frame's through the
    closest-hit kernel, bit for bit, with the same launches."""
    from ray_tracer_tpu_torch.ops import closest_hit
    scene, cam = trt.builtin_scene("room", aspect=2.0, device=cuda_device)
    params = trt.RenderParams(width=128, height=64, bounces=2, skybox=True,
                              coherent_scatter=True, coherent_tile=0)
    basis = trt.camera_basis(cam)
    closest_hit.nearest_hit_attrs.launches = 0
    want = trt.render_frame(scene, basis, params, 1)
    got = render_frame_distributed(scene, basis, params, 1)
    assert closest_hit.nearest_hit_attrs.launches == 2 * (params.bounces + 1)
    assert torch.equal(got, want)
