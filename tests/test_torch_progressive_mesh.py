"""Progressive rendering over a mesh (``parallel/progressive.py``) and
the ``render`` command under ``torchrun``, on gloo ranks on the CPU.

The gathered image of 2 and of 4 ranks equals one process's
``render_progressive`` bit for bit: a call and a call continuing it, with
coherent scatter on where the share tiles split unevenly over the ranks,
where the frame is no whole tiles, with ``coherent_tile`` set, in chunks,
and in raster order. The ranks' runs are whole share tiles, which an even
split of the lanes is not, and whole 128-lane pixel blocks where no draw
is shared. ``render`` under ``torch.distributed.run``
writes the one-process command's ``.npy``, and the one-process command
imports nothing of the mesh path.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch.parallel.progressive import (
    render_progressive_distributed, shard_bounds)
from ray_tracer_tpu_torch.renderer import frame_lanes

from _torch_progressive_worker import CALLS, CASES, case_params
from test_torch_common import one_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
pytestmark = pytest.mark.usefixtures("one_thread")


def share_tile(params):
    """The share tile of the one-process frame (``frame_lanes``)."""
    scene, _ = trt.builtin_scene("metal", device="cpu")
    return frame_lanes(scene, params)[2]


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"{w}ranks")
def ranks(request, tmp_path_factory):
    """Every rank's images of CASES, from one group of ``world`` gloo
    ranks."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{world}")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_progressive_worker.py"),
         str(r), str(world), str(port), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(world)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
        assert json.loads(out.strip().splitlines()[-1])["ok"]
    return world, [dict(np.load(tmp / f"rank{r}.npz"))
                   for r in range(world)]


@pytest.fixture(scope="module")
def one_process():
    """One process's render_progressive images of CASES."""
    scene, cam = trt.builtin_scene("metal", device="cpu")
    want = {}
    for name in CASES:
        params = case_params(name)
        basis = trt.camera_basis(cam.replace(aspect=params.aspect))
        img = None
        for k, (frames, start) in enumerate(CALLS):
            img = trt.render_progressive(scene, basis, params, frames,
                                         start_frame=start, image0=img)
            want[f"{name}__{k}"] = img.numpy()
    return want


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_image_equals_one_process(ranks, one_process, case):
    world, got = ranks
    for k in range(len(CALLS)):
        want = one_process[f"{case}__{k}"]
        assert want.std() > 1e-3
        for r in range(world):
            np.testing.assert_array_equal(got[r][f"{case}__{k}"], want,
                                          err_msg=f"rank {r} call {k}")


def test_one_gather_a_call_and_each_ranks_tiles(ranks):
    world, got = ranks
    for r in range(world):
        assert int(got[r]["gathers"]) == len(CASES) * len(CALLS)
    # 64x40 is 5 tiles of 512: the first 5 % world ranks hold one more
    tiles = [int(g["uneven_tiles__tiles"]) for g in got]
    assert tiles == [5 // world + (r < 5 % world) for r in range(world)]
    assert all(int(g["not_whole_tiles__tiles"]) == 0 for g in got)
    assert sum(int(g["tile_128__tiles"]) for g in got) == 15


@pytest.mark.parametrize("w,h,world,tiles", [
    (1920, 1080, 4, [1013, 1013, 1012, 1012]),
    (1920, 1080, 2, [2025, 2025]),
    (64, 40, 4, [2, 1, 1, 1]),
    (800, 800, 3, [417, 417, 416]),
])
def test_shards_are_whole_share_tiles(w, h, world, tiles):
    """Every rank's run starts on a tile and holds whole tiles, the first
    ranks one more: what an even split of the lanes (518,400 a rank at
    1080p on 4 ranks, 1012.5 tiles) is not."""
    params = trt.RenderParams(width=w, height=h, coherent_scatter=True,
                              coherent_tile=0)
    n = w * h
    tile = share_tile(params)
    assert tile == 512
    bounds = shard_bounds(n, world, tile)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for a, b in bounds:
        assert a % tile == 0 and (b - a) % tile == 0
    assert [(b - a) // tile for a, b in bounds] == tiles


def test_no_shared_draws_where_one_process_has_none():
    # 48x40 is 3.75 tiles: the one-process frame shares no draw, so no
    # run may, though 1920 lanes split evenly over 3 ranks are 640 each
    params = trt.RenderParams(width=48, height=40, coherent_scatter=True,
                              coherent_tile=0)
    assert share_tile(params) == 0
    # its runs are whole 128-lane pixel blocks instead
    assert shard_bounds(1920, 3, 128) == [(0, 640), (640, 1280),
                                          (1280, 1920)]
    assert shard_bounds(960, 4, 128) == [(0, 256), (256, 512), (512, 768),
                                         (768, 960)]
    # chunks of whole tiles share, though the frame is not whole tiles
    assert share_tile(params.replace(chunk_pixels=1024)) == 512
    assert share_tile(params.replace(coherent_scatter=False,
                                     width=64, height=32)) == 0


def test_no_group_is_the_one_process_path():
    import torch.distributed as dist
    assert not dist.is_initialized()
    scene, cam = trt.builtin_scene("metal", device="cpu")
    params = case_params("uneven_tiles")
    basis = trt.camera_basis(cam.replace(aspect=params.aspect))
    before = render_progressive_distributed.gathers
    got = render_progressive_distributed(scene, basis, params, 2)
    want = trt.render_progressive(scene, basis, params, 2)
    assert torch.equal(got, want)
    assert render_progressive_distributed.gathers == before
    assert not dist.is_initialized()


RENDER = ["render", "--scene", "metal", "--width", "64", "--height", "40",
          "--frames", "3", "--bounces", "2", "--skybox", "--coherent"]
# the one-process command in a fresh process: its image, and the port's
# modules it loaded
ONE_PROCESS = (
    "import sys, json\n"
    "sys.path.insert(0, {repo!r})\n"
    "import torch; torch.set_num_threads(1)\n"
    "import torch.distributed as dist\n"
    "from ray_tracer_tpu_torch import cli\n"
    "cli.main({argv!r})\n"
    "print(json.dumps({{'modules': sorted(m for m in sys.modules\n"
    "    if m.startswith('ray_tracer_tpu_torch')),\n"
    "    'group': dist.is_initialized()}}))\n")


@pytest.fixture(scope="module")
def one_process_command(tmp_path_factory):
    out = tmp_path_factory.mktemp("one") / "one.npy"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env.update(RTT_PLATFORM="cpu", OMP_NUM_THREADS="1")
    code = ONE_PROCESS.format(repo=REPO, argv=RENDER + ["-o", str(out)])
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    return np.load(out), json.loads(run.stdout.strip().splitlines()[-1])


def test_one_process_render_imports_no_mesh_path(one_process_command):
    _, loaded = one_process_command
    assert "ray_tracer_tpu_torch.cli" in loaded["modules"]
    assert "ray_tracer_tpu_torch.parallel.progressive" not in loaded[
        "modules"]
    assert loaded["group"] is False


def test_render_under_torchrun_writes_the_one_process_image(
        one_process_command, tmp_path):
    want, _ = one_process_command
    out = tmp_path / "ranks.npy"
    env = dict(os.environ, RTT_PLATFORM="cpu", OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ray_tracer_tpu_torch", *RENDER,
         "-o", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    # rank 0 alone writes the image
    assert run.stderr.count(f"wrote {out}") == 1
    assert "on 2 ranks" in run.stderr
    got = np.load(out)
    assert got.shape == (40, 64, 3) and want.std() > 1e-3
    np.testing.assert_array_equal(got, want)
