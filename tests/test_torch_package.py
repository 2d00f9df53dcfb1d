"""The port's package boundary: no JAX, explicit backends, and unported
features that raise instead of doing something else."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.io import image as j_image
from ray_tracer_tpu_torch.io import image as t_image
from ray_tracer_tpu_torch.ops import intersect as tint
from ray_tracer_tpu_torch.utils import build

from test_torch_common import scene_pair, t_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import ray_tracer_tpu_torch, ray_tracer_tpu_torch.renderer\n"
            "import ray_tracer_tpu_torch.ops.closest_hit\n"
            "import ray_tracer_tpu_torch.ops.scatter_rows\n"
            "import ray_tracer_tpu_torch.grad.inverse\n"
            "import ray_tracer_tpu_torch.utils.build\n"
            "import ray_tracer_tpu_torch.io\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tracer_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_backend_resolution():
    scene, cam = trt.builtin_scene("metal")
    assert tint.resolve_backend("auto", scene.device) == "torch"
    assert tint.resolve_backend("torch", scene.device) == "torch"
    with pytest.raises(ValueError, match="cuda"):
        tint.resolve_backend("cuda", scene.device)
    with pytest.raises(ValueError, match="backend"):
        trt.RenderParams(backend="jnp")


def test_cuda_backend_on_cpu_tensors_raises():
    scene, cam = trt.builtin_scene("metal")
    params = trt.RenderParams(width=16, height=16, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        trt.render_frame(scene, trt.camera_basis(cam), params, 0)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="cuda"):
        tint.intersect(scene, o, d, backend="cuda")


@pytest.mark.parametrize("feature,value", [
    ("nee", True), ("compaction", "octant"), ("rr_start", 2), ("qmc", True),
    ("remat", True)])
def test_unported_feature_raises(feature, value):
    scene, cam = trt.builtin_scene("metal")
    params = trt.RenderParams(width=16, height=16, **{feature: value})
    with pytest.raises(NotImplementedError, match=feature):
        trt.render(scene, cam, params)


@pytest.mark.parametrize("fn", ["render_aov", "render_adaptive"])
def test_unported_entry_point_raises(fn):
    scene, cam = trt.builtin_scene("metal")
    with pytest.raises(NotImplementedError, match=fn):
        getattr(trt, fn)(scene, trt.camera_basis(cam), trt.RenderParams())


def test_textures_raise():
    with pytest.raises(NotImplementedError, match="textures"):
        trt.SceneBuilder().add_texture(np.zeros((4, 4, 3), np.float32))
    b = jrt.SceneBuilder()
    b.add_texture(np.ones((4, 4, 3), np.float32), srgb=False)
    b.add_mesh([(0, 0, 2), (1, 0, 2), (0, 1, 2)], [(0, 0, -1)] * 3,
               [0, 2, 1], uvs=[(0, 0), (1, 0), (0, 1)], tex=0)
    import dataclasses
    scene = trt.scene_from_numpy({k: np.asarray(v) for k, v in
                                  dataclasses.asdict(b.build()).items()})
    assert scene.num_textures == 1
    o, d = torch.zeros((2, 3)), torch.tensor([[0.1, 0.1, 1.0]] * 2)
    with pytest.raises(NotImplementedError, match="textures"):
        tint.intersect(scene, o, d, backend="torch")


def test_kernel_build_is_keyed_by_source_inside_the_repo():
    path = build.library_path("closest_hit")
    assert path == build.library_path("closest_hit")
    assert str(path).startswith(os.path.join(REPO, "build",
                                             "ray_tracer_tpu_torch"))
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_each_kernel_builds_into_its_own_library():
    libs = {build.library_path(n) for n in ("closest_hit", "scatter_rows")}
    assert len(libs) == 2
    assert all(p.parent == build.BUILD_DIR for p in libs)


def test_image_io_matches_reference(tmp_path):
    img = np.random.default_rng(0).random((6, 5, 3)).astype(np.float32) * 1.2
    np.testing.assert_array_equal(t_image.to_uint8(t_(img)),
                                  j_image.to_uint8(img))
    t_image.write_npy(str(tmp_path / "a.npy"), t_(img))
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), img[::-1])
    t_image.write_png(str(tmp_path / "a.png"), t_(img))
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  j_image.to_uint8(img))


def test_public_names_match_reference():
    ported = set(trt.__all__) - {"scene_from_numpy", "io", "grad"}
    assert ported <= set(jrt.__all__)
    for name in trt.__all__:
        assert hasattr(trt, name), name
    import ray_tracer_tpu.grad as j_grad
    assert trt.grad.__all__ == j_grad.__all__
    for name in trt.grad.__all__:
        assert hasattr(trt.grad, name), name


def test_scene_moves_between_devices_with_to():
    js, ts, _ = scene_pair("metal")
    assert ts.to("cpu").device == torch.device("cpu")
    assert trt.camera_basis(trt.Camera((0, 0, 1), (0, 0, 0))).to(
        "cpu").origin.device == torch.device("cpu")
