"""The port's package boundary: no JAX, explicit backends, entry points
on the card, and the kernels' build."""

import contextlib
import ctypes
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.io import image as j_image
from ray_tracer_tpu_torch.io import image as t_image
from ray_tracer_tpu_torch.ops import (anyhit, blocked_hit, closest_hit,
                                      hit_record, scatter_rows, srgb_encode)
from ray_tracer_tpu_torch.ops import intersect as tint
from ray_tracer_tpu_torch.utils import build

from test_torch_common import scene_pair, t_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import ray_tracer_tpu_torch, ray_tracer_tpu_torch.renderer\n"
            "import ray_tracer_tpu_torch.ops.closest_hit\n"
            "import ray_tracer_tpu_torch.ops.scatter_rows\n"
            "import ray_tracer_tpu_torch.ops.anyhit\n"
            "import ray_tracer_tpu_torch.ops.blocked_hit\n"
            "import ray_tracer_tpu_torch.texture\n"
            "import ray_tracer_tpu_torch.lights\n"
            "import ray_tracer_tpu_torch.grad.inverse\n"
            "import ray_tracer_tpu_torch.utils.build\n"
            "import ray_tracer_tpu_torch.io\n"
            "import ray_tracer_tpu_torch.io.loaders\n"
            "import ray_tracer_tpu_torch.grad.edges\n"
            "import ray_tracer_tpu_torch.grad.topology\n"
            "import ray_tracer_tpu_torch.models\n"
            "import ray_tracer_tpu_torch.utils.native\n"
            "import ray_tracer_tpu_torch.tools.invert_vertices\n"
            "import ray_tracer_tpu_torch.tools.invert_teapot\n"
            "import ray_tracer_tpu_torch.parallel\n"
            "import ray_tracer_tpu_torch.parallel.distributed\n"
            "import ray_tracer_tpu_torch.cli, ray_tracer_tpu_torch.viewer\n"
            "import ray_tracer_tpu_torch.utils.checkpoint\n"
            "import ray_tracer_tpu_torch.utils.metrics\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tracer_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_scene_entry_points_default_to_the_card():
    """The built-in scenes, SceneBuilder.build and scene_from_numpy build
    on "cuda" unless the caller asks for the CPU. With a card the scene
    lands there; without one they raise, as torch does, and never carry
    on on the CPU."""
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(
        jrt.builtin_scene("metal")[0]).items()}
    builds = {name: lambda name=name: trt.builtin_scene(name)[0]
              for name in trt.BUILTIN_SCENES}
    builds["SceneBuilder.build"] = lambda: trt.SceneBuilder().add_sphere(
        (0, 0, 0), 1.0, (1, 1, 1)).build()
    builds["scene_from_numpy"] = lambda: trt.scene_from_numpy(fields)
    if torch.cuda.is_available():
        for name, make in builds.items():
            assert make().device.type == "cuda", name
    else:
        for name, make in builds.items():
            with pytest.raises((AssertionError, RuntimeError)):
                make()
    assert trt.builtin_scene("metal", device="cpu")[0].device.type == "cpu"


def test_backend_resolution():
    scene, cam = trt.builtin_scene("metal", device="cpu")
    assert tint.resolve_backend("auto", scene.device) == "torch"
    assert tint.resolve_backend("torch", scene.device) == "torch"
    with pytest.raises(ValueError, match="cuda"):
        tint.resolve_backend("cuda", scene.device)
    with pytest.raises(ValueError, match="backend"):
        trt.RenderParams(backend="jnp")


def test_cuda_backend_on_cpu_tensors_raises():
    scene, cam = trt.builtin_scene("metal", device="cpu")
    params = trt.RenderParams(width=16, height=16, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        trt.render_frame(scene, trt.camera_basis(cam), params, 0)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="cuda"):
        tint.intersect(scene, o, d, backend="cuda")


def test_a_reference_textured_scene_renders_on_the_cpu():
    """A textured scene built by the reference and carried across by
    scene_from_numpy renders through the port's entry points on the CPU,
    plain path and kernels' path alike."""
    b = jrt.SceneBuilder(texture_resolution=4)
    b.add_texture(np.ones((4, 4, 3), np.float32) * 0.5, srgb=False)
    b.add_mesh([(0, 0, 2), (1, 0, 2), (0, 1, 2)], [(0, 0, -1)] * 3,
               [0, 2, 1], uvs=[(0, 0), (1, 0), (0, 1)], tex=0)
    scene = trt.scene_from_numpy({k: np.asarray(v) for k, v in
                                  dataclasses.asdict(b.build()).items()},
                                 device="cpu")
    assert scene.num_textures == 1
    o, d = torch.zeros((2, 3)), torch.tensor([[0.1, 0.1, 1.0]] * 2)
    hit = tint.intersect(scene, o, d, backend="torch")
    assert bool(hit.hit.all())
    # the mesh's default tint (0.2, 0.2, 1) times the texel 127 / 255
    assert torch.allclose(hit.albedo, torch.tensor([0.2, 0.2, 1.0])
                          * (127 / 255))
    cam = trt.Camera(origin=(0.3, 0.3, 0.0), look_at=(0.3, 0.3, 2.0))
    img = trt.render(scene, cam, trt.RenderParams(width=8, height=8,
                                                  skybox=True), frames=1)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_kernel_build_is_keyed_by_source_inside_the_repo():
    path = build.library_path("closest_hit")
    assert path == build.library_path("closest_hit")
    assert str(path).startswith(os.path.join(REPO, "build",
                                             "ray_tracer_tpu_torch"))
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_each_kernel_builds_into_its_own_library():
    libs = {build.library_path(n)
            for n in ("closest_hit", "scatter_rows", "anyhit", "blocked_hit")}
    assert len(libs) == 4
    assert all(p.parent == build.BUILD_DIR for p in libs)


def test_kernel_build_key_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes (directly or through
    another header) gives the source a new library; the shared header of
    the ray-query kernels is found."""
    assert build.sources("blocked_hit") == ["blocked_hit.cu",
                                            "hit_common.cuh"]
    assert "hit_common.cuh" in build.sources("closest_hit")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <math.h>\n')
    (tmp_path / "a.cuh").write_text('  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "lone.cu").write_text("// no headers\n")
    assert build.sources("k") == ["a.cuh", "b.cuh", "k.cu"]
    before = (build.library_path("k"), build.library_path("lone"))
    (tmp_path / "b.cuh").write_text("// two\n")
    assert build.library_path("k") != before[0]
    assert build.library_path("lone") == before[1]


class _FakeSymbol:
    """A kernel library's entry point: records its calls, returns
    ``result``; ctypes' ``argtypes`` and ``restype`` are plain fields."""

    def __init__(self, result):
        self.result, self.calls = result, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


class _FakeLibrary:
    """A kernel library with every symbol: each returns 0 until told
    otherwise, and ``rtt_error_string`` returns CUDA's text for code 700."""

    def __getattr__(self, symbol):
        if symbol.startswith("__"):
            raise AttributeError(symbol)
        fn = _FakeSymbol(b"an illegal memory access was encountered"
                         if symbol == "rtt_error_string" else 0)
        setattr(self, symbol, fn)
        return fn


@pytest.mark.parametrize("module", [closest_hit, blocked_hit, anyhit,
                                    scatter_rows, hit_record, srgb_encode],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_kernel_library_binding(module, monkeypatch):
    """``build.library`` types each symbol of an ops module's table and
    binds ``rtt_error_string``, once per library; ``build.launch`` calls
    an entry with the current stream last and turns an error code into a
    RuntimeError naming the kernel and CUDA's error string."""
    name = module.__name__.rsplit(".", 1)[1]   # the library is the module's
    assert f"{name}.cu" in build.sources(name)
    lib, loads = _FakeLibrary(), []
    monkeypatch.setattr(build, "load", lambda n: loads.append(n) or lib)
    monkeypatch.setattr(build, "_TYPED", {})
    assert build.library(name, module.SIGNATURES) is lib
    assert build.library(name, module.SIGNATURES) is lib and loads == [name]
    for symbol, argtypes in module.SIGNATURES.items():
        assert getattr(lib, symbol).argtypes == argtypes
        assert getattr(lib, symbol).restype is ctypes.c_int
    assert lib.rtt_error_string.argtypes == [ctypes.c_int]
    assert lib.rtt_error_string.restype is ctypes.c_char_p
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=77))
    entry = next(iter(module.SIGNATURES))
    build.launch(lib, entry, "fake", "cuda:0", 1, 2)
    assert getattr(lib, entry).calls == [(1, 2, 77)]
    getattr(lib, entry).result = 700
    with pytest.raises(RuntimeError, match="^fake kernel launch failed: an "
                       "illegal memory access was encountered$"):
        build.launch(lib, entry, "fake", "cuda:0", 3)
    assert lib.rtt_error_string.calls == [(700,)]


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
    import ray_tracer_tpu.io as j_io
    ported = set(trt.__all__) - {"scene_from_numpy", "io", "grad", "lights",
                                 "models", "occluded",
                                 "camera_basis_tensor"} - set(j_io.__all__)
    assert ported <= set(jrt.__all__)
    assert trt.io.__all__ == j_io.__all__
    assert trt.models.__all__ == ["scene", "asset", "BUILTIN_SCENES",
                                  "SCENE_IDS"]
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
