"""The port's loaders (io/loaders.py), PNG codec (io/png.py), native
bridge (utils/native.py) and model zoo (models) against the reference's.

Files are written into ``tmp_path``, as tests/test_loaders.py does. Loaded
MeshData must equal the reference's exactly (positions, normals, UVs,
indices, materials and their images), through the port's native parser
and its pure-Python one alike; scenes built by ``load_model`` must equal
the reference's field for field. Tests that need the upstream assets skip
where they are absent, as the reference's do.
"""

import base64
import dataclasses
import io as _io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import models as j_models
from ray_tracer_tpu.io import load_meshes as j_load_meshes
from ray_tracer_tpu.io import load_model as j_load_model
from ray_tracer_tpu_torch import models as t_models
from ray_tracer_tpu_torch.io import image as t_image
from ray_tracer_tpu_torch.io import loaders as tl
from ray_tracer_tpu_torch.io.png import decode_png, encode_png
from ray_tracer_tpu_torch.utils import native

from test_loaders import ASSETS, needs_assets

TEX = 8          # texture images of these tests: TEX x TEX
TEX_RES = 16     # the builders' texture resolution: an upsampling, which
#                  the port's resize gives exactly as Pillow's


def _image(seed, ch=3, size=TEX):
    return (np.random.default_rng(seed).random((size, size, ch)) * 255
            ).astype(np.uint8)


def _png(img, filters=0):
    return encode_png(img, filters)


def assert_meshes_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.name == b.name
        for k in ("positions", "normals", "indices"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert (a.uvs is None) == (b.uvs is None)
        if a.uvs is not None:
            np.testing.assert_array_equal(a.uvs, b.uvs)
        assert (a.material is None) == (b.material is None)
        if a.material is not None:
            assert set(a.material) == set(b.material)
            for k, v in b.material.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(a.material[k], v,
                                                  err_msg=k)
                else:
                    assert a.material[k] == v, k


def _python_parser(monkeypatch):
    monkeypatch.setattr(native, "parse_obj", lambda p: None)


OBJS = {
    "normals": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n",
    "no_normals": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 3 4\n",
    "quads": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n"
              "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
              "f 1/1 2/2 3/3 4/4\no second\nf -2/1 -1/2 2/3 1/4\n"),
    "malformed": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 99\nf -100 2 3\n"
                  "f 1 2 3\n"),
    "groups": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\n"
               "g a\nf 1//1 2//1 3//1\ng b\nf 2//1 4//1 3//1\n"),
}


@pytest.mark.parametrize("case", list(OBJS))
def test_obj_matches_reference_through_both_parsers(case, tmp_path,
                                                    monkeypatch):
    p = tmp_path / f"{case}.obj"
    p.write_text(OBJS[case])
    want = j_load_meshes(str(p))
    assert native.available()    # g++ is here: the native parser runs
    fast = tl.load_meshes(str(p))
    _python_parser(monkeypatch)
    slow = tl.load_meshes(str(p))
    assert_meshes_equal(fast, want)
    assert_meshes_equal(slow, want)
    if case == "malformed":
        assert sum(m.num_triangles for m in slow) == 1
    if case == "quads":
        assert [m.num_triangles for m in slow] == [2, 2]


def _mtl_obj(tmp_path, image_bytes, name="tex.png"):
    (tmp_path / name).write_bytes(image_bytes)
    (tmp_path / "m.mtl").write_text(
        f"newmtl red\nKd 0.9 0.5 0.25\nmap_Kd {name}\n"
        f"newmtl plain\nKd 0.1 0.2 0.3\n")
    p = tmp_path / "m.obj"
    p.write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                 "vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\nvn 0 0 1\n"
                 "o a\nusemtl red\nf 1/1/1 2/2/1 3/3/1\n"
                 "o b\nusemtl plain\nf 2/2/1 4/4/1 3/3/1\n")
    return str(p)


def _scene_fields(scene):
    return {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}


def assert_scenes_equal(ts, js):
    for k, want in _scene_fields(js).items():
        got = getattr(ts, k)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=k)
        else:
            assert got == want, k


def test_obj_with_mtl_texture_matches_reference(tmp_path, monkeypatch):
    path = _mtl_obj(tmp_path, _png(_image(0),
                                   filters=[0, 1, 2, 3, 4, 0, 1, 2]))
    want = j_load_meshes(path)
    assert_meshes_equal(tl.load_meshes(path), want)
    _python_parser(monkeypatch)
    got = tl.load_meshes(path)
    assert_meshes_equal(got, want)
    np.testing.assert_array_equal(got[0].material["diffuse_image"],
                                  _image(0))
    tb = trt.SceneBuilder(texture_resolution=TEX_RES)
    jb = jrt.SceneBuilder(texture_resolution=TEX_RES)
    tl.load_model(path, tb, placement="origin")
    j_load_model(path, jb, placement="origin")
    assert len(tb.textures) == 1
    assert_scenes_equal(tb.build(device="cpu"), jb.build())


def test_mtl_image_without_pillow(tmp_path, monkeypatch):
    """Without Pillow a PNG map still loads (the port's codec) and another
    format takes the reference's path for an undecodable image: a
    warning, no texture."""
    buf = _io.BytesIO()
    Image.fromarray(_image(1)).save(buf, format="BMP")
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = _mtl_obj(tmp_path, _png(_image(2)))
    assert np.array_equal(
        tl.load_meshes(path)[0].material["diffuse_image"], _image(2))
    path = _mtl_obj(tmp_path, buf.getvalue(), name="tex.bmp")
    assert tl.load_meshes(path)[0].material["diffuse_image"] is None


def _gltf_dict(blob_uri, img_entry):
    """A glTF holding one quad mesh of two primitives that share a
    textured material, its buffer as a data URI or (GLB) the blob."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    idx = np.array([0, 1, 2, 1, 3, 2], np.uint16)
    blob = pos.tobytes() + uv.tobytes() + nrm.tobytes() + idx.tobytes()
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
             {"buffer": 0, "byteOffset": 48, "byteLength": 32},
             {"buffer": 0, "byteOffset": 80, "byteLength": 48},
             {"buffer": 0, "byteOffset": 128, "byteLength": 12}]
    attrs = {"POSITION": 0, "TEXCOORD_0": 1, "NORMAL": 2}
    prim = {"attributes": attrs, "material": 0, "indices": 3}
    g = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"name": "quad",
                    "primitives": [dict(prim), dict(prim)]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "baseColorFactor": [0.5, 0.75, 1.0, 1.0]}}],
        "textures": [{"source": 0}],
        "images": [img_entry],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"}],
    }
    if blob_uri:
        g["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                  + base64.b64encode(blob).decode())
    return g, blob


def write_glb(path, png_bytes):
    """A GLB holding the quad twice and ``png_bytes`` embedded as a
    bufferView image."""
    g, blob = _gltf_dict(False, {"bufferView": 4, "mimeType": "image/png"})
    pad = (-len(blob)) % 4
    g["bufferViews"].append({"buffer": 0, "byteOffset": len(blob) + pad,
                             "byteLength": len(png_bytes)})
    blob = blob + b"\0" * pad + png_bytes
    blob += b"\0" * ((-len(blob)) % 4)
    g["buffers"][0]["byteLength"] = len(blob)
    js = json.dumps(g).encode()
    js += b" " * ((-len(js)) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body))
                     + body)
    return str(path)


def test_gltf_shared_texture_decoded_once(tmp_path, monkeypatch):
    """Two primitives sharing one glTF texture (a data URI) decode it once
    and register one texture; the meshes and the scene equal the
    reference's."""
    uri = "data:image/png;base64," + base64.b64encode(
        _png(_image(3), filters=4)).decode()
    g, _ = _gltf_dict(True, {"uri": uri})
    p = tmp_path / "shared.gltf"
    p.write_text(json.dumps(g))
    calls = []
    real = tl._load_gltf_image
    monkeypatch.setattr(tl, "_load_gltf_image",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    assert_meshes_equal(tl.load_meshes(str(p)), j_load_meshes(str(p)))
    assert len(calls) == 1
    tb = trt.SceneBuilder(texture_resolution=TEX_RES)
    jb = jrt.SceneBuilder(texture_resolution=TEX_RES)
    tl.load_model(str(p), tb, placement="origin")
    j_load_model(str(p), jb, placement="origin")
    assert len(tb.textures) == 1
    ts = tb.build(device="cpu")
    assert ts.num_tris == 4 and ts.num_textures == 1
    assert_scenes_equal(ts, jb.build())


def test_glb_matches_reference(tmp_path):
    path = write_glb(tmp_path / "quad.glb",
                     _png(_image(4, ch=4), filters=[1, 2, 3, 4] * 2))
    got, want = tl.load_meshes(path), j_load_meshes(path)
    assert_meshes_equal(got, want)
    np.testing.assert_array_equal(got[0].material["diffuse_image"],
                                  _image(4, ch=4)[..., :3])
    for placement in ("reference", "origin"):
        tb = trt.SceneBuilder(texture_resolution=TEX_RES)
        jb = jrt.SceneBuilder(texture_resolution=TEX_RES)
        tl.load_model(path, tb, placement=placement, scale=2.0)
        j_load_model(path, jb, placement=placement, scale=2.0)
        assert_scenes_equal(tb.build(device="cpu"), jb.build())


def test_models_match_reference(tmp_path):
    path = write_glb(tmp_path / "quad.glb", _png(_image(5)))
    for name in ("metal", 2):
        ts, tcam = t_models.scene(name, aspect=1.5, device="cpu")
        js, jcam = j_models.scene(name, aspect=1.5)
        assert_scenes_equal(ts, js)
        assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    ts, tcam = t_models.asset(path, aspect=1.25, device="cpu")
    js, jcam = j_models.asset(path, aspect=1.25)
    assert_scenes_equal(ts, js)
    np.testing.assert_allclose(tcam.origin, jcam.origin, rtol=1e-6)
    assert tcam.look_at == jcam.look_at and tcam.aspect == jcam.aspect
    assert t_models.BUILTIN_SCENES.keys() == j_models.BUILTIN_SCENES.keys()
    assert t_models.SCENE_IDS == j_models.SCENE_IDS


@pytest.mark.parametrize("ch", [3, 4])
def test_png_codec_matches_pillow(ch):
    """Every filter type, alone and mixed per row, both ways: the port's
    bytes decode in Pillow to the image, and Pillow's (and the port's own)
    bytes decode in the port to it."""
    img = _image(6, ch=ch, size=23)
    img[5:9] = img[4]                        # runs that filters compress
    for filters in (0, 1, 2, 3, 4, [0, 1, 2, 3, 4] * 4 + [4, 3, 2]):
        data = encode_png(img, filters)
        np.testing.assert_array_equal(np.asarray(Image.open(
            _io.BytesIO(data))), img)
        np.testing.assert_array_equal(decode_png(data), img)
    for optimize in (False, True):
        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG", optimize=optimize)
        np.testing.assert_array_equal(decode_png(buf.getvalue()), img)
    # not taken here: Pillow's grey and palette PNGs, a non-PNG
    for mode in ("L", "P"):
        buf = _io.BytesIO()
        Image.fromarray(img[..., 0]).convert(mode).save(buf, format="PNG")
        with pytest.raises(ValueError):
            decode_png(buf.getvalue())
    with pytest.raises(ValueError):
        decode_png(b"GIF89a" + bytes(20))


def test_write_png_decodes_to_the_image(tmp_path):
    img = np.random.default_rng(7).random((9, 13, 3)).astype(np.float32)
    t_image.write_png(str(tmp_path / "a.png"), torch.from_numpy(img))
    want = t_image.to_uint8(img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  want)
    np.testing.assert_array_equal(decode_png((tmp_path / "a.png")
                                             .read_bytes()), want)


def test_morton_order_matches_numpy():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(5000, 3)).astype(np.float32) * 7
    got = native.morton_order(c)
    # the scene builder's numpy Morton order (RTT_TRI_ORDER=morton)
    from ray_tracer_tpu_torch.scene import _morton_order
    np.testing.assert_array_equal(got, _morton_order(c))


def test_missing_library_falls_back_to_python(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert not native.available()
    assert native.morton_order(np.zeros((4, 3), np.float32)) is None
    assert native.parse_obj(str(tmp_path / "none.obj")) is None
    p = tmp_path / "q.obj"
    p.write_text(OBJS["quads"])
    assert_meshes_equal(tl.load_meshes(str(p)), j_load_meshes(str(p)))


def test_native_library_is_built_into_the_repo():
    from ray_tracer_tpu_torch.utils import build
    path = build.host_library_path(native.SOURCE)
    assert path.parent == build.BUILD_DIR
    assert native.available() and path.exists()


@needs_assets
@pytest.mark.parametrize("fname", ["triangle.obj", "simple_cube.obj",
                                   "cube2.obj", "poly_sphere.obj", "cube.obj",
                                   "the_utah_teapot.glb",
                                   "simple_japanese_tree.glb"])
def test_upstream_assets_match_reference(fname):
    path = os.path.join(ASSETS, fname)
    assert_meshes_equal(tl.load_meshes(path), j_load_meshes(path))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_loaded_mesh_renders_through_the_kernels(tmp_path, cuda_device):
    """A textured GLB loaded on the card renders through the closest-hit
    kernel's textured variant and equals the plain path's frame."""
    from ray_tracer_tpu_torch.ops import closest_hit as tch
    from ray_tracer_tpu_torch.renderer import render_frame
    path = write_glb(tmp_path / "quad.glb", _png(_image(8)))
    scene, cam = t_models.asset(path, device=cuda_device)
    basis = trt.camera_basis(cam)
    params = trt.RenderParams(width=64, height=64, bounces=2, skybox=True)
    before = tch.nearest_hit_attrs.tex_launches
    got = render_frame(scene, basis, params, 0)
    assert tch.nearest_hit_attrs.tex_launches == before + params.bounces + 1
    want = render_frame(scene, basis, params.replace(backend="torch"), 0)
    assert float((got - want).abs().max()) < 1e-5
