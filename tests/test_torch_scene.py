"""Port parity: scenes and cameras built by both packages are identical."""

import dataclasses

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch.scene import STATIC_FIELDS, TENSOR_FIELDS

from test_torch_common import mesh80, terrain, to_port


def _assert_same_scene(jax_scene, port_scene):
    leaves = dataclasses.asdict(jax_scene)
    assert set(leaves) == set(TENSOR_FIELDS) | set(STATIC_FIELDS)
    for k in TENSOR_FIELDS:
        want = np.asarray(leaves[k])
        got = getattr(port_scene, k)
        assert isinstance(got, torch.Tensor), k
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in STATIC_FIELDS:
        assert getattr(port_scene, k) == leaves[k], k
    assert port_scene.padded_spheres == jax_scene.padded_spheres
    assert port_scene.padded_tris == jax_scene.padded_tris


@pytest.mark.parametrize("name", ["balls", "random_balls", "room", "metal"])
def test_builtin_scene_fields_equal(name):
    js, jc = jrt.builtin_scene(name, aspect=1.5)
    ts, tc = trt.builtin_scene(name, aspect=1.5, device="cpu")
    _assert_same_scene(js, ts)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


@pytest.mark.parametrize("build", [terrain, mesh80], ids=["terrain", "mesh80"])
def test_mesh_scene_fields_equal_including_triangle_order(build):
    """Median-split ordering gives the same triangle ids in both packages
    (terrain n=12: 242 triangles, 4 clusters)."""
    js, _ = build(jrt)
    ts, _ = build(trt)
    if build is terrain:
        assert ts.num_tris == 242 and ts.num_spheres == 3
    _assert_same_scene(js, ts)


def test_morton_order_matches(monkeypatch):
    """RTT_TRI_ORDER=morton selects the Morton order in both packages."""
    monkeypatch.setenv("RTT_TRI_ORDER", "morton")
    js, _ = terrain(jrt)
    ts, _ = terrain(trt)
    _assert_same_scene(js, ts)
    monkeypatch.delenv("RTT_TRI_ORDER")
    assert not torch.equal(terrain(trt)[0].tri_v0, ts.tri_v0)


def test_scene_from_numpy_round_trip():
    js, _ = jrt.builtin_scene("room")
    ts = to_port(js)
    _assert_same_scene(js, ts)
    moved = ts.to("cpu")
    assert moved.device.type == "cpu" and moved.num_tris == ts.num_tris
    back = trt.scene_from_numpy({
        **{k: getattr(ts, k).numpy() for k in TENSOR_FIELDS},
        **{k: getattr(ts, k) for k in STATIC_FIELDS}}, device="cpu")
    _assert_same_scene(js, back)


@pytest.mark.parametrize("name", ["balls", "random_balls", "room", "metal"])
def test_camera_basis_equal(name):
    _, jc = jrt.builtin_scene(name, aspect=16 / 9)
    _, tc = trt.builtin_scene(name, aspect=16 / 9, device="cpu")
    jb, tb = jrt.camera_basis(jc), trt.camera_basis(tc)
    for f in dataclasses.fields(jb):
        got = getattr(tb, f.name)
        assert got.dtype == torch.float32, f.name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jb, f.name)),
                                      err_msg=f.name)
