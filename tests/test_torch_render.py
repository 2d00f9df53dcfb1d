"""Port parity: whole frames against the reference's jnp render path.

The gate is the reference's own image gate (bench.py section_parity): the
fraction of pixels whose largest channel differs by more than 2e-2 must
stay below 2e-3. Sample streams are bit-identical in both packages; the
last-bit differences of fused multiply-adds and transcendentals can flip
a rare scatter decision, after which that pixel's bounce chain diverges.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import renderer as jr
from ray_tracer_tpu.renderer import _blocked_order as j_blocked_order
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu.renderer import render_progressive as j_render_progressive
from ray_tracer_tpu_torch import renderer as tr

from test_torch_common import frac_off, one_thread, scene_pair  # noqa: F401

# coherent_tile=0 exercises the fixed 512-ray share tile
PARAMS = dict(width=64, height=64, bounces=3, skybox=True,
              coherent_scatter=True, coherent_tile=0)
GATE = 2e-3


@pytest.mark.parametrize("name", ["room", "metal", "balls", "terrain"])
def test_render_frame_matches_jax(name):
    js, ts, cam = scene_pair(name)
    want = np.asarray(j_render_frame(
        js, jrt.camera_basis(cam), jrt.RenderParams(backend="jnp", **PARAMS),
        jnp.int32(2)))
    got = tr.render_frame(ts, trt.camera_basis(trt.Camera(**vars(cam))),
                          trt.RenderParams(backend="torch", **PARAMS), 2)
    assert got.shape == (64, 64, 3) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert frac_off(got, want) < GATE


def test_render_progressive_matches_jax():
    js, ts, cam = scene_pair("room")
    p = dict(PARAMS, width=32, height=32)
    basis = jrt.camera_basis(cam)
    want = np.asarray(j_render_progressive(
        js, basis, jrt.RenderParams(backend="jnp", **p), 3))
    tb = trt.camera_basis(trt.Camera(**vars(cam)))
    got = tr.render_progressive(ts, tb, trt.RenderParams(**p), 3)
    assert frac_off(got.numpy(), want) < GATE
    # the same frames one by one through render_frame + accumulate
    params = trt.RenderParams(**p)
    img = tr.render_frame(ts, tb, params, 0)
    for f in (1, 2):
        img = tr.accumulate(img, tr.render_frame(ts, tb, params, f), f)
    assert torch.equal(img, got)


# the reference tests' shapes for chunk / resilient (tests/test_retry.py)
SAFE_POINT_PARAMS = dict(width=32, height=32, bounces=1, skybox=True)


def _metal_safe_points():
    js, ts, cam = scene_pair("metal")
    return (js, jrt.camera_basis(cam), ts,
            trt.camera_basis(trt.Camera(**vars(cam))))


@pytest.mark.usefixtures("one_thread")
def test_render_progressive_chunks_and_safe_points():
    """``chunk`` and ``resilient`` (a host copy of the image after each
    chunk) never change the values: bit-equal to the default call, and
    at the image gate of the reference's chunked call."""
    js, jb, ts, tb = _metal_safe_points()
    params = trt.RenderParams(**SAFE_POINT_PARAMS)
    want = tr.render_progressive(ts, tb, params, 4)
    for kw in (dict(chunk=2), dict(resilient=True),
               dict(chunk=3, resilient=True)):
        assert torch.equal(tr.render_progressive(ts, tb, params, 4, **kw),
                           want), kw
    ref = np.asarray(j_render_progressive(
        js, jb, jrt.RenderParams(backend="jnp", **SAFE_POINT_PARAMS), 4,
        chunk=2))
    assert frac_off(want.numpy(), ref) < GATE
    with pytest.raises(ValueError, match="chunk"):
        tr.render_progressive(ts, tb, params, 4, chunk=0)


@pytest.mark.usefixtures("one_thread")
def test_render_adaptive_safe_points():
    """``render_adaptive(..., resilient=True)`` (both moments copied to the
    host after each chunk) is bit-equal to the call without, uses every
    frame at target 0, and its mean is at the image gate of the
    reference's."""
    js, jb, ts, tb = _metal_safe_points()
    params = trt.RenderParams(**SAFE_POINT_PARAMS)
    img, used = tr.render_adaptive(ts, tb, params, 4, 0.0, chunk=2,
                                   resilient=True)
    want, used_plain = tr.render_adaptive(ts, tb, params, 4, 0.0, chunk=2)
    assert used == used_plain == 4
    assert torch.equal(img, want)
    ref, used_j = jr.render_adaptive(
        js, jb, jrt.RenderParams(backend="jnp", **SAFE_POINT_PARAMS), 4, 0.0,
        chunk=2)
    assert used_j == 4
    assert frac_off(img.numpy(), np.asarray(ref)) < GATE


def test_render_and_renderer_match_progressive():
    scene, cam = trt.builtin_scene("metal", device="cpu")
    params = trt.RenderParams(width=16, height=16, bounces=1, skybox=True)
    img = trt.render(scene, cam, params, frames=3)
    want = tr.render_progressive(scene, trt.camera_basis(cam), params, 3)
    assert torch.equal(img, want)
    r = trt.Renderer(scene, cam, params.replace(accumulate=False))
    first = r.step().clone()
    assert r.frames == -1 and torch.equal(r.step(), first)


def test_chunked_frame_equals_whole_frame():
    """chunk_pixels traces the frame in pieces without changing it (chunks
    that are whole share tiles keep the coherent draws)."""
    scene, cam = trt.builtin_scene("room", device="cpu")
    basis = trt.camera_basis(cam)
    params = trt.RenderParams(**PARAMS)
    whole = tr.render_frame(scene, basis, params, 0)
    chunked = tr.render_frame(scene, basis, params.replace(chunk_pixels=1024),
                              0)
    assert torch.equal(whole, chunked)


def test_blocked_order_matches_reference():
    for W, H in ((64, 64), (40, 24), (1920, 1080)):
        order, inverse = tr._blocked_order(W, H)
        j_order, j_inverse = j_blocked_order(W, H)
        np.testing.assert_array_equal(order, j_order)
        np.testing.assert_array_equal(inverse, j_inverse)
    # non-multiple-of-block sizes unblock through the gather
    scene, cam = trt.builtin_scene("metal", aspect=40 / 24,
                                  device="cpu")
    img = tr.render_frame(scene, trt.camera_basis(cam),
                          trt.RenderParams(**dict(PARAMS, width=40,
                                                  height=24)), 0)
    assert img.shape == (24, 40, 3) and torch.isfinite(img).all()
