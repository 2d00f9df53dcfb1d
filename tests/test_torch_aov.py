"""Port parity of primary-ray AOVs (``render_aov``), on the CPU and, marked
``cuda``, on the card: depth, normal, albedo and coverage through pixel
centres, against the reference's jnp path on the same numpy inputs, and
the depth AOV's gradient against ``jax.grad``. The kernels' path (the
blocked 16x8 pixel order, the closest-hit kernel, the winner rows'
scatter-add backward) runs here with its CPU stand-ins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import renderer as jr
from ray_tracer_tpu_torch import renderer as tr

from test_torch_common import scene_pair

AOV_RTOL, AOV_ATOL = 3e-4, 1e-5
MAX_GRAZING = 2   # primary rays along a seam, as ROADMAP.md's id gate
TIE_SHARE = 0.02  # pixels whose ray meets two primitives at one depth


def _bases(cam):
    return jrt.camera_basis(cam), trt.camera_basis(trt.Camera(**vars(cam)))


def _aovs(name, size=(32, 32)):
    """Every AOV of scene ``name`` through both packages → {aov: (port
    (H, W, C) tensor, reference (H, W, C) array)}."""
    js, ts, cam = scene_pair(name, aspect=size[0] / size[1])
    jb, tb = _bases(cam)
    p = dict(width=size[0], height=size[1])
    return {aov: (tr.render_aov(ts, tb, trt.RenderParams(**p), aov),
                  np.asarray(jr.render_aov(
                      js, jb, jrt.RenderParams(backend="jnp", **p), aov)))
            for aov in tr.AOVS}


def _assert_aovs_close(out, aovs=tr.AOVS):
    """The AOV gate. The reference's pixel-centre rays come out of a jitted
    program whose fused multiply-adds move most directions by an ulp, so
    two rays that meet a seam between primitives can pick different
    winners (the reference's own jnp and Pallas backends differ on room's
    seams too). Coverage is equal but for at most MAX_GRAZING pixels (a
    ray along a seam, ROADMAP.md's id gate); depth is within rtol 3e-4 /
    atol 1e-5 on every other pixel; normal and albedo are too, but for
    t-ties: pixels where both hit at that same depth and a different
    primitive won, at most TIE_SHARE of the pixels."""
    got_hit, want_hit = out["hit"]
    same = got_hit.numpy()[..., 0] == want_hit[..., 0]
    assert int((~same).sum()) <= MAX_GRAZING
    got, want = out["depth"]
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=AOV_RTOL,
                               atol=AOV_ATOL)
    for aov in aovs:
        got, want = out[aov]
        assert got.shape == want.shape and got.dtype == torch.float32
        close = np.isclose(got.numpy(), want, rtol=AOV_RTOL,
                           atol=AOV_ATOL).all(-1)
        ties = same & ~close
        assert ties.sum() <= TIE_SHARE * same.size, (aov, int(ties.sum()))


@pytest.mark.parametrize("aov", tr.AOVS)
@pytest.mark.parametrize("name", ["metal", "room", "terrain"])
def test_render_aov_matches_reference(name, aov):
    out = _aovs(name)
    _assert_aovs_close(out, (aov,))
    assert bool(out["hit"][0].any()) and not bool(out["hit"][0].all()) \
        or name == "room"


def test_render_aov_textured_albedo_matches_reference():
    """The albedo AOV of a textured terrain goes through the texture
    fetch (the base-colour map times the mesh's tint)."""
    out = _aovs("terrain_tex")
    _assert_aovs_close(out, ("albedo",))
    assert not torch.equal(out["albedo"][0], _aovs("terrain")["albedo"][0])


def test_render_aov_rejects_an_unknown_name():
    scene, cam = trt.builtin_scene("metal", device="cpu")
    with pytest.raises(ValueError, match="beauty"):
        tr.render_aov(scene, trt.camera_basis(cam),
                      trt.RenderParams(width=8, height=8), "beauty")


@pytest.mark.parametrize("name", ["metal", "terrain"])
def test_render_aov_depth_gradient_matches_jax(name):
    """d(sum of the depth AOV) / d(sphere_center, tri_v0) against
    jax.grad of the reference's (metal has no triangles; room's pixel
    centres meet its seams, where a t-tie moves a pixel's gradient to
    another triangle)."""
    js, ts, cam = scene_pair(name)
    jb, tb = _bases(cam)
    p = dict(width=16, height=16)
    fields = ("sphere_center", "tri_v0") if ts.num_tris else (
        "sphere_center",)

    def loss(leaves):
        return jnp.sum(jr.render_aov(dataclasses.replace(js, **leaves), jb,
                                     jrt.RenderParams(backend="jnp", **p),
                                     "depth"))

    gj = jax.grad(loss)({k: getattr(js, k) for k in fields})
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    depth = tr.render_aov(dataclasses.replace(ts, **leaves), tb,
                          trt.RenderParams(**p), "depth")
    gt = torch.autograd.grad(depth.sum(), list(leaves.values()))
    for k, g in zip(fields, gt):
        want = np.asarray(gj[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("size", [(32, 16), (24, 20)])
def test_render_aov_on_the_kernels_path(size, monkeypatch):
    """The kernels' path with its CPU stand-ins: the blocked 16x8 pixel
    order, unblocked by the reshape (32x16) or by the inverse gather
    (24x20, which does not divide into blocks), equal to the plain path;
    the depth gradient through the winner rows' scatter-add backward."""
    from test_torch_grad import kernel_path_on_cpu
    _, ts, cam = scene_pair("terrain", aspect=size[0] / size[1])
    tb = trt.camera_basis(trt.Camera(**vars(cam)))
    p = trt.RenderParams(width=size[0], height=size[1])
    leaves = {"tri_v0": ts.tri_v0.clone().requires_grad_(True)}
    plain = {aov: tr.render_aov(dataclasses.replace(ts, **leaves), tb, p,
                                aov) for aov in tr.AOVS}
    g_plain, = torch.autograd.grad(plain["depth"].sum(), leaves["tri_v0"])
    calls = kernel_path_on_cpu(monkeypatch)
    for aov in tr.AOVS:
        got = tr.render_aov(dataclasses.replace(ts, **leaves), tb, p, aov)
        assert torch.equal(got, plain[aov]), aov
        if aov == "depth":
            g, = torch.autograd.grad(got.sum(), leaves["tri_v0"])
            torch.testing.assert_close(g, g_plain, rtol=1e-5, atol=1e-6)
    assert len(calls) == len(tr.AOVS)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(256, 144), (250, 142)])
def test_render_aov_kernels_match_plain_on_cuda(size, cuda_device):
    """On the card: every AOV through the closest-hit kernel against the
    plain path on the same tensors, at a size that divides into 16x8
    blocks and one that does not: depth and normal within rtol 3e-4 /
    atol 1e-5 on hit pixels, hit exact."""
    _, ts, cam = scene_pair("terrain", aspect=size[0] / size[1])
    ts = ts.to(cuda_device)
    tb = trt.camera_basis(trt.Camera(**vars(cam)))
    p = trt.RenderParams(width=size[0], height=size[1])
    out = {b: {aov: tr.render_aov(ts, tb, p.replace(backend=b), aov).cpu()
               for aov in tr.AOVS} for b in ("cuda", "torch")}
    assert torch.equal(out["cuda"]["hit"], out["torch"]["hit"])
    hit = out["torch"]["hit"][..., 0] > 0
    assert bool(hit.any())
    for aov in ("depth", "normal", "albedo"):
        torch.testing.assert_close(out["cuda"][aov][hit],
                                   out["torch"][aov][hit], rtol=AOV_RTOL,
                                   atol=AOV_ATOL)
