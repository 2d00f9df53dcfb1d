"""Port parity: textures (``texture.py``), the textured builder, the
48-column triangle planes and 40-column winner rows of the closest-hit
kernels' textured variants, textured shading, renders and gradients.

Every case feeds the same seeded numpy inputs to both packages. Tolerances:
the fetch's values to rtol / atol 1e-6 and its gradients to 1e-5 (XLA's
CPU compiler contracts a*b + c into fused multiply-adds, the port rounds
each product); winner rows bit-equal on hit lanes (both sides copy the
same stored values); the recomputed hit at the reference's own
``test_fused_attrs_textured`` tolerance (rtol 5e-4, atol 2e-5); images
under the reference's gate (2e-3 of pixels off by more than 2e-2); scene
gradients within 3e-4 x each leaf's max |g| (``test_torch_grad``). The
reference's resize is Pillow's, the port's torch's: equal at equal size,
within 1/255 when downsampling.

The reference gates its texture fetch to live ray tiles from 2,048 rays
(``sample_bilinear_gated``) and gives white on dead tiles, whose values
are unused: attributes are compared on hit lanes only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import texture as jtex
from ray_tracer_tpu.ops import intersect as jint
from ray_tracer_tpu.ops import pallas_intersect as jpk
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu_torch import texture as ttex
from ray_tracer_tpu_torch.ops import anyhit as tah
from ray_tracer_tpu_torch.ops import blocked_hit as tbh
from ray_tracer_tpu_torch.ops import closest_hit as tch
from ray_tracer_tpu_torch.ops import intersect as tint
from ray_tracer_tpu_torch.renderer import render_frame as t_render_frame

from test_fused import _textured_scene
from test_torch_common import (frac_off, probe_rays, scene_pair, t_,
                               terrain, texture_images, to_port)
from test_torch_grad import (PARAMS as GRAD_PARAMS, assert_grads_close,
                             jax_grads, kernel_path_on_cpu, torch_grads)
from test_torch_scene import _assert_same_scene

ATTR_RTOL, ATTR_ATOL = 5e-4, 2e-5
GATE = 2e-3


def _fetch_inputs(K, R, N=512, seed=0):
    rng = np.random.default_rng(seed + R)
    stack = rng.random((K, R, R, 3)).astype(np.float32)
    tex_id = rng.integers(-1, K, N).astype(np.int32)
    uv = (rng.random((N, 2)) * 4.0 - 1.5).astype(np.float32)  # [-1.5, 2.5)
    w = rng.normal(size=(N, 3)).astype(np.float32)
    return stack, tex_id, uv, w


@pytest.mark.parametrize("R", [8, 16])
def test_sample_bilinear_matches_jax(R):
    """Values of the fetch, and its gradients in the stack and the UVs
    against jax.grad, on UVs outside [0, 1) and ids with -1."""
    stack, tex_id, uv, w = _fetch_inputs(3, R)
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(stack),
                                           jnp.asarray(tex_id),
                                           jnp.asarray(uv)))
    got = ttex.sample_bilinear(t_(stack), t_(tex_id), t_(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[tex_id < 0] == 1.0).all() and (tex_id < 0).sum() > 50

    g_stack, g_uv = jax.grad(
        lambda s, u: jnp.sum(jtex.sample_bilinear(s, jnp.asarray(tex_id), u)
                             * w), argnums=(0, 1))(jnp.asarray(stack),
                                                   jnp.asarray(uv))
    s_t, uv_t = t_(stack).requires_grad_(True), t_(uv).requires_grad_(True)
    (ttex.sample_bilinear(s_t, t_(tex_id), uv_t) * t_(w)).sum().backward()
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(g_stack),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(uv_t.grad.numpy(), np.asarray(g_uv),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(uv_t.grad.numpy()).max() > 0


def test_srgb_and_normal_decode_are_exact():
    x = np.random.default_rng(1).random((64, 3)).astype(np.float32)
    x[:4] = [0.0, 0.04045, 1.0]
    np.testing.assert_array_equal(ttex.srgb_to_linear(x),
                                  jtex.srgb_to_linear(x))
    np.testing.assert_array_equal(
        ttex.decode_normal_map(t_(x)).numpy(),
        np.asarray(jtex.decode_normal_map(jnp.asarray(x))))


@pytest.mark.parametrize("shape,res", [
    ((16, 16, 3), 16), ((16, 16), 16), ((16, 16, 4), 16),
    ((37, 53, 3), 16), ((40, 24, 4), 16), ((7, 5, 3), 16)],
    ids=["equal", "gray", "rgba", "down", "down-rgba", "up"])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_prepare_texture_matches_pillow(shape, res, kind):
    """The port's torch resize against the reference's Pillow resize:
    exact at equal size and when upsampling, within 1/255 before
    linearization when downsampling; floats clipped and truncated alike."""
    rng = np.random.default_rng(sum(shape) + res)
    img = (rng.integers(0, 256, shape).astype(np.uint8) if kind == "uint8"
           else (rng.random(shape) * 1.2 - 0.1).astype(np.float32))
    got = ttex.prepare_texture(img, res, srgb=False)
    want = jtex.prepare_texture(img, res, srgb=False)
    assert got.shape == want.shape == (res, res, 3)
    assert got.dtype == np.float32
    if shape[0] <= res and shape[1] <= res:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1 / 255 + 1e-6
    if shape[:2] == (res, res):
        np.testing.assert_array_equal(
            ttex.prepare_texture(img, res, srgb=True),
            jtex.prepare_texture(img, res, srgb=True))


def test_textured_builder_matches_reference():
    """SceneBuilder with textures: every field equal to the reference
    builder's, ``textures`` (K, R, R, 3), ``num_textures`` and the
    per-triangle ids and tangent frames included."""
    js, _ = terrain(jrt, textured=True)
    ts, _ = terrain(trt, textured=True)
    assert ts.num_textures == 2 and tuple(ts.textures.shape) == (2, 16, 16, 3)
    assert ts.num_normal_maps == ts.num_tris
    _assert_same_scene(js, ts)
    b = trt.SceneBuilder()
    assert b.texture_resolution == 512
    assert b.add_texture(np.zeros((4, 4, 3), np.uint8)) == 0
    assert b.add_texture(np.ones((4, 4), np.float32)) == 1


def test_textured_scene_carries_across():
    """scene_from_numpy keeps a reference textured scene's stack, ids
    and counts."""
    js = _textured_scene()
    ts = to_port(js)
    _assert_same_scene(js, ts)
    assert ts.num_textures == 2 and ts.num_normal_maps == 1


def test_textured_planes_and_copy_maps_match_reference():
    js, ts, _ = scene_pair("terrain_tex")
    tri_p = tch._pack_tris(ts, textured=True).numpy()
    tri_j = np.asarray(jpk._pack_tris(js, textured=True))
    assert tri_p.shape == tri_j.shape == (ts.padded_tris, 48)
    geo = np.r_[0:9, 12:48]            # all but the geometric normal
    np.testing.assert_array_equal(tri_p[:, geo], tri_j[:, geo])
    np.testing.assert_allclose(tri_p[:, 9:12], tri_j[:, 9:12], rtol=1e-5,
                               atol=1e-7)
    assert tch._attr_copy_maps(True) == jpk._attr_copy_maps(True)
    cmap = tch._copy_map_tensor(torch.device("cpu"), True)
    assert cmap.shape == (2, 40) and cmap.dtype == torch.int32
    planes = tch.ScenePlanes(ts)
    assert planes.tri.shape == (ts.padded_tris, 48)
    assert torch.equal(planes.geo, planes.tri[:, :12])
    # the copy map carries each plane column into its merged-table column
    table = tint._pack_attrs(ts)[ts.padded_spheres:]
    assert torch.equal(planes.tri[:, cmap[1].long()], table)


def _fused_rays(side=16):
    """side^2 rays from the origin through a grid on the plane z = 2 over
    the reference's textured scene (tests/test_fused.py): the textured
    triangle there, the half-textured one behind it and the sphere."""
    x = np.linspace(-1.1, 1.1, side)
    gx, gy = np.meshgrid(x, x, indexing="ij")
    d = np.stack([gx.ravel(), gy.ravel(), np.full(side * side, 2.0)],
                 -1).astype(np.float32)
    return np.zeros_like(d), d


def _textured_mesh(n_tris=2200, seed=21):
    """A 2,200-triangle textured mesh (three blocks of 1024): random
    triangles with random UVs, an albedo map on all and a normal map on
    every other one, and two spheres, in both packages."""
    rng = np.random.default_rng(seed)
    b = jrt.SceneBuilder(texture_resolution=8)
    ti = b.add_texture(rng.random((8, 8, 3)).astype(np.float32), srgb=False)
    ni = b.add_texture(rng.random((8, 8, 3)).astype(np.float32), srgb=False)
    for k in range(n_tris):
        v = rng.normal(size=3) * 3.0 + rng.normal(size=(3, 3))
        n = np.cross(v[1] - v[0], v[2] - v[0])
        n /= max(np.linalg.norm(n), 1e-9)
        b.add_mesh([tuple(x) for x in v], [tuple(n)] * 3, [0, 1, 2],
                   albedo=tuple(rng.random(3)), smoothness=0.2,
                   uvs=rng.random((3, 2)) * 3 - 1, tex=ti,
                   normal_tex=ni if k % 2 else -1)
    for _ in range(2):
        b.add_sphere(tuple(rng.normal(size=3) * 3.0), 0.7, (0.9, 0.2, 0.1))
    js = b.build(pad=128)
    return js, to_port(js)


def _assert_rows_match(got, want):
    """(t, id, rows) of a plain version against the reference's kernel:
    hit masks and ids equal, t within rtol 1e-4 (test_torch_intersect)
    or 1e-7,
    the 40-column rows bit-equal on hit lanes, zero rows on misses."""
    hit = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    assert hit.sum() > 30
    np.testing.assert_array_equal(got[1][hit], want[1][hit])
    # atol: rays starting inside the mesh hit at t ~ 1e-3, where the last
    # bit a fused multiply-add moves is a large part of t
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-4,
                               atol=1e-7)
    assert got[2].shape == want[2].shape == (40, len(hit))
    np.testing.assert_array_equal(got[2][:, hit], want[2][:, hit])
    assert not got[2][:, ~hit].any()
    return hit


def test_plain_closest_hit_textured_rows_match_pallas():
    """B1-tex's plain version: the 40-column rows of the reference's
    textured scene (tests/test_fused.py) against its Pallas kernel in
    interpret mode, textured triangles, an untextured one and a sphere."""
    js = _textured_scene()
    ts = to_port(js)
    o, d = _fused_rays()
    want = [np.asarray(x) for x in jpk.nearest_hit_attrs_pallas(
        js, jnp.asarray(o), jnp.asarray(d), 1e-4)]
    got = [x.numpy() for x in tch.nearest_hit_attrs_reference(
        ts, t_(o), t_(d), 1e-4)]
    hit = _assert_rows_match(got, want)
    ids = got[1][hit] - ts.padded_spheres
    assert (ids < 0).any() and (ids >= 0).any()
    # a sphere winner's textured columns are zero: tex id 0, not -1
    assert not got[2][26:, hit][:, ids < 0].any()
    assert set(got[2][38, hit][ids >= 0]) == {0.0}


def test_plain_blocked_textured_rows_match_pallas_streaming():
    """B4-tex's plain version at blocks of 1024 against the reference's
    streaming kernel in interpret mode on a 2,200-triangle textured mesh,
    and bit-equal to B1-tex's plain version."""
    from test_torch_blocked import STREAMING_CFG, SMALL_BLOCK, _random_rays
    js, ts = _textured_mesh()
    o, d = _random_rays(256, seed=15, spread=1.0)
    want = [np.asarray(x) for x in jpk.nearest_hit_attrs_pallas(
        js, jnp.asarray(o), jnp.asarray(d), 1e-4, cfg=STREAMING_CFG)]
    got = tbh.nearest_hit_blocked_reference(ts, t_(o), t_(d), 1e-4,
                                            block=SMALL_BLOCK)
    hit = _assert_rows_match([x.numpy() for x in got], want)
    assert len(set(got[2][39].numpy()[hit])) == 2   # ntex 1 and -1
    for g, w in zip(got, tch.nearest_hit_attrs_reference(ts, t_(o), t_(d),
                                                         1e-4)):
        assert torch.equal(g, w)


def _hit_fields(hj, hp, hit):
    np.testing.assert_array_equal(hp.hit.numpy(), np.asarray(hj.hit))
    for field in ("t", "point", "normal", "albedo", "emission",
                  "emission_strength", "smoothness"):
        np.testing.assert_allclose(getattr(hp, field).detach().numpy()[hit],
                                   np.asarray(getattr(hj, field))[hit],
                                   rtol=ATTR_RTOL, atol=ATTR_ATOL,
                                   err_msg=field)


@pytest.mark.parametrize("name", ["fused", "terrain_tex"])
def test_textured_hit_attributes_match(name):
    """The textured recompute from the same rows in both packages, on the
    reference's textured scene and on the textured terrain: UV
    interpolation, albedo times the base-colour map, the normal-mapped
    normal."""
    if name == "fused":
        js = _textured_scene()
        ts = to_port(js)
        o, d = _fused_rays(20)
    else:
        js, ts, cam = scene_pair(name)
        o, d = probe_rays(cam, 768, seed=11)
    t_j, id_j = jint.nearest_hit_jnp(js, jnp.asarray(o), jnp.asarray(d), 1e-4)
    miss = np.isinf(np.asarray(t_j))
    rows = np.asarray(jint._pack_attrs(js))[np.asarray(id_j)].T
    assert rows.shape[0] == 40
    np.testing.assert_array_equal(tint._pack_attrs(ts).numpy(),
                                  np.asarray(jint._pack_attrs(js)))
    hj = jint.hit_attributes_from_rows(js, jnp.asarray(rows), jnp.asarray(o),
                                       jnp.asarray(d), id_j,
                                       jnp.asarray(miss), 1e-4)
    hp = tint.hit_attributes_from_rows(ts, t_(rows), t_(o), t_(d),
                                       t_(np.asarray(id_j)), t_(miss), 1e-4)
    hit = ~miss
    tri = hit & (np.asarray(id_j) >= ts.padded_spheres)
    assert tri.sum() > 50
    _hit_fields(hj, hp, hit)
    assert np.isfinite(hp.normal.numpy()).all()
    # the maps did something: textured albedo differs from the tint
    tint_albedo = rows[18:21].T
    assert np.abs(hp.albedo.numpy()[tri] - tint_albedo[tri]).max() > 0.05


def test_textured_render_frame_matches_jax():
    """A 64x64 frame of the textured terrain with its normal map, plain
    path and kernels' path (their CPU stand-ins), against the reference's
    jnp path."""
    js, ts, cam = scene_pair("terrain_tex")
    params = dict(width=64, height=64, bounces=3, skybox=True,
                  coherent_scatter=True, coherent_tile=0)
    want = np.asarray(j_render_frame(
        js, jrt.camera_basis(cam), jrt.RenderParams(backend="jnp", **params),
        jnp.int32(2)))
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    got = t_render_frame(ts, basis, trt.RenderParams(backend="torch",
                                                     **params), 2).numpy()
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert frac_off(got, want) < GATE
    untextured = t_render_frame(scene_pair("terrain")[1], basis,
                                trt.RenderParams(backend="torch", **params),
                                2).numpy()
    assert frac_off(got, untextured) > 0.1


def test_textured_nee_frame_matches_jax(monkeypatch):
    """NEE with MIS on the textured terrain with terrain_nee's lights:
    the plain path and the kernels' path (closest-hit and any-hit plain
    versions) against the reference."""
    js, ts, cam = scene_pair("terrain_nee_tex")
    params = dict(width=48, height=48, bounces=3, skybox=True,
                  coherent_scatter=True, coherent_tile=0, nee=True)
    want = np.asarray(j_render_frame(
        js, jrt.camera_basis(cam), jrt.RenderParams(backend="jnp", **params),
        jnp.int32(2)))
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    got = t_render_frame(ts, basis, trt.RenderParams(backend="torch",
                                                     **params), 2).numpy()
    assert frac_off(got, want) < GATE
    calls = kernel_path_on_cpu(monkeypatch)
    shadow = []
    real = tah.anyhit_reference
    monkeypatch.setattr(tah, "anyhit_reference",
                        lambda *a, **k: shadow.append(1) or real(*a, **k))
    fused = t_render_frame(ts, basis, trt.RenderParams(backend="cuda",
                                                       **params), 2).numpy()
    assert len(calls) == 4 and len(shadow) == 3
    assert frac_off(fused, want) < GATE


GRAD_FIELDS = ("textures", "tri_uv0", "tri_uv1", "tri_uv2", "tri_v0",
               "tri_v1", "tri_v2", "tri_albedo")


def test_textured_grads_match_jax(monkeypatch):
    """Whole-frame gradients of the textured terrain's texture stack, UVs,
    vertices and albedo against jax.grad, through the plain path and the
    kernels' path (the plain closest hit forward, the winner rows'
    scatter-add backward at width 40)."""
    js, ts, cam = scene_pair("terrain_tex")
    target = 0.5 * np.asarray(j_render_frame(
        js, jrt.camera_basis(cam),
        jrt.RenderParams(backend="jnp", **GRAD_PARAMS), jnp.int32(0)))
    lj, img_j, gj = jax_grads(js, cam, GRAD_FIELDS, target)
    lt, img_t, gt = torch_grads(ts, cam, GRAD_FIELDS, target)
    assert float(np.abs(img_t - img_j).max()) < 1e-4
    assert lt == pytest.approx(lj, rel=1e-5)
    assert all(np.isfinite(g).all() for g in gt.values())
    assert assert_grads_close(gt, gj) == len(GRAD_FIELDS)

    calls = kernel_path_on_cpu(monkeypatch)
    lf, img_f, gf = torch_grads(ts, cam, GRAD_FIELDS, target,
                                backend="cuda")
    assert len(calls) == GRAD_PARAMS["bounces"] + 1
    assert np.array_equal(img_f, img_t) and lf == lt
    assert assert_grads_close(gf, gj) == len(GRAD_FIELDS)


def test_texture_recovery_step_lowers_the_loss():
    """The training entry point over the texture stack and the albedos
    (the chip run's texture-recovery step at 16x16): gradients finite,
    the texture's nonzero, the loss falls."""
    _, ts, cam = scene_pair("terrain_tex")
    params = trt.RenderParams(**GRAD_PARAMS)
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    target = t_render_frame(ts, basis, params, 0)
    start = dataclasses.replace(ts, textures=ts.textures * 0.8,
                                tri_albedo=ts.tri_albedo * 0.8)
    init_fn, step_fn = trt.grad.make_train_step(params)
    trainable, opt = init_fn(start, ("tri_albedo", "textures"))
    losses = []
    for _ in range(3):
        trainable, opt, loss = step_fn(trainable, opt, start, basis, target,
                                       0)
        losses.append(float(loss))
    g = trainable["textures"].grad
    assert bool(torch.isfinite(g).all()) and bool(g.any())
    assert losses[-1] < losses[0]


def test_cache_repacks_after_an_in_place_uv_update():
    """The textured planes are keyed on the UV, tangent and id tensors
    too: within a scope, an in-place update of tri_uv0 (an optimizer's
    step) packs anew."""
    _, ts, _ = scene_pair("terrain_tex")
    with tch.plane_scope():
        planes = tch.scene_planes(ts)
        assert planes.tri.shape[1] == 48
        before = tch.scene_planes.packs
        ts.tri_uv0.add_(0.25)
        again = tch.scene_planes(ts)
        assert again is not planes and tch.scene_planes.packs == before + 1
        assert torch.equal(again.tri[:, 32:34], ts.tri_uv0)
        assert torch.equal(again.tri, tch.ScenePlanes(ts).tri)
        assert tch.scene_planes(ts) is again


def test_textured_wrappers_on_cpu_take_the_plain_versions():
    _, ts, cam = scene_pair("terrain_tex")
    o, d = (t_(x) for x in probe_rays(cam, 64, seed=3))
    counts = (tch.nearest_hit_attrs.launches,
              tch.nearest_hit_attrs.tex_launches,
              tbh.nearest_hit_blocked.tex_launches)
    got = tch.nearest_hit_attrs(ts, o, d)
    assert got[2].shape == (40, 64)
    for g, w in zip(got, tch.nearest_hit_attrs_reference(ts, o, d)):
        assert torch.equal(g, w)
    for g, w in zip(tbh.nearest_hit_blocked(ts, o, d),
                    tbh.nearest_hit_blocked_reference(ts, o, d)):
        assert torch.equal(g, w)
    assert (tch.nearest_hit_attrs.launches,
            tch.nearest_hit_attrs.tex_launches,
            tbh.nearest_hit_blocked.tex_launches) == counts


def test_texture_images_are_seeded_uint8_maps():
    albedo, normal = texture_images(16)
    assert albedo.shape == normal.shape == (16, 16, 3)
    assert albedo.dtype == normal.dtype == np.uint8
    n = normal.astype(np.float32) / 255 * 2 - 1
    assert (n[..., 2] > 0.5).all()
    assert len(np.unique(albedo.reshape(-1, 3), axis=0)) > 8


def test_fetch_backward_is_one_row_major_scatter(monkeypatch):
    """The fetch's gather transposes through the scatter-add's row-major
    form (once per fetch, int32 ids, a (N, 12) cotangent), and gives the
    stack the gradient of autograd's own gather transpose."""
    from ray_tracer_tpu_torch.ops import scatter_rows as tsc
    stack, tex_id, uv, w = _fetch_inputs(3, 8, N=256, seed=4)
    tex_id[:64] = 0
    uv[:64] = 0.0                   # the sphere and miss lanes' one texel
    calls = []
    real = tsc.scatter_rows

    def spy(ids, g, n_rows):
        calls.append((ids.dtype, tuple(g.shape), n_rows))
        return real(ids, g, n_rows)

    monkeypatch.setattr(tsc, "scatter_rows", spy)
    s_t = t_(stack).requires_grad_(True)
    (ttex.sample_bilinear(s_t, t_(tex_id), t_(uv)) * t_(w)).sum().backward()
    assert calls == [(torch.int32, (256, 12), 3 * 8 * 8)]

    def plain(s):                   # the same fetch, autograd's transpose
        K, H, W, _ = s.shape
        quad = torch.cat([s, s.roll(-1, 2), s.roll(-1, 1),
                          s.roll(-1, 2).roll(-1, 1)], -1).reshape(-1, 12)
        u = t_(uv) - torch.floor(t_(uv))
        x, y = u[:, 0] * W - 0.5, u[:, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        idx = ((t_(tex_id).long().clamp(0, K - 1) * H
                + torch.remainder(y0.long(), H)) * W
               + torch.remainder(x0.long(), W))
        r = quad[idx]
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        out = ((r[:, 0:3] * (1 - fx) + r[:, 3:6] * fx) * (1 - fy)
               + (r[:, 6:9] * (1 - fx) + r[:, 9:12] * fx) * fy)
        return torch.where((t_(tex_id) >= 0)[:, None], out, 1.0)

    p_t = t_(stack).requires_grad_(True)
    (plain(p_t) * t_(w)).sum().backward()
    torch.testing.assert_close(s_t.grad, p_t.grad, rtol=1e-6, atol=1e-6)
