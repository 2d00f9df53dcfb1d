"""Port parity: next-event estimation, MIS and Russian roulette in whole
frames and in ``trace``, against the reference's jnp render path.

The image gate is the reference's own (bench.py section_parity): the
fraction of pixels whose largest channel differs by more than 2e-2 stays
below 2e-3. Each frame goes through the port twice: the plain path
(``backend="torch"``: the oracle's closest hit, and occlusion as the
closest hit against the segment's end) and the kernels' path with its CPU
stand-ins (``kernel_path_on_cpu``: the closest-hit and any-hit kernels'
plain versions), which ``backend="cuda"`` takes on the card. The RNG
states that ``trace`` returns are bit-exact: NEE draws a light sample on
every segment and the roulette a uniform, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu import sampling as j_sampling
from ray_tracer_tpu.renderer import render_frame as j_render_frame
from ray_tracer_tpu.renderer import trace as j_trace
from ray_tracer_tpu_torch import renderer as tr
from ray_tracer_tpu_torch.ops import anyhit as tah

from test_torch_common import frac_off, scene_pair, t_
from test_torch_grad import kernel_path_on_cpu

BASE = dict(width=48, height=48, bounces=3, coherent_scatter=True,
            coherent_tile=0)
CONFIGS = {
    "nee": dict(nee=True),
    "nee-nomis": dict(nee=True, mis=False),
    "nee-rr1": dict(nee=True, rr_start=1),
}
GATE = 2e-3


def _params(name, config, **kw):
    # the room scene renders without the sky, the reference's default
    return dict(BASE, skybox=name != "room", **CONFIGS[config], **kw)


def _frames(name, params, frame=2):
    js, ts, cam = scene_pair(name)
    want = np.asarray(j_render_frame(
        js, jrt.camera_basis(cam), jrt.RenderParams(backend="jnp", **params),
        jnp.int32(frame)))
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    got = tr.render_frame(ts, basis, trt.RenderParams(backend="torch",
                                                      **params), frame)
    return ts, basis, want, got.numpy()


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", ["room", "balls", "terrain_nee"])
def test_nee_frame_matches_jax(name, config, monkeypatch):
    params = _params(name, config)
    ts, basis, want, got = _frames(name, params)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert frac_off(got, want) < GATE

    calls = kernel_path_on_cpu(monkeypatch)
    shadow = []
    anyhit = tah.anyhit
    monkeypatch.setattr(tah, "anyhit",
                        lambda *a, **k: shadow.append(a) or anyhit(*a, **k))
    kern = tr.render_frame(ts, basis, trt.RenderParams(backend="cuda",
                                                       **params), 2).numpy()
    # one closest-hit query per segment, one shadow query per segment but
    # the last
    assert len(calls) == params["bounces"] + 1
    assert len(shadow) == params["bounces"]
    assert frac_off(kern, want) < GATE


def test_nee_changes_the_image_but_not_its_brightness():
    """NEE is on: the frame differs from the BSDF-only frame; over a few
    frames both estimate the same image (room, the reference's NEE scene)."""
    _, ts, cam = scene_pair("room")
    basis = trt.camera_basis(trt.Camera(**vars(cam)))
    p = trt.RenderParams(**dict(BASE, width=32, height=32, bounces=2))
    plain = tr.render_progressive(ts, basis, p, 8)
    nee = tr.render_progressive(ts, basis, p.replace(nee=True), 8)
    assert not torch.equal(plain, nee)
    assert float(nee.mean()) == pytest.approx(float(plain.mean()), rel=0.15)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_trace_state_and_radiance_match_reference(config):
    """trace's returned RNG state is bit-exact (every lane draws the light
    sample on every segment and the roulette uniform), so a second sample
    per pixel sees the same stream; the radiance agrees under the gate."""
    js, ts, cam = scene_pair("terrain_nee")
    # one 64x64 frame's camera rays, made once and handed to both
    pix = jnp.arange(64 * 64, dtype=jnp.uint32)
    state, o, d = jrt.camera_rays(jrt.camera_basis(cam), pix % 64, pix // 64,
                                  (64, 64), j_sampling.seed_state(pix, 7))
    params = dict(BASE, skybox=True, **CONFIGS[config])
    j_state, j_rad = j_trace(js, o, d, state,
                             jrt.RenderParams(backend="jnp", **params))
    t_state, t_rad = tr.trace(
        ts, t_(o), t_(d), torch.from_numpy(np.asarray(state, np.int64)),
        trt.RenderParams(backend="torch", **params))
    np.testing.assert_array_equal(t_state.numpy().astype(np.uint32),
                                  np.asarray(j_state))
    assert frac_off(t_rad.numpy(), np.asarray(j_rad)) < GATE


def test_two_samples_per_pixel_and_cutoff_match_jax():
    """rays_per_pixel=2 (the second sample continues the first's stream)
    with a smoothness cutoff that leaves glossy lanes to BSDF sampling."""
    params = _params("balls", "nee", rays_per_pixel=2,
                     nee_smoothness_cutoff=0.5)
    _, _, want, got = _frames("balls", params, frame=3)
    assert frac_off(got, want) < GATE
