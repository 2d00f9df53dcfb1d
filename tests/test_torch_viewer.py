"""Port parity of ``viewer.py`` on the Agg (headless) backend: the
reference's test_viewer.py cases on the port, the panel following keys,
the figure-free core, and scene switches rendered on the kernels' path."""

import types

import numpy as np
import pytest
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch.viewer import Viewer, ViewerCore, view

from test_torch_common import frac_off, one_thread  # noqa: F401
from test_torch_grad import kernel_path_on_cpu

PARAMS = rt.RenderParams(width=16, height=16, bounces=1, skybox=True)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def agg():
    """matplotlib on its headless backend, for the tests of the figure
    (the core's tests need no matplotlib)."""
    pytest.importorskip("matplotlib").use("Agg", force=True)


def make_viewer(**kw):
    scene, cam = rt.builtin_scene("metal", aspect=1.0, device="cpu")
    return Viewer(scene, cam, PARAMS, scene_id=3, **kw)


def key(k):
    return types.SimpleNamespace(key=k)


def test_view_raises_headless(agg):
    scene, cam = rt.builtin_scene("metal", aspect=1.0, device="cpu")
    with pytest.raises(RuntimeError, match="headless"):
        view(scene, cam, PARAMS)


def test_bounces_and_rpp_keys(agg):
    v = make_viewer()
    v._on_key(key("B"))
    assert v.renderer.params.bounces == 2
    v._on_key(key("b"))
    v._on_key(key("b"))
    assert v.renderer.params.bounces == 0
    v._on_key(key("b"))
    assert v.renderer.params.bounces == 0  # clamped
    v._on_key(key("R"))
    assert v.renderer.params.rays_per_pixel == 2


def test_focus_and_aperture_keys(agg):
    v = make_viewer()
    f0 = v.renderer.camera.focus_dist
    v._on_key(key("F"))
    assert v.renderer.camera.focus_dist == pytest.approx(f0 + 0.25)
    assert v.renderer.frames == -1  # accumulation cleared
    v._on_key(key("V"))
    assert v.renderer.camera.aperture == pytest.approx(0.1)
    for _ in range(50):
        v._on_key(key("v"))
    assert v.renderer.camera.aperture == pytest.approx(-2.0)  # slider min
    for _ in range(60):
        v._on_key(key("f"))
    assert v.renderer.camera.focus_dist == 0.0  # slider min


def test_movement_key_clears_accumulation(agg):
    v = make_viewer()
    v.renderer.step()
    v.renderer.step()
    assert v.renderer.frames >= 1
    v._on_key(key("w"))
    assert v.renderer.frames == -1


def test_toggles_and_scroll(agg):
    v = make_viewer()
    assert v.renderer.params.skybox
    v._on_key(key("k"))
    assert not v.renderer.params.skybox
    v._on_key(key("c"))
    assert not v.renderer.params.accumulate
    o0 = np.asarray(v.renderer.camera.origin)
    v._on_scroll(types.SimpleNamespace(step=1.0))
    assert not np.allclose(np.asarray(v.renderer.camera.origin), o0)


def test_status_line_has_camera_readout(agg):
    v = make_viewer()
    s = v.status_line(0.016)
    cam = v.renderer.camera
    assert f"{cam.origin[0]:.2f}" in s and "look (" in s
    assert "focus" in s and "aperture" in s


def test_resize(agg):
    v = make_viewer()
    v.resize(24, 12)
    assert v.renderer.params.width == 24
    assert v.renderer.camera.aspect == pytest.approx(2.0)
    assert v.renderer.step().shape == (12, 24, 3)


def test_drag_looks_around(agg):
    v = make_viewer()
    look0 = v.renderer.camera.look_at
    v._on_motion(types.SimpleNamespace(x=10.0, y=10.0))   # no button held
    assert v.renderer.camera.look_at == look0
    v.press(0.0, 0.0)
    v._on_motion(types.SimpleNamespace(x=30.0, y=-10.0))
    assert v.renderer.camera.look_at != look0
    assert v.renderer.camera.origin == pytest.approx(
        make_viewer().renderer.camera.origin)


def test_denoise_toggle(agg):
    """'n' toggles display-path denoising without touching accumulation."""
    v = make_viewer()
    assert v.denoise == 0
    v._on_key(key("n"))
    assert v.denoise == 3
    frames_before = v.renderer.frames
    v.run(max_frames=1)   # one filtered frame draws fine
    assert v.renderer.frames == frames_before + 1
    assert v.clock.count == 1
    v._on_key(key("n"))
    assert v.denoise == 0


def test_widget_panel_drives_state(agg):
    """The panel drives the same state transitions as the keys, invoked
    the way matplotlib invokes the widgets' callbacks."""
    v = make_viewer()
    w = v._widgets
    assert set(w) == {"bounces", "rpp", "focus", "aperture", "checks",
                      "scene"}
    w["bounces"].set_val(4)
    assert v.renderer.params.bounces == 4
    w["rpp"].set_val(3)
    assert v.renderer.params.rays_per_pixel == 3
    v.renderer.step()
    v.renderer.step()
    w["focus"].set_val(2.5)
    assert v.renderer.camera.focus_dist == pytest.approx(2.5)
    assert v.renderer.frames == -1  # accumulation cleared, like the keys
    w["aperture"].set_val(0.7)
    assert v.renderer.camera.aperture == pytest.approx(0.7)
    assert v.renderer.params.skybox
    w["checks"].set_active(0)          # fires on_clicked("skybox")
    assert not v.renderer.params.skybox
    w["checks"].set_active(1)
    assert not v.renderer.params.accumulate
    w["checks"].set_active(2)
    assert v.denoise == 3
    w["scene"].set_active(2)           # "room"
    assert v.scene_id == 2
    assert v.renderer.scene.num_tris >= 14  # room walls + light
    assert make_viewer(widgets=False)._widgets == {}


def test_widgets_follow_keys(agg):
    """Keys move the panel with them (the reference's panel goes stale),
    without the widgets' callbacks firing back."""
    v = make_viewer()
    w = v._widgets
    for k in ("B", "B", "R", "F", "V", "k", "n", "2"):
        v._on_key(key(k))
    p, cam = v.renderer.params, v.renderer.camera
    assert w["bounces"].val == p.bounces == 3
    assert w["rpp"].val == p.rays_per_pixel == 2
    assert w["focus"].val == pytest.approx(cam.focus_dist)
    assert w["aperture"].val == pytest.approx(cam.aperture)
    assert w["checks"].get_status() == [p.skybox, p.accumulate, True]
    assert not p.skybox
    assert w["scene"].value_selected == "room" and v.scene_id == 2
    assert v.denoise == 3


def test_scene_switch_keys_render_on_the_kernels_path(monkeypatch):
    """Each scene key builds the scene anew on the viewer's device; a
    frame after each switch through the kernels' path (their plain
    versions on the CPU) equals the plain path's."""
    v = ViewerCore(*rt.builtin_scene("metal", aspect=1.0, device="cpu"),
                   PARAMS, scene_id=3)
    before = v.renderer.scene
    for k in "0123":
        v.key(k)
        assert v.scene_id == int(k) and v.renderer.scene is not before
        before = v.renderer.scene
        want = v.renderer.step().clone()
        with monkeypatch.context() as m:
            calls = kernel_path_on_cpu(m)
            v.renderer.clear_accumulation()
            got = v.renderer.step()
        assert len(calls) == PARAMS.bounces + 1
        assert torch.equal(got, want)
    assert v.renderer.scene.num_spheres >= 3   # metal again


def test_core_runs_without_a_figure():
    """The figure-free core routes keys, resizes and steps frames into its
    clock."""
    scene, cam = rt.builtin_scene("room", aspect=1.0, device="cpu")
    v = ViewerCore(scene, cam, PARAMS, scene_id=2)
    for k in ("w", "d", "B", "r", "1"):
        v.key(k)
    v.resize(32, 16)
    for _ in range(3):
        rgb, dt = v.frame()
    assert rgb.shape == (16, 32, 3) and rgb.dtype == np.uint8
    assert v.renderer.frames == 2 and v.clock.count == 3 and dt > 0
    assert "frame 2" in v.status_line(dt)
    v.key("q")
    assert not v._running


def test_scroll_delta_paths():
    c = rt.CameraController()
    c.scroll_line_delta(2.0)
    assert c.scroll == -20000.0
    c.scroll_pixel_delta(30.0)
    assert c.scroll == -30.0


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_scene_switches_repack_on_the_card(cuda_device):
    """On the card each switch packs the new scene's planes once (the
    cache holds one scene per device) and its frame through the kernels
    matches the plain path's."""
    from ray_tracer_tpu_torch.ops import closest_hit
    scene, cam = rt.builtin_scene("metal", aspect=1.0, device=cuda_device)
    v = ViewerCore(scene, cam, rt.RenderParams(width=64, height=64,
                                               skybox=True), scene_id=3)
    for k in "0123":
        v.key(k)
        packs = closest_hit.scene_planes.packs
        got = v.renderer.step()
        assert closest_hit.scene_planes.packs == packs + 1
        plain = rt.render_frame(v.renderer.scene, rt.camera_basis(
            v.renderer.camera), v.renderer.params.replace(backend="torch"), 0)
        assert frac_off(got.cpu(), plain.cpu()) < 2e-3
