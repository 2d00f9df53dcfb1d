"""Interactive progressive viewer.

Port of ``ray_tracer_tpu.viewer``: a matplotlib window shows the
progressive accumulation while keyboard and mouse drive the fly-camera
controller (``camera.CameraController``) and the knob set of the
reference's imgui panel: bounces, rays per pixel, focus distance,
aperture, skybox, accumulate, denoise and scene switching 0-3. Any input
clears the accumulation.

Keys: W/A/S/D move, Space/Z up/down, arrow keys look, scroll zoom,
mouse-drag look, 0-3 switch built-in scene, B/b bounces +/-, R/r rays per
pixel +/-, F/f focus distance +/- (0..10), V/v aperture +/- (-2..2),
K toggle skybox, C toggle accumulate, N toggle denoise, P save PNG,
Q quit. The title mirrors the imgui readout (frame time, frame, camera
position and look-at).

``ViewerCore`` holds the renderer state and the input routing and needs
no figure (it runs where matplotlib is absent); ``Viewer`` wraps it in a
figure with a widget panel, importing matplotlib lazily. Unlike the
reference's panel, the widgets follow state that keys change. Scenes
switched to are built anew on the current scene's device, so the
kernels' plane cache packs them afresh.
"""

from __future__ import annotations

import time

from .camera import CameraController, camera_basis, update_camera
from .io.image import to_uint8
from .ops.closest_hit import plane_scope
from .renderer import Renderer
from .scene import SCENE_IDS, builtin_scene
from .utils.config import RenderParams
from .utils.metrics import FrameClock, span

# the focus and aperture keys' steps, within the imgui sliders' ranges
FOCUS_STEP, FOCUS_RANGE = 0.25, (0.0, 10.0)
APERTURE_STEP, APERTURE_RANGE = 0.1, (-2.0, 2.0)


class ViewerCore:
    """The viewer without a figure: a Renderer, the fly controller, the
    knob state, input routing and the frame step."""

    def __init__(self, scene, camera, params: RenderParams, scene_id=None):
        self.renderer = Renderer(scene, camera, params)
        self.controller = CameraController()
        self.scene_id = scene_id
        self.denoise = 0          # a-trous iterations on the display path
        self._drag_origin = None
        self._running = True
        self._dt = 1.0 / 30.0
        self.clock = FrameClock()
        self.frames_shown = 0     # frames returned: the spans' request id

    # -- input routing (the reference's Context::input) -------------------

    def _apply_camera(self):
        cam = update_camera(self.renderer.camera, self.controller, self._dt)
        for a in ("amount_forward", "amount_backward", "amount_left",
                  "amount_right", "amount_up", "amount_down"):
            setattr(self.controller, a, 0.0)
        self.renderer.set_camera(cam)  # clears accumulation

    def switch_scene(self, sid: int):
        scene, cam = builtin_scene(sid, aspect=self.renderer.params.aspect,
                                   device=self.renderer.scene.device)
        self.renderer.set_scene(scene)
        self.renderer.set_camera(cam)
        self.scene_id = sid

    def key(self, key: str):
        """Route one key press (matplotlib's key name: "B" is shift+b)."""
        k = (key or "").lower()
        moved = self.controller.press(
            {"z": "shift", " ": "space"}.get(k, k), True)
        if moved:
            self._apply_camera()
            return
        p = self.renderer.params
        cam = self.renderer.camera
        up = key != k
        if k in ("0", "1", "2", "3"):
            self.switch_scene(int(k))
        elif k == "b":
            self.renderer.set_params(
                p.replace(bounces=max(0, p.bounces + (1 if up else -1))))
        elif k == "r":
            self.renderer.set_params(p.replace(
                rays_per_pixel=max(1, p.rays_per_pixel + (1 if up else -1))))
        elif k == "f":
            lo, hi = FOCUS_RANGE
            f = cam.focus_dist + (FOCUS_STEP if up else -FOCUS_STEP)
            self.renderer.set_camera(cam.replace(
                focus_dist=min(hi, max(lo, f))))
        elif k == "v":
            lo, hi = APERTURE_RANGE
            a = cam.aperture + (APERTURE_STEP if up else -APERTURE_STEP)
            self.renderer.set_camera(cam.replace(
                aperture=min(hi, max(lo, a))))
        elif k == "k":
            self.renderer.set_params(p.replace(skybox=not p.skybox))
        elif k == "c":
            self.renderer.set_params(p.replace(accumulate=not p.accumulate))
        elif k == "n":
            # display-path filter only: the accumulation stays untouched
            self.denoise = 0 if self.denoise else 3
        elif k == "p":
            from .io.image import write_png
            fname = f"frame_{int(time.time())}.png"
            write_png(fname, self.renderer.image)
            print(f"saved {fname}")
        elif k == "q":
            self._running = False

    def scroll(self, step: float):
        """Wheel steps through the pixel-delta path at 25 px a step: the
        reference's line scale of 10000 teleports the camera (its
        deviation D16)."""
        self.controller.scroll_pixel_delta(step * 25.0)
        self._apply_camera()

    def press(self, x, y):
        self._drag_origin = (x, y)

    def release(self):
        self._drag_origin = None

    def drag(self, x, y):
        if self._drag_origin is None:
            return
        dx = (x - self._drag_origin[0]) * 0.02
        dy = (y - self._drag_origin[1]) * 0.02
        self._drag_origin = (x, y)
        self.controller.mouse(dx, dy)
        self._apply_camera()

    def resize(self, width: int, height: int):
        """Resolution change: new params and a fresh accumulation."""
        self.renderer.set_params(
            self.renderer.params.replace(width=width, height=height))

    def status_line(self, dt: float) -> str:
        """The imgui readout: frame time (instant, windowed mean and fps
        from the FrameClock), frame counter, scene, camera position,
        look-at, focus distance and aperture."""
        cam = self.renderer.camera
        pos = ", ".join(f"{x:.2f}" for x in cam.origin)
        look = ", ".join(f"{x:.2f}" for x in cam.look_at)
        sid = self.scene_id if self.scene_id is not None else "-"
        return (f"frame {self.renderer.frames}  {dt*1e3:.0f} ms "
                f"(avg {self.clock.mean_ms:.0f}, {self.clock.fps:.1f} fps)"
                f"  scene {sid}\npos ({pos})  look ({look})  "
                f"focus {cam.focus_dist:.2f}  aperture {cam.aperture:.2f}")

    def frame(self):
        """One progressive step (denoised for display where toggled) →
        (uint8 image on the host, seconds); the seconds include the copy
        to the host, which waits for the device, and go to the clock."""
        t0 = time.perf_counter()
        self.frames_shown += 1
        with span("viewer.frame", request=self.frames_shown):
            with plane_scope():  # the frame and its guides share one packing
                img = self.renderer.step()
                if self.denoise:
                    from .denoise import denoise_render
                    img = denoise_render(
                        self.renderer.scene,
                        camera_basis(self.renderer.camera),
                        self.renderer.params, img, iterations=self.denoise)
            rgb = to_uint8(img)
        dt = time.perf_counter() - t0
        self._dt = max(dt, 1e-3)
        self.clock.record(dt)
        return rgb, dt


class Viewer(ViewerCore):
    """ViewerCore in a matplotlib figure. ``widgets=True`` (default) adds
    a panel: sliders for bounces, rays per pixel, focus distance and
    aperture, checkboxes for skybox, accumulate and denoise, and a scene
    radio group, which drive the same state transitions as the keys and
    show the state that keys change."""

    def __init__(self, scene, camera, params: RenderParams, scene_id=None,
                 widgets: bool = True):
        import matplotlib.pyplot as plt

        super().__init__(scene, camera, params, scene_id)
        self.plt = plt
        pw = params.width / 100
        self.fig = plt.figure(
            figsize=(pw * (1.45 if widgets else 1.0), params.height / 100))
        # the image fills the left region; the right strip holds the panel
        self.ax = self.fig.add_axes((0.0, 0.0, 0.69 if widgets else 1.0, 1.0))
        self.ax.set_axis_off()
        self.im = None
        self._widgets = {}
        if widgets:
            self._build_widgets()
        connect = self.fig.canvas.mpl_connect
        connect("key_press_event", self._on_key)
        connect("scroll_event", self._on_scroll)
        connect("button_press_event", lambda e: self.press(e.x, e.y))
        connect("button_release_event", lambda e: self.release())
        connect("motion_notify_event", self._on_motion)
        connect("close_event", lambda e: self._stop())
        connect("resize_event", self._on_resize)

    # -- widget panel ------------------------------------------------------

    def _build_widgets(self):
        from matplotlib.widgets import CheckButtons, RadioButtons, Slider

        p = self.renderer.params
        cam = self.renderer.camera
        x, w = 0.78, 0.17

        def slider_ax(i):
            return self.fig.add_axes((x, 0.92 - i * 0.07, w, 0.04))

        s_bounce = Slider(slider_ax(0), "bounces", 0, 8,
                          valinit=p.bounces, valstep=1)
        s_rpp = Slider(slider_ax(1), "rays/px", 1, 8,
                       valinit=p.rays_per_pixel, valstep=1)
        s_focus = Slider(slider_ax(2), "focus", *FOCUS_RANGE,
                         valinit=float(cam.focus_dist))
        s_apert = Slider(slider_ax(3), "aperture", *APERTURE_RANGE,
                         valinit=float(cam.aperture))

        r = self.renderer
        s_bounce.on_changed(lambda v: r.set_params(
            r.params.replace(bounces=int(v))))
        s_rpp.on_changed(lambda v: r.set_params(
            r.params.replace(rays_per_pixel=int(v))))
        s_focus.on_changed(lambda v: r.set_camera(
            r.camera.replace(focus_dist=float(v))))
        s_apert.on_changed(lambda v: r.set_camera(
            r.camera.replace(aperture=float(v))))

        checks_ax = self.fig.add_axes((x, 0.42, w, 0.2))
        checks_ax.set_axis_off()
        checks = CheckButtons(checks_ax, ["skybox", "accumulate", "denoise"],
                              [p.skybox, p.accumulate, bool(self.denoise)])

        def on_check(label):
            pp = r.params
            if label == "skybox":
                r.set_params(pp.replace(skybox=not pp.skybox))
            elif label == "accumulate":
                r.set_params(pp.replace(accumulate=not pp.accumulate))
            else:
                self.denoise = 0 if self.denoise else 3
        checks.on_clicked(on_check)

        radio_ax = self.fig.add_axes((x, 0.1, w, 0.26))
        radio_ax.set_title("scene", fontsize=7)
        radio_ax.set_axis_off()
        names = [SCENE_IDS[i] for i in sorted(SCENE_IDS)]
        radio = RadioButtons(
            radio_ax, names,
            active=self.scene_id if isinstance(self.scene_id, int) else 0)
        radio.on_clicked(lambda label: self.switch_scene(names.index(label)))

        # keep references alive (matplotlib widgets are collected otherwise)
        self._widgets = {"bounces": s_bounce, "rpp": s_rpp, "focus": s_focus,
                         "aperture": s_apert, "checks": checks,
                         "scene": radio}

    def _sync_widgets(self):
        """Show the renderer's state in the panel without firing the
        widgets' callbacks."""
        if not self._widgets:
            return
        w, p, cam = self._widgets, self.renderer.params, self.renderer.camera
        for name, value in (("bounces", p.bounces),
                            ("rpp", p.rays_per_pixel),
                            ("focus", cam.focus_dist),
                            ("aperture", cam.aperture)):
            w[name].eventson = False
            w[name].set_val(value)
            w[name].eventson = True
        checks = w["checks"]
        checks.eventson = False
        for i, want in enumerate((p.skybox, p.accumulate,
                                  bool(self.denoise))):
            if checks.get_status()[i] != want:
                checks.set_active(i)
        checks.eventson = True
        if isinstance(self.scene_id, int):
            w["scene"].eventson = False
            w["scene"].set_active(self.scene_id)
            w["scene"].eventson = True

    # -- matplotlib events -------------------------------------------------

    def _on_key(self, event):
        self.key(event.key)
        self._sync_widgets()

    def _on_scroll(self, event):
        self.scroll(event.step)

    def _on_motion(self, event):
        self.drag(event.x, event.y)

    def _stop(self):
        self._running = False

    def resize(self, width: int, height: int):
        super().resize(width, height)
        self.im = None  # imshow again at the new extent

    def _on_resize(self, event):
        """Window resize → render resolution: the image axes' extent
        (not the whole canvas, whose title and margins would over-render),
        in multiples of 16, and nothing when unchanged (matplotlib fires
        resize events on some ordinary draws too)."""
        try:
            bbox = self.ax.get_window_extent()
            ew, eh = bbox.width, bbox.height
        except Exception:  # a backend without a realized renderer yet
            ew, eh = event.width, event.height
        w = max(64, int(ew) // 16 * 16)
        h = max(64, int(eh) // 16 * 16)
        p = self.renderer.params
        if (w, h) != (p.width, p.height):
            self.resize(w, h)

    # -- frame loop --------------------------------------------------------

    def run(self, max_frames=None):
        self.plt.ion()
        self.fig.show()
        n = 0
        while self._running and (max_frames is None or n < max_frames):
            rgb, dt = self.frame()
            if self.im is None:
                self.im = self.ax.imshow(rgb)
            else:
                self.im.set_data(rgb)
            self.ax.set_title(self.status_line(dt), fontsize=7)
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
            n += 1
        self.plt.ioff()


def view(scene, camera, params: RenderParams, scene_id=None, max_frames=None):
    """Open an interactive viewer window. Raises RuntimeError where there
    is no interactive matplotlib backend (or no matplotlib)."""
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("matplotlib is not installed (headless?); use "
                           "`python -m ray_tracer_tpu_torch render`") from None
    if matplotlib.get_backend().lower() in ("agg", "pdf", "svg", "ps"):
        raise RuntimeError(
            "no interactive matplotlib backend available (headless?); "
            "use `python -m ray_tracer_tpu_torch render` instead")
    v = Viewer(scene, camera, params, scene_id=scene_id)
    v.run(max_frames=max_frames)
    return v
