"""Viewer traffic: the interactive window's loop, ``ViewerCore.frame()``
one frame after another, with fly keys through ``ViewerCore.key``.

One user. Each run of ``frames_per_key`` frames gets one key press at a
position drawn from the seed, before that frame; the keys come in cycles
holding each of ``keys`` once, shuffled from the seed, so every seed
sends the same keys at the same rate and the camera wanders no further
than a cycle takes it. A key moves the camera by the viewer's last frame
time and resets the accumulation. A frame's time runs from the call to
the 8-bit image on the host.

The comparison: a sample of the window's frames drawn from the seed
(``check_frames``, reservoir sampling), each read at ``check_tiles``
whole share tiles drawn from the seed. The reference replays the key
presses (with the frame time each press used, a clock reading it cannot
work out), traces every frame of the accumulation up to the sampled one
on those tiles, blends them and encodes them; the number compared is the
largest share of a frame's pixels with a channel more than
``level_tolerance`` levels off. The control puts the reference in
bfloat16 in the program's place.

The window's frames are timed one by one: the end-to-end metric is the
mean (the window's seconds over its frames), and the traced run reports
their 95th percentile beside it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import scenes
from rtbench.reference import pathtrace as ref
from rtbench.reference import viewer as ref_viewer


# the traffic's keys at a size a test on the CPU can hold
SMALL = {"width": 64, "height": 32, "frames_per_key": 4, "check_tiles": 2,
         "trace_units": 2}


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.W, self.H = int(traffic["width"]), int(traffic["height"])

    def inputs(self):
        """The run's inputs from the seed: the scene's arrays and the
        share tiles the comparison reads."""
        self.arrays = scenes.make(self.config["scene"], self.seed)
        self.rng = scenes.seed_rng(self.seed, 1)
        n_tiles = self.W * self.H // ref.SHARE_TILE
        self.tiles = np.sort(self.rng.choice(n_tiles, int(self.traffic[
            "check_tiles"]), replace=False))
        px = ref.tile_pixels(self.W, self.H, self.tiles)
        self.pixels = px
        self.rows, self.cols = self.H - 1 - px // self.W, px % self.W
        self.events = []      # ("key", key, dt) and ("frame",), in order

    def setup(self):
        from ray_tracer_tpu_torch.viewer import ViewerCore
        self.mark("import_port")
        self.inputs()
        params, cam = scenes.port_view(self.config, self.W, self.H)
        self.core = ViewerCore(scenes.port_scene(self.arrays, self.device),
                               cam, params)
        self.mark("scene")
        self.kept = []        # (index into events, 8-bit tile values)
        self.frame_s = []
        self.plan = []
        self.window_frames = 0
        for _ in range(2):    # warm-up: a fresh frame and a blended one
            self.core.frame()
            self.events.append(("frame",))

    def _key_for(self, i):
        """The key pressed before window frame ``i``, or None."""
        per = int(self.traffic["frames_per_key"])
        keys = self.traffic["keys"]
        cycle = per * len(keys)
        while len(self.plan) <= i // cycle:
            order = self.rng.permutation(len(keys))
            offsets = self.rng.integers(per, size=len(keys))
            self.plan.append({k * per + int(offsets[k]): keys[order[k]]
                              for k in range(len(keys))})
        return self.plan[i // cycle].get(i % cycle)

    def step(self):
        key = self._key_for(self.window_frames)
        if key is not None:
            self.events.append(("key", key, self.core._dt))
            self.core.key(key)
        t0 = time.perf_counter()
        rgb, _ = self.core.frame()
        self.frame_s.append(time.perf_counter() - t0)
        self.events.append(("frame",))
        self.window_frames += 1
        self._keep(rgb)

    def _keep(self, rgb):
        k = int(self.traffic["check_frames"])
        slot = (len(self.kept) if len(self.kept) < k
                else int(self.rng.integers(self.window_frames)))
        if slot < k:
            item = (len(self.events) - 1, rgb[self.rows, self.cols].copy())
            if slot == len(self.kept):
                self.kept.append(item)
            else:
                self.kept[slot] = item

    def end_to_end(self, units, window_s):
        return {"frame_ms": 1e3 * window_s / units}

    def layer_context(self, units):
        return dict(frames_per_unit=1, frame_ms_p95=1e3 * float(
            np.percentile(self.frame_s[:units], 95)))

    def release(self):
        del self.core
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def replay(self, upto: int):
        """(origin, look_at, frames accumulated) after ``events[:upto + 1]``
        from the configuration's camera."""
        cam = self.config["camera"]
        origin, look_at = tuple(cam["origin"]), tuple(cam["look_at"])
        count = 0
        for ev in self.events[:upto + 1]:
            if ev[0] == "key":
                origin, look_at = ref_viewer.fly(origin, look_at, ev[1],
                                                 max(ev[2], 1e-3))
                count = 0
            else:
                count += 1
        return origin, look_at, count

    def reference_tiles(self, upto: int, dtype=torch.float32):
        """The reference's 8-bit values at the kept tiles for the frame
        logged at ``events[upto]``."""
        origin, look_at, count = self.replay(upto)
        basis = ref.camera_basis(origin, look_at,
                                 float(self.config["camera"]["fov"]),
                                 self.W / self.H)
        S = ref.build_scene(self.arrays, self.device, dtype)
        frames = list(range(count))
        per = ref.render_lanes(S, basis, dict(self.config["render"]),
                               self.W, self.H, self.pixels, frames)
        img = ref.accumulated(per, frames).float().cpu().numpy()
        return ref_viewer.to_uint8(img)

    def bad_pixel_share(self, upto, got, dtype=torch.float32):
        want = self.reference_tiles(upto, dtype)
        off = np.abs(got.astype(np.int32) - want.astype(np.int32))
        return float((off.max(-1) > int(self.traffic["level_tolerance"]))
                     .mean())

    def check(self):
        return {"bad_pixel_share": max(self.bad_pixel_share(upto, got)
                                       for upto, got in self.kept)}

    def control(self):
        """The reference in bfloat16 in the program's place, at a frame
        accumulated over ``frames_per_key`` frames at the configuration's
        camera, on the run's tiles."""
        self.inputs()
        self.events = [("frame",)] * int(self.traffic["frames_per_key"])
        upto = len(self.events) - 1
        got = self.reference_tiles(upto, torch.bfloat16)
        return {"control": {"bad_pixel_share": self.bad_pixel_share(
            upto, got)}}
