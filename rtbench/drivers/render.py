"""Render traffic: a closed loop of progressive images through
``render_progressive``, as the ``render`` command serves them.

One client. An image is ``calls_per_image`` back-to-back calls of
``frames_per_call`` frames at ``width`` × ``height``; each call continues
the previous call's image (``image0``, ``start_frame``), and the next
image starts afresh from frame 0. Every call has the same size.

The comparison: a sample of the window's calls drawn from the seed
(``check_calls``, kept by reservoir sampling), each read at the same
``check_tiles`` whole share tiles (512 lanes of the blocked order, drawn
from the seed) as the call returned them. Once the window has closed and
the program's state is freed, the plain reference traces every frame of
that image up to the call on those tiles and accumulates them; the number
compared is the largest share of a call's pixels whose worst channel is
more than ``pixel_tolerance`` off the reference. The control puts the
reference in bfloat16 in the program's place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import scenes
from rtbench.reference import pathtrace as ref


def reference_basis(config: dict, W: int, H: int):
    cam = config["camera"]
    return ref.camera_basis(cam["origin"], cam["look_at"], cam["fov"],
                            W / H)


def bad_pixel_share(got, want, tolerance: float) -> float:
    """Share of pixels whose worst channel is more than ``tolerance``
    off."""
    off = (got.float() - want.float()).abs().amax(-1)
    return float((~(off <= tolerance)).float().mean())


# the traffic's keys at a size a test on the CPU can hold
SMALL = {"width": 64, "height": 32, "frames_per_call": 4,
         "calls_per_image": 2, "check_tiles": 2, "trace_units": 1}


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.W, self.H = int(traffic["width"]), int(traffic["height"])
        self.F = int(traffic["frames_per_call"])
        self.per_image = int(traffic["calls_per_image"])

    def inputs(self):
        """The run's inputs from the seed: the scene's arrays and the
        share tiles the comparison reads."""
        self.arrays = scenes.make(self.config["scene"], self.seed)
        rng = scenes.seed_rng(self.seed, 1)
        n_tiles = self.W * self.H // ref.SHARE_TILE
        self.tiles = np.sort(rng.choice(n_tiles, int(self.traffic[
            "check_tiles"]), replace=False))
        self.pixels = torch.as_tensor(
            ref.tile_pixels(self.W, self.H, self.tiles), device=self.device)
        self.rng = rng

    def setup(self):
        import ray_tracer_tpu_torch as rt
        self.rt = rt
        self.mark("import_port")
        self.inputs()
        self.scene = scenes.port_scene(self.arrays, self.device)
        self.params, cam = scenes.port_view(self.config, self.W, self.H)
        self.basis = rt.camera_basis(cam)
        self.mark("scene")
        self.kept = []        # (call position in its image, tile values)
        self.calls = 0
        self.enqueue_s = []
        self.image = None
        # warm-up: a fresh image and a continued one, the window's shapes
        img = rt.render_progressive(self.scene, self.basis, self.params, 1)
        rt.render_progressive(self.scene, self.basis, self.params, 1,
                              start_frame=1, image0=img)

    def step(self):
        pos = self.calls % self.per_image
        t0 = time.perf_counter()
        self.image = self.rt.render_progressive(
            self.scene, self.basis, self.params, self.F,
            start_frame=pos * self.F,
            image0=None if pos == 0 else self.image)
        self.enqueue_s.append(time.perf_counter() - t0)
        self.calls += 1
        self._keep(pos)

    def _keep(self, pos):
        """Reservoir sampling of ``check_calls`` calls, from the seed."""
        k = int(self.traffic["check_calls"])
        slot = (len(self.kept) if len(self.kept) < k
                else int(self.rng.integers(self.calls)))
        if slot < k:
            got = self.image.reshape(-1, 3)[self.pixels].clone()
            if slot == len(self.kept):
                self.kept.append((pos, got))
            else:
                self.kept[slot] = (pos, got)

    def end_to_end(self, units, window_s):
        p = self.params
        segs = (self.W * self.H * p.rays_per_pixel * (p.bounces + 1)
                * self.F * units)
        return {"segments_per_s": segs / window_s / 1e6}

    def layer_context(self, units):
        p = self.params
        return dict(frames_per_unit=self.F,
                    lanes=self.W * self.H * p.rays_per_pixel,
                    num_tris=self.scene.num_tris,
                    num_spheres=self.scene.num_spheres,
                    rows=self.scene.padded_spheres + self.scene.padded_tris,
                    textured=self.scene.num_textures > 0,
                    enqueue_ms_per_frame=(1e3 * sum(self.enqueue_s[:units])
                                          / (self.F * units)))

    def release(self):
        self.kept = [(pos, got.cpu()) for pos, got in self.kept]
        del self.scene, self.image
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_tiles(self, positions, dtype=torch.float32):
        """The reference's accumulated image at the kept tiles after the
        call at each position of its image, by position."""
        S = ref.build_scene(self.arrays, self.device, dtype)
        frames = list(range((max(positions) + 1) * self.F))
        per = ref.render_lanes(S, reference_basis(self.config, self.W,
                                                  self.H),
                               self.config["render"], self.W, self.H,
                               self.pixels.cpu().numpy(), frames)
        return {p: ref.accumulated(per, frames[:(p + 1) * self.F]).cpu()
                for p in set(positions)}

    def check(self):
        tol = float(self.traffic["pixel_tolerance"])
        want = self.reference_tiles([pos for pos, _ in self.kept])
        return {"bad_pixel_share": max(
            bad_pixel_share(got, want[pos], tol) for pos, got in self.kept)}

    def control(self):
        """The reference in bfloat16 in the program's place, at the last
        call of an image (the most frames) on the run's tiles."""
        self.inputs()
        last = self.per_image - 1
        want = self.reference_tiles([last])[last]
        got = self.reference_tiles([last], torch.bfloat16)[last]
        return {"control": {"bad_pixel_share": bad_pixel_share(
            got, want, float(self.traffic["pixel_tolerance"]))}}
