"""Render traffic over the ranks of a mesh: the closed loop of
``drivers/render.py`` (images of ``calls_per_image`` calls of
``frames_per_call`` frames, each call continuing the last's image), with
every call rendered by all the ranks of the port's process group through
``parallel.progressive.render_progressive_distributed``: each rank
traces its run of whole share tiles on its own card and one all-gather a
call hands every rank the image.

Each rank joins the group through ``parallel.distributed.initialize()``
in ``setup()`` (NCCL on cards, gloo on the CPU; with no ``torchrun``
environment there is no group and the calls are the one-process path),
builds the scene on its own device and runs the same calls. Rank 0 keeps
the sampled calls' tiles of the gathered image and alone compares them
with the plain reference, as ``drivers/render.py`` does. The tiles are
drawn from the seed evenly over the ranks' runs of the configuration's
layout (``deployment.ranks``), so that every rank's part of the image is
read. A rate counts the whole image's segments.

The ``parallel`` layer's readers compare the ranks, whose traces rank 0
does not see: in a traced run, ``layer_context`` runs ``trace_units``
more calls one at a time with the port's spans on, and hands every rank
each rank's stream milliseconds of each call's spans in ``RANK_SPANS``
(``rank_spans``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from rtbench import core, scenes
from rtbench.drivers import render as one_card
from rtbench.reference import pathtrace as ref

# the traffic's keys at a size a test on the CPU can hold: 5 share tiles,
# one checked in each of four ranks' runs
SMALL = {"width": 64, "height": 40, "frames_per_call": 4,
         "calls_per_image": 2, "check_tiles": 4, "trace_units": 1}
# the port's stream spans of a call whose readings the readers compare
# over the ranks: the rank's frames of its run, then the gather after
# them, and the collective alone
RANK_SPANS = ("parallel.shard", "parallel.gather", "parallel.all_gather")


def rank_readings(trace, name: str):
    """[[stream ms of span ``name`` in call c on rank r, for each rank]
    for each measured call c] from a traced stretch's ``rank_spans``;
    None where there is none, or a rank timed no event pair (no card)."""
    calls = getattr(trace, "context", {}).get("rank_spans", {}).get(name)
    if not calls or any(ms is None for call in calls for ms in call):
        return None
    return calls


def tile_runs(n_lanes: int, ranks: int) -> list:
    """(first, stop) share tile of each rank's run by the configuration's
    layout: whole tiles of the frame's lanes, the first ``tiles % ranks``
    ranks one more, cut to the tiles the frame fills whole (the ones the
    reference traces)."""
    whole = n_lanes // ref.SHARE_TILE
    base, extra = divmod(-(-n_lanes // ref.SHARE_TILE), ranks)
    runs, first = [], 0
    for r in range(ranks):
        stop = first + base + (r < extra)
        runs.append((min(first, whole), min(stop, whole)))
        first = stop
    return runs


class Cell(one_card.Cell):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.rank = int(os.environ.get("RANK", 0))
        self.world = int(os.environ.get("WORLD_SIZE", 1))
        self.runs = tile_runs(self.W * self.H,
                              int(config["deployment"]["ranks"]))

    def inputs(self):
        """The scene's arrays and the checked tiles from the seed:
        ``check_tiles`` spread evenly over the layout's runs."""
        self.arrays = scenes.make(self.config["scene"], self.seed)
        rng = scenes.seed_rng(self.seed, 1)
        k = int(self.traffic["check_tiles"])
        picked = []
        for r, (first, stop) in enumerate(self.runs):
            want = k // len(self.runs) + (r < k % len(self.runs))
            picked += list(first + rng.choice(
                stop - first, min(want, stop - first), replace=False))
        self.tiles = np.sort(np.array(picked, dtype=np.int64))
        self.pixels = torch.as_tensor(
            ref.tile_pixels(self.W, self.H, self.tiles), device=self.device)
        self.rng = rng

    def setup(self):
        import ray_tracer_tpu_torch as rt
        from ray_tracer_tpu_torch.parallel import distributed
        from ray_tracer_tpu_torch.parallel.progressive import (
            render_progressive_distributed)
        self.rt = rt
        self.render = render_progressive_distributed
        self.mark("import_port")
        distributed.initialize(device=self.device)
        self.mark("group")
        self.inputs()
        self.scene = scenes.port_scene(self.arrays, self.device)
        self.params, cam = scenes.port_view(self.config, self.W, self.H)
        self.basis = rt.camera_basis(cam)
        self.mark("scene")
        self.kept = []
        self.calls = 0
        self.enqueue_s = []
        self.image = None
        # warm-up: a fresh image and a continued one, each with its
        # all-gather (the group's first collective connects the ranks)
        img = self.render(self.scene, self.basis, self.params, 1)
        self.render(self.scene, self.basis, self.params, 1, start_frame=1,
                    image0=img)

    def step(self):
        pos = self.calls % self.per_image
        t0 = time.perf_counter()
        self.image = self.render(
            self.scene, self.basis, self.params, self.F,
            start_frame=pos * self.F,
            image0=None if pos == 0 else self.image)
        self.enqueue_s.append(time.perf_counter() - t0)
        self.calls += 1
        if self.rank == 0:
            self._keep(pos)

    def layer_context(self, units):
        """As a one-card render's, with ``lanes`` this rank's lanes a
        launch (its run of whole tiles), and the layout: ``ranks``, the
        image's lanes and the run's unit."""
        context = super().layer_context(units)
        if self.world > 1:
            first, stop = tile_runs(self.W * self.H, self.world)[self.rank]
            context["lanes"] = ((stop - first) * ref.SHARE_TILE
                                * self.params.rays_per_pixel)
        context.update(ranks=self.world, image_lanes=self.W * self.H,
                       shard_unit=ref.SHARE_TILE,
                       rank_spans=self.rank_spans(
                           int(self.traffic["trace_units"])))
        return context

    def rank_spans(self, calls: int) -> dict:
        """``calls`` more calls of the loop, each alone between two
        synchronizes, with the port's spans on → {span of ``RANK_SPANS``:
        [[its stream ms in call c on rank r, for each rank] for each call
        c]}, the same on every rank; a reading is None where the rank
        timed no event pair (no card). Empty where the program lacks one
        of the spans."""
        try:
            from ray_tracer_tpu_torch.utils.metrics import (SPANS,
                                                            span_totals,
                                                            tracing)
        except ImportError:
            return {}
        if not all(SPANS.get(name) for name in RANK_SPANS):
            return {}
        mine = {name: [] for name in RANK_SPANS}
        tracing(True)
        try:
            for _ in range(calls):
                core.synchronize(self.device)
                before = span_totals()
                self.step()
                core.synchronize(self.device)
                after = span_totals()
                for name, got in mine.items():
                    pairs = (after[f"{name}.stream_n"]
                             - before[f"{name}.stream_n"])
                    got.append(after[f"{name}.stream_ms"]
                               - before[f"{name}.stream_ms"]
                               if pairs else None)
        finally:
            tracing(False)
        ranks = [mine]
        if self.world > 1 and dist.is_initialized():
            ranks = [None] * self.world
            dist.all_gather_object(ranks, mine)
        return {name: [[r[name][c] for r in ranks] for c in range(calls)]
                for name in RANK_SPANS}

    def release(self):
        super().release()
        if dist.is_initialized():
            dist.destroy_process_group()

    def check(self):
        """Rank 0's comparison of the gathered image with the reference;
        the other ranks compare nothing."""
        return super().check() if self.rank == 0 else {}
