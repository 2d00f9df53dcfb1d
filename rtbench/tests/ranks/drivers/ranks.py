"""The test bench's driver: each unit all-reduces a vector of ``size``
over the program's group, which the driver joins through the port's
``parallel.distributed.initialize()`` (gloo on the CPU, NCCL on cards),
as the driver of a cell on more than one card does.

It counts the units of every phase, and its check gathers the counts
over the group: ``step_gap`` is the largest difference between two
ranks' counts, ``sum_gap`` the worst distance of the all-reduced sum from
what the ranks put in. ``raise_at`` ([rank, unit]) makes that rank raise
at that unit; ``load_on_rank`` puts a module named ``jax`` in that rank's
``sys.modules``. ``sleep_s`` (seconds by rank) makes each rank sleep that
long in every unit, and ``"collective": false`` leaves the all-reduce
out, so that nothing couples the ranks' units.
"""

import os
import sys
import time
import types

import torch
import torch.distributed as dist

SMALL = {}


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.traffic, self.device = traffic, device
        self.rank = int(os.environ.get("RANK", 0))
        self.world = int(os.environ.get("WORLD_SIZE", 1))
        self.steps = 0
        self.sum_gap = 0.0

    def setup(self):
        from ray_tracer_tpu_torch.parallel import distributed
        distributed.initialize(device=self.device)
        self.mark("group")
        if self.traffic.get("load_on_rank") == self.rank:
            sys.modules["jax"] = types.ModuleType("jax")
        self.x = torch.full((int(self.traffic["size"]),),
                            float(self.rank + 1), device=self.device)

    def step(self):
        if self.traffic.get("raise_at") == [self.rank, self.steps]:
            raise RuntimeError(f"rank {self.rank} fails at unit "
                               f"{self.steps}")
        if "sleep_s" in self.traffic:
            time.sleep(self.traffic["sleep_s"][self.rank])
        y = self.x.clone()
        if dist.is_initialized() and self.traffic.get("collective", True):
            dist.all_reduce(y)
            want = self.world * (self.world + 1) / 2 * y.numel()
        else:
            want = (self.rank + 1) * y.numel()
        self.sum_gap = max(self.sum_gap, abs(float(y.sum()) - want))
        self.steps += 1

    def end_to_end(self, units, window_s):
        return {"units_per_s": units / window_s}

    def layer_context(self, units):
        return {"steps_per_unit": 1}

    def release(self):
        del self.x

    def check(self):
        counts = [self.steps]
        if dist.is_initialized():
            counts = [None] * self.world
            dist.all_gather_object(counts, self.steps)
            dist.destroy_process_group()
        print(f"ranks-test: rank {self.rank} steps {self.steps}",
              file=sys.stderr)
        return {"step_gap": max(counts) - min(counts),
                "sum_gap": self.sum_gap}
