"""Training traffic: a closed loop of ``make_train_step`` steps, one
whole-frame gradient and one Adam step each, as inverse-rendering users
run them.

Set-up builds the one training object (the step, its trainable leaves and
Adam) from the scene with its albedos scaled by ``albedo_start``, renders
the target from the true scene (frame f0), and drives that same object
through its first ``check_steps`` steps (frame f0 + step), which warm
every shape; the window goes on with the same object from there. The
seed draws f0, so the sample streams, and not the surface: the step is
half device-bound, and a surface moved by the seed changed its work (4%
between three seeds on an H100).

The comparison, with the plain reference's own first steps from the same
arrays: each step's loss (the largest relative gap), the first gradient
as Adam got it (its first moment after one step over 1 - beta1), and
each leaf's change after the steps, both by the worst leaf's gap between
norms (``reference.train.leaf_gaps``); the change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import dataclasses

import torch

from rtbench import scenes
from rtbench.reference import train as ref_train


# the traffic's keys at a size a test on the CPU can hold
SMALL = {"width": 32, "height": 16, "trace_units": 1}


def numbers(got, want) -> dict:
    """The compared numbers of the first steps ``got`` (losses, the first
    gradient, each leaf's change) against the reference's ``want``
    (losses, the first gradient, each leaf's start and end)."""
    losses, first, change = got
    w_losses, w_first, w_start, w_end = want
    w_first = {k: v.cpu() for k, v in w_first.items()}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, w_losses)),
        "grad_gap": ref_train.leaf_gaps(
            {k: v.float().cpu() for k, v in first.items()}, w_first),
        "change_gap": ref_train.leaf_gaps(
            {k: v.float().cpu() for k, v in change.items()},
            {k: (w_end[k] - w_start[k]).cpu() for k in w_end},
            ref_train.moving_leaves(w_first)),
    }


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.W, self.H = int(traffic["width"]), int(traffic["height"])

    def inputs(self):
        """The run's inputs: the scene's arrays and, from the seed, the
        target's frame f0."""
        self.arrays = scenes.make(self.config["scene"], 0)
        self.frame0 = int(scenes.seed_rng(self.seed, 2).integers(1 << 20))

    def optimizer(self, leaves):
        names = dict(zip(self.fields, leaves))
        albedo = {"lr": float(self.traffic["lr_albedo"]), "params": [
            v for k, v in names.items() if k in ref_train.ALBEDOS]}
        geometry = {"lr": float(self.traffic["lr_geometry"]), "params": [
            v for k, v in names.items() if k not in ref_train.ALBEDOS]}
        return torch.optim.Adam([albedo, geometry])

    def setup(self):
        import ray_tracer_tpu_torch as rt
        from ray_tracer_tpu_torch.grad import DEFAULT_TRAINABLE
        from ray_tracer_tpu_torch.grad.inverse import make_train_step
        self.fields = DEFAULT_TRAINABLE
        self.mark("import_port")
        self.inputs()
        scene = scenes.port_scene(self.arrays, self.device)
        self.params, cam = scenes.port_view(self.config, self.W, self.H)
        self.basis = rt.camera_basis(cam)
        self.mark("scene")
        with torch.no_grad():
            self.target = rt.render_frame(scene, self.basis, self.params,
                                          self.frame0)
        self.mark("target")
        s = float(self.traffic["albedo_start"])
        self.start = dataclasses.replace(
            scene, tri_albedo=scene.tri_albedo * s,
            sphere_albedo=scene.sphere_albedo * s)
        init_fn, self.step_fn = make_train_step(self.params, self.optimizer)
        self.trainable, self.opt = init_fn(self.start, self.fields)
        self.mark("train_init")
        begin = {k: v.detach().clone() for k, v in self.trainable.items()}
        self.losses, self.first = [], None
        self.frame = self.frame0
        beta1 = self.opt.param_groups[0]["betas"][0]
        for _ in range(int(self.traffic["check_steps"])):
            loss = self.step()
            self.losses.append(float(loss))
            if self.first is None:
                self.first = {k: self.opt.state[p]["exp_avg"].detach()
                              .clone() / (1.0 - beta1)
                              for k, p in self.trainable.items()}
        self.change = {k: (v.detach() - begin[k]).clone()
                       for k, v in self.trainable.items()}

    def step(self):
        self.trainable, self.opt, loss = self.step_fn(
            self.trainable, self.opt, self.start, self.basis, self.target,
            self.frame)
        self.frame += 1
        return loss

    def end_to_end(self, units, window_s):
        return {"step_s": window_s / units}

    def layer_context(self, units):
        return dict(steps_per_unit=1,
                    lanes=self.W * self.H * self.params.rays_per_pixel,
                    num_tris=self.start.num_tris,
                    num_spheres=self.start.num_spheres,
                    rows=self.start.padded_spheres + self.start.padded_tris,
                    textured=self.start.num_textures > 0)

    def release(self):
        self.first = {k: v.cpu() for k, v in self.first.items()}
        self.change = {k: v.cpu() for k, v in self.change.items()}
        del self.trainable, self.opt, self.start, self.target, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw):
        """The plain reference's first ``check_steps`` steps from the
        run's inputs (``reference.train.train``; ``kw`` plants a fault or
        a lower precision)."""
        return ref_train.train(
            self.arrays, self.config, self.traffic, self.device,
            steps=int(self.traffic["check_steps"]), frame0=self.frame0, **kw)

    def check(self):
        return numbers((self.losses, self.first, self.change),
                       self.reference())

    def control(self):
        """The reference in bfloat16 in the program's place, and two
        faults planted in the reference put there: half of the pixels'
        rows left out of the loss (the mean over the rest), and every
        step rendering the next step's frame."""
        self.inputs()
        want = self.reference()
        steps = int(self.traffic["check_steps"])

        def got(**kw):
            losses, first, start, end = self.reference(**kw)
            return losses, first, {k: end[k].float() - start[k].float()
                                   for k in end}
        return {
            "control": numbers(got(dtype=torch.bfloat16), want),
            "half_batch": numbers(got(loss_fn=lambda img, t: torch.mean(
                (img[::2] - t[::2]) ** 2)), want),
            "next_frame": numbers(got(frames=[
                self.frame0 + k + 1 for k in range(steps)]), want)}
