"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (a step that returns its state
unchanged, half of the batch left out with the mean over the rest, an
answer altered where it is produced). One card: no exchange between
chips to leave out."""

import pytest
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch import renderer, viewer
from ray_tracer_tpu_torch.grad import inverse
from rtbench.tests.common import cells_of, run_small


def unchanged_progressive(monkeypatch):
    """render_progressive hands back the image it was given (a fresh
    one where none)."""
    def broken(scene, basis, params, frames, start_frame=0, image0=None,
               **kw):
        if image0 is None:
            return torch.zeros((params.height, params.width, 3))
        return image0
    monkeypatch.setattr(rt, "render_progressive", broken)


def half_the_frames(monkeypatch):
    """Every odd frame is left out of the blend, the even ones averaged."""
    true = renderer.accumulate

    def broken(prev, frame_img, frame_index):
        if frame_index % 2:
            return prev
        return true(prev, frame_img, frame_index // 2)
    monkeypatch.setattr(renderer, "accumulate", broken)


def altered_frame(monkeypatch):
    """Frame 1 is rendered from frame 2's sample streams."""
    true = renderer.render_frame

    def broken(scene, basis, params, frame_index):
        return true(scene, basis, params,
                    2 if frame_index == 1 else frame_index)
    monkeypatch.setattr(renderer, "render_frame", broken)


@pytest.mark.parametrize("cell", cells_of("render"))
@pytest.mark.parametrize("fault", [unchanged_progressive, half_the_frames,
                                   altered_frame])
def test_render_faults_come_out_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(cell)
    assert r["correct"] is False and r["failed"] >= 1


def unchanged_viewer(monkeypatch):
    """The renderer's step hands back its image without the new frame."""
    true = renderer.Renderer.step

    def broken(self):
        if self._image is None:
            return true(self)
        self.frames += 1
        return self._image
    monkeypatch.setattr(renderer.Renderer, "step", broken)


def linear_display(monkeypatch):
    """The display encode leaves out the sRGB curve."""
    import numpy as np

    def broken(img, flip=True):
        x = img.detach().cpu().numpy()[::-1]
        return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    monkeypatch.setattr(viewer, "to_uint8", broken)


@pytest.mark.parametrize("cell", cells_of("view"))
@pytest.mark.parametrize("fault", [unchanged_viewer, half_the_frames,
                                   linear_display])
def test_view_faults_come_out_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(cell)
    assert r["correct"] is False and r["failed"] >= 1


def unchanged_step(monkeypatch):
    """The training step restores every leaf it updated."""
    true = inverse.make_train_step

    def make(*a, **kw):
        init_fn, step_fn = true(*a, **kw)

        def step(trainable, opt, *rest):
            before = {k: v.detach().clone() for k, v in trainable.items()}
            out = step_fn(trainable, opt, *rest)
            with torch.no_grad():
                for k, v in trainable.items():
                    v.copy_(before[k])
            return out
        return init_fn, step
    monkeypatch.setattr(inverse, "make_train_step", make)


def half_the_pixels(monkeypatch):
    """The loss is the mean over every other row of the frame."""
    def broken(trainable, scene, basis, params, frame_index, target,
               mesh=None):
        img = inverse.render_frame(inverse.merge_scene(scene, trainable),
                                   basis, params, int(frame_index))
        return torch.mean((img[::2] - target[::2]) ** 2)
    monkeypatch.setattr(inverse, "image_mse", broken)


def next_frame(monkeypatch):
    """Each step renders the next step's frame."""
    true = inverse.render_frame

    def broken(scene, basis, params, frame_index):
        return true(scene, basis, params, frame_index + 1)
    monkeypatch.setattr(inverse, "render_frame", broken)


@pytest.mark.parametrize("cell", cells_of("train"))
@pytest.mark.parametrize("fault", [unchanged_step, half_the_pixels,
                                   next_frame])
def test_train_faults_come_out_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(cell)
    assert r["correct"] is False and r["failed"] >= 1
