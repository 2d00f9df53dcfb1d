"""ray_tracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

The port of ``ray_tracer_tpu`` (JAX, the reference) to PyTorch on an
NVIDIA Hopper GPU. Module names mirror the reference's. This package
imports torch and numpy, never jax. Ported: the forward render path
(scenes, camera, sampling, materials, sky, intersection and the
progressive renderer) and the training path (``grad``: the image loss, its
gradient and the optimizer step). Two hand-written CUDA kernels, built
with nvcc at first use, carry them: the closest-hit search
(``ops/closest_hit.py``, ``csrc/closest_hit.cu``) and its backward, the
scatter-add of the winner rows' cotangents (``ops/scatter_rows.py``,
``csrc/scatter_rows.cu``).

Quick start:
    >>> import ray_tracer_tpu_torch as rt
    >>> scene, cam = rt.builtin_scene("metal", aspect=1.0, device="cuda")
    >>> img = rt.render(scene, cam, rt.RenderParams(width=256, height=256,
    ...                                             skybox=True), frames=8)

``backend="auto"`` runs the kernel for a scene on a CUDA device and the
plain PyTorch oracle for a scene on the CPU.
"""

from . import grad, io
from .camera import Camera, CameraBasis, camera_basis, camera_rays
from .renderer import (Renderer, accumulate, render, render_adaptive,
                       render_aov, render_frame, render_pixels,
                       render_progressive, trace)
from .scene import (
    BUILTIN_SCENES,
    SCENE_IDS,
    Scene,
    SceneBuilder,
    builtin_scene,
    scene_balls,
    scene_from_numpy,
    scene_metal,
    scene_random_balls,
    scene_room,
)
from .utils.config import RenderParams

__version__ = "0.1.0"

__all__ = [
    "Camera", "CameraBasis", "camera_basis", "camera_rays",
    "Renderer", "accumulate", "render", "render_adaptive", "render_aov",
    "render_frame", "render_pixels", "render_progressive", "trace",
    "Scene", "SceneBuilder", "builtin_scene", "scene_balls",
    "scene_from_numpy", "scene_metal", "scene_random_balls", "scene_room",
    "BUILTIN_SCENES", "SCENE_IDS", "RenderParams", "grad", "io",
]
