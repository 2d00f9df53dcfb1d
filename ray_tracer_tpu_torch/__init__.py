"""ray_tracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

The port of ``ray_tracer_tpu`` (JAX, the reference) to PyTorch on an
NVIDIA Hopper GPU. Module names mirror the reference's. This package
imports torch and numpy, never jax. Ported: the forward render path
(scenes, camera, sampling, materials, sky, intersection and the
progressive renderer), next-event estimation with MIS and Russian
roulette (``lights``, ``RenderParams.nee``, ``mis``, ``rr_start``) and the
training path (``grad``: the image loss, its gradient and the optimizer
step), on scenes of any size, textures, and the image extras: primary-ray
AOVs (``render_aov``), adaptive sampling (``render_adaptive``), the
à-trous denoiser (``denoise``, ``denoise_render``), R2 anti-aliasing
(``RenderParams.qmc``), wavefront compaction (``compaction``) and
per-segment rematerialization (``remat``), and geometry recovery:
edge-sampled boundary gradients (``grad.edges``), mesh connectivity and
vertex fields (``grad.topology``), the per-vertex recovery loop
(``tools.invert_vertices``) and the OBJ / glTF / GLB loaders (``io``,
``models``), multi-device rendering and training on ``torch.distributed``
(``parallel``, ``grad.make_train_step(mesh=)``), the differentiable camera
basis (``camera_basis_tensor``), and the app shell: the command line
(``python -m ray_tracer_tpu_torch``), the viewer, checkpoints and metrics
(``utils``). Four hand-written CUDA
kernels, built with nvcc at first use, carry them: the closest-hit search
(``ops/closest_hit.py``, ``csrc/closest_hit.cu``), its backward, the
scatter-add of the winner rows' cotangents (``ops/scatter_rows.py``,
``csrc/scatter_rows.cu``), the any-hit search of NEE's shadow rays
(``ops/anyhit.py``, ``csrc/anyhit.cu``), and the streaming closest-hit
search that takes both the closest hit and the shadow rays on scenes of
more than 24,576 padded triangles (``ops/blocked_hit.py``,
``csrc/blocked_hit.cu``), as the reference's kernels split them.

Entry points run on the card: the scene builders default to
``device="cuda"``, and a CPU caller passes ``device="cpu"``. The command
line runs on the CPU where ``RTT_PLATFORM=cpu`` is set (the reference's
switch), and the viewer on its scene's device.

Quick start:
    >>> import ray_tracer_tpu_torch as rt
    >>> scene, cam = rt.builtin_scene("metal", aspect=1.0)
    >>> img = rt.render(scene, cam, rt.RenderParams(width=256, height=256,
    ...                                             skybox=True), frames=8)

``backend="auto"`` runs the kernel for a scene on a CUDA device and the
plain PyTorch oracle for a scene on the CPU.
"""

from . import grad, io, lights, models
from .camera import (Camera, CameraBasis, CameraController, camera_basis,
                     camera_basis_tensor, camera_rays, update_camera)
from .denoise import denoise, denoise_render
from .io import MeshData, load_glb, load_gltf, load_meshes, load_model, load_obj
from .ops.intersect import occluded
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
    "Camera", "CameraBasis", "CameraController", "camera_basis",
    "camera_basis_tensor", "camera_rays", "update_camera",
    "Renderer", "accumulate", "render", "render_adaptive", "render_aov",
    "render_frame", "render_pixels", "render_progressive", "trace",
    "denoise",
    "Scene", "SceneBuilder", "builtin_scene", "scene_balls",
    "scene_from_numpy", "scene_metal", "scene_random_balls", "scene_room",
    "BUILTIN_SCENES", "SCENE_IDS", "RenderParams", "grad", "io", "lights",
    "models", "occluded",
    "MeshData", "load_obj", "load_gltf", "load_glb", "load_meshes",
    "load_model",
]
