"""Command-line interface: render / view / invert / benchmark / info.

Port of ``ray_tracer_tpu.cli`` with its subcommands and flags. Scenes are
the four built-ins by name or id, or model files loaded into a studio
scene.

    python -m ray_tracer_tpu_torch render --scene metal --frames 64 -o out.png
    python -m ray_tracer_tpu_torch render --model teapot.glb -o teapot.png
    python -m ray_tracer_tpu_torch benchmark --scene room --width 800 --height 800
    torchrun --standalone --nproc_per_node 4 -m ray_tracer_tpu_torch render

Differences from the reference:

  * everything runs on the card, or on the CPU where the environment sets
    ``RTT_PLATFORM=cpu`` (the reference's switch, read when a command
    runs); with neither available a command raises;
  * ``--backend`` takes the port's values (auto|torch|cuda);
  * times wait for the device before the clock is read;
  * ``render --aov`` writes its PNG with the port's codec (no Pillow);
  * under ``torchrun`` (its environment set) ``render`` joins the
    process group (NCCL on cards, gloo where ``RTT_PLATFORM=cpu``), each
    rank renders its share of the pixels on its own card
    (``parallel.progressive``) and rank 0 writes the same image as one
    process would;
  * ``--resilient`` keeps one host-side safe point per chunk of frames
    (8 frames of a batch render, 16 of an adaptive one), with no retry (a
    local card has no relay to retry, ROADMAP D4); with ``--checkpoint``
    a batch render writes the checkpoint at each safe point.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from . import Camera, RenderParams, Renderer, SceneBuilder, builtin_scene
from .camera import camera_basis
from .io import load_model, write_npy, write_png
from .utils.config import BACKENDS
from .utils.metrics import StageTimer

SAFE_POINT_FRAMES = 8   # frames between --resilient's safe points


def _positive_int(s):
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def platform_device() -> torch.device:
    """The device commands run on: the CPU where ``RTT_PLATFORM=cpu``,
    else the card; raises where that is not available."""
    if os.environ.get("RTT_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: set RTT_PLATFORM=cpu to run "
                           "on the CPU")
    return torch.device("cuda")


def _add_common(p):
    p.add_argument("--scene", default="balls",
                   help="builtin scene name or id (balls|random_balls|room|metal|0-3)")
    p.add_argument("--model", default=None, action="append",
                   help="OBJ/glTF/GLB file rendered in a studio scene "
                        "instead; repeat to compose several models "
                        "(placed side by side, the reference loader's "
                        "multi-model convention)")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--rays-per-pixel", type=int, default=1)
    p.add_argument("--skybox", action="store_true")
    p.add_argument("--no-accumulate", action="store_true")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS))
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (explicit light sampling)")
    p.add_argument("--no-mis", action="store_true",
                   help="disable balance-heuristic MIS for the NEE<->BSDF "
                        "estimator pair (pure emission suppression)")
    p.add_argument("--cosine-sampling", action="store_true",
                   help="cosine-weighted Lambertian sampling")
    p.add_argument("--compaction", action="store_true",
                   help="wavefront ray sorting between bounces")
    p.add_argument("--coherent", action="store_true",
                   help="coherent path tracing: one shared diffuse-lobe "
                        "draw per share tile of rays per bounce")
    p.add_argument("--qmc", action="store_true",
                   help="low-discrepancy (R2) anti-aliasing jitter")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="clamp per-sample radiance (firefly suppression; "
                        "0 = off)")
    p.add_argument("--rr", type=int, default=0, metavar="N",
                   help="Russian roulette from bounce N (0 = off)")
    p.add_argument("--chunk-pixels", type=int, default=0)
    p.add_argument("--seed", type=int, default=0, help="random_balls scene seed")
    p.add_argument("--aperture", type=float, default=None,
                   help="thin-lens aperture (depth of field)")
    p.add_argument("--focus-dist", type=float, default=None,
                   help="focal-plane distance")


def _build(args):
    """(scene, camera, params) from the common flags, on the platform's
    device."""
    device = platform_device()
    params = RenderParams(
        width=args.width, height=args.height, bounces=args.bounces,
        rays_per_pixel=args.rays_per_pixel, skybox=args.skybox,
        accumulate=not args.no_accumulate, backend=args.backend,
        chunk_pixels=args.chunk_pixels, nee=args.nee,
        mis=not args.no_mis,
        cosine_sampling=args.cosine_sampling, compaction=args.compaction,
        coherent_scatter=args.coherent, clamp=args.clamp, qmc=args.qmc,
        rr_start=args.rr)
    if args.model:
        b = SceneBuilder()
        # one model centres at the origin; several compose side by side
        placement = "origin" if len(args.model) == 1 else "reference"
        for path in args.model:
            load_model(path, b, placement=placement)
        lo, hi = b.bounds()
        scene = b.build(device=device)
        center, extent = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
        cam = Camera(origin=tuple(center + extent * np.array([0.8, 0.5, 0.8])),
                     look_at=tuple(center), aspect=params.aspect,
                     focus_dist=1.0)
    else:
        name = int(args.scene) if args.scene.isdigit() else args.scene
        kw = {"seed": args.seed} if name in ("random_balls", 1) else {}
        try:
            scene, cam = builtin_scene(name, aspect=params.aspect,
                                       device=device, **kw)
        except KeyError:
            raise ValueError(
                f"unknown scene {args.scene!r} (choose "
                "balls|random_balls|room|metal or id 0-3)") from None
    if args.aperture is not None:
        cam = cam.replace(aperture=args.aperture)
    if args.focus_dist is not None:
        cam = cam.replace(focus_dist=args.focus_dist)
    return scene, cam, params


def _write_aov(path: str, img: np.ndarray, aov: str) -> None:
    """An AOV as a viewable PNG: depth divided by its maximum, normals
    remapped to [0, 1], one channel repeated to three; row 0 at the
    bottom, as the renderer's images."""
    from .io.png import encode_png
    if aov == "depth":
        img = img / max(float(img.max()), 1e-12)
    elif aov == "normal":
        img = img * 0.5 + 0.5
    rgb = np.broadcast_to(img, img.shape[:2] + (3,))[::-1]
    rgb = (np.clip(rgb, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _render_batch(r: Renderer, args, basis):
    """A fresh accumulation of ``args.frames`` frames; with
    ``--resilient`` in chunks of SAFE_POINT_FRAMES, the image copied to
    the host after each (and the checkpoint written there)."""
    from .renderer import render_progressive
    scene, params = r.scene, r.params
    if not args.resilient:
        img = render_progressive(scene, basis, params, args.frames)
        r._image, r.frames = img, args.frames - 1
        return img
    from .utils.checkpoint import save_renderer
    img, done = None, 0
    while done < args.frames:
        k = min(SAFE_POINT_FRAMES, args.frames - done)
        img = render_progressive(scene, basis, params, k, start_frame=done,
                                 image0=img, resilient=True)
        done += k
        r._image, r.frames = img, done - 1
        if args.checkpoint:
            save_renderer(args.checkpoint, r)
    return img


def _write_image(st: StageTimer, path: str, img) -> None:
    """The rendered image to ``path`` (.npy raw, else PNG), timed as the
    ``io`` stage."""
    with st.stage("io"):
        if path.endswith(".npy"):
            write_npy(path, img)
        else:
            write_png(path, img)
    st.log()
    print(f"wrote {path}", file=sys.stderr)


# render's flags that a run over several ranks does not take
_RANKS_REFUSE = ("aov", "resume", "checkpoint", "resilient", "adaptive",
                 "denoise", "no_accumulate")


def _render_ranks(args):
    """``render`` as one rank of a process group (under ``torchrun``):
    the scene on this rank's device, the frames over every rank
    (``parallel.progressive``), and rank 0 alone writing the image, which
    is the one-process command's."""
    import torch.distributed as dist
    from .parallel.progressive import render_progressive_distributed
    refused = [f"--{k.replace('_', '-')}" for k in _RANKS_REFUSE
               if getattr(args, k)]
    if refused:
        raise ValueError(f"{', '.join(refused)}: not taken by a render "
                         f"over several ranks")
    st = StageTimer()
    with st.stage("build"):
        scene, cam, params = _build(args)
        basis = camera_basis(cam.replace(aspect=params.aspect))
    with st.stage("render"), torch.no_grad():
        img = render_progressive_distributed(scene, basis, params,
                                             args.frames)
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()
    if rank:
        return
    dt = st.totals["render"]
    print(f"rendered {args.frames} frame(s) at {params.width}x"
          f"{params.height} on {world} ranks in {dt:.2f}s "
          f"({args.frames / dt:.2f} fps)", file=sys.stderr)
    _write_image(st, args.output, img)


def cmd_render(args):
    if "WORLD_SIZE" in os.environ:
        # started by torchrun: join its process group where its whole
        # environment is there
        from .parallel import distributed
        if distributed.initialize(device=platform_device()):
            return _render_ranks(args)
    st = StageTimer()
    if args.aov:
        from .renderer import render_aov
        scene, cam, params = _build(args)
        img = render_aov(scene, camera_basis(cam.replace(
            aspect=params.aspect)), params, args.aov).cpu().numpy()
        if args.output.endswith(".npy"):
            write_npy(args.output, img)
        else:
            _write_aov(args.output, img, args.aov)
        print(f"wrote {args.aov} AOV to {args.output}")
        return
    with st.stage("build"):
        scene, cam, params = _build(args)
        if args.resume:
            from .utils.checkpoint import load_renderer
            r = load_renderer(args.resume, scene)
        else:
            r = Renderer(scene, cam, params)
    with st.stage("render"), torch.no_grad():
        basis = camera_basis(r.camera)
        fresh = r.frames == -1 and params.accumulate
        if args.adaptive and fresh:
            from .renderer import render_adaptive
            img, used = render_adaptive(scene, basis, params, args.frames,
                                        target_rel_std=args.adaptive,
                                        resilient=args.resilient)
            r._image, r.frames = img, used - 1
            print(f"adaptive: converged after {used}/{args.frames} frames",
                  file=sys.stderr)
        elif args.frames > 1 and fresh:
            img = _render_batch(r, args, basis)
        else:
            if args.resilient:
                logging.getLogger("ray_tracer_tpu_torch.cli").warning(
                    "--resilient only keeps safe points where frames go in "
                    "chunks: the batch and adaptive paths (frames > 1, "
                    "fresh accumulation, accumulate on)")
            for _ in range(args.frames):
                img = r.step()
        if args.denoise:
            from .denoise import denoise_render
            img = denoise_render(scene, basis, params, img,
                                 iterations=args.denoise)
    dt = st.totals["render"]
    if args.checkpoint:
        from .utils.checkpoint import save_renderer
        with st.stage("checkpoint"):
            save_renderer(args.checkpoint, r)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    n_frames = r.frames + 1 if params.accumulate else args.frames
    print(f"rendered {n_frames} frame(s) at {params.width}x{params.height} "
          f"in {dt:.2f}s ({n_frames / dt:.2f} fps)", file=sys.stderr)
    _write_image(st, args.output, img)


def _timed(fn, device) -> float:
    """Seconds of fn(), the device's work included."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def cmd_benchmark(args):
    from .renderer import render_progressive

    scene, cam, params = _build(args)
    basis = camera_basis(cam.replace(aspect=params.aspect))

    def run():
        with torch.no_grad():
            render_progressive(scene, basis, params, args.frames)

    run()                                   # warm-up: kernels, planes
    dt = min(_timed(run, scene.device) for _ in range(2))
    segments = (params.width * params.height * params.rays_per_pixel
                * (params.bounces + 1) * args.frames)
    print(json.dumps({
        "metric": "rays/s", "value": segments / dt, "unit": "ray segments/s",
        "frames": args.frames, "seconds": dt, "fps": args.frames / dt,
        "resolution": f"{params.width}x{params.height}",
        "spheres": scene.num_spheres, "tris": scene.num_tris,
        "device": str(scene.device),
    }))


def cmd_view(args):
    from .scene import SCENE_IDS
    from .viewer import view
    scene, cam, params = _build(args)
    ids = {name: i for i, name in SCENE_IDS.items()}
    sid = (None if args.model else int(args.scene) if args.scene.isdigit()
           else ids[args.scene])
    view(scene, cam, params, scene_id=sid, max_frames=args.max_frames)


def cmd_invert(args):
    """Inverse rendering demo: perturb the scene's sphere albedos, then
    recover them from a rendered target by gradient descent."""
    from .grad import make_train_step
    from .renderer import render_frame

    scene, cam, params = _build(args)
    basis = camera_basis(cam.replace(aspect=params.aspect))
    with torch.no_grad():
        target = render_frame(scene, basis, params, 0)

    rng = np.random.default_rng(0)
    # a dielectric's albedo is forced white in shading: it cannot affect
    # the image, so it is left out of the recovery
    valid = ((scene.sphere_valid > 0.5)
             & (scene.sphere_smoothness >= 0.0)).cpu().numpy()
    true_np = scene.sphere_albedo.cpu().numpy()
    wrong_np = true_np.copy()
    wrong_np[valid] = np.clip(
        wrong_np[valid] + rng.normal(0, 0.25, (valid.sum(), 3)), 0.05, 0.95)
    start = dataclasses.replace(scene, sphere_albedo=torch.as_tensor(
        wrong_np, dtype=torch.float32, device=scene.device))

    init_fn, step_fn = make_train_step(
        params, lambda p: torch.optim.Adam(p, lr=args.lr),
        edge_samples=args.edge_samples)
    trainable, opt_state = init_fn(start, fields=("sphere_albedo",))
    t0 = time.perf_counter()
    for i in range(args.steps):
        trainable, opt_state, loss = step_fn(
            trainable, opt_state, start, basis, target, 0)
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:4d}  loss {float(loss):.6f}", file=sys.stderr)
    got = trainable["sphere_albedo"].detach().cpu().numpy()
    err = float(np.abs(got[valid] - true_np[valid]).max())
    print(json.dumps({
        "steps": args.steps, "seconds": round(time.perf_counter() - t0, 2),
        "final_loss": float(loss), "max_albedo_error": err,
        "recovered": err < 0.1,
    }))


def cmd_info(args):
    n = torch.cuda.device_count()
    try:
        default = str(platform_device())
    except RuntimeError as exc:
        default = f"none ({exc})"
    print(json.dumps({
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        "default_device": default,
    }, indent=2))


def make_parser() -> argparse.ArgumentParser:
    """The command line's parser: every subcommand and its flags."""
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu_torch")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="INFO logging: loader warnings, per-stage timings")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG/NPY")
    _add_common(p)
    p.add_argument("--frames", type=_positive_int, default=1,
                   help="progressive frames to accumulate (>= 1)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--checkpoint", default=None,
                   help="save accumulation state to this .npz when done")
    p.add_argument("--resume", default=None,
                   help="resume accumulation from a checkpoint .npz")
    p.add_argument("--resilient", action="store_true",
                   help="host-side safe point per chunk of 8 frames "
                        "(written to --checkpoint when given); no retry")
    p.add_argument("--adaptive", type=float, default=None, metavar="REL",
                   help="adaptive sampling: stop when 99%% of pixels reach "
                        "this relative standard error of the mean "
                        "(--frames becomes the cap); e.g. 0.02")
    p.add_argument("--aov", default=None,
                   choices=["depth", "normal", "albedo", "hit"],
                   help="render a primary-ray AOV channel instead of the "
                        "beauty pass (.npy = raw values; .png = normalized "
                        "for viewing)")
    p.add_argument("--denoise", type=int, default=0, metavar="N",
                   help="apply N edge-avoiding a-trous filter iterations "
                        "guided by the normal/depth AOVs (0 = off)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive progressive viewer (GUI)")
    _add_common(p)
    p.add_argument("--max-frames", type=int, default=None)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("invert", help="inverse-rendering demo: recover sphere"
                       " albedos of a built-in scene from a target render")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--edge-samples", type=int, default=0,
                   help="edge-sampled visibility (silhouette) gradients per "
                        "family per step (0 = interior gradients only)")
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("benchmark", help="measure rays/s")
    _add_common(p)
    p.add_argument("--frames", type=_positive_int, default=8)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("info", help="print device info")
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.verbose:
        logging.basicConfig(
            level=logging.INFO,
            format="%(levelname)s %(name)s: %(message)s")
    try:
        args.fn(args)
    except (ValueError, FileNotFoundError, KeyError) as exc:
        # user-input errors (bad scene name, missing model file, invalid
        # RenderParams) get one line, not a traceback; real bugs and
        # device errors still propagate. -v for the traceback.
        if args.verbose:
            raise
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
