#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's forward render path (``ray_tracer_tpu_torch``) once,
through the entry points a user calls, and checks it. It imports nothing
of JAX. Phases, each printing one line:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. builds the closest-hit kernel from the repository's sources;
  2. kernel vs its plain PyTorch version on the card, 65,536 rays on each
     of room, metal, random_balls and terrain (camera + random rays, about
     half of them dead), both want_attrs variants: at most 2 id mismatches
     per scene, t and rows bit-equal where ids agree, dead and miss lanes
     (inf, 0, zero row); then both timed at the main path's shape (the
     1920x1080 primary wavefront on terrain);
  3. the main path: ``render_progressive`` of the terrain scene (15,842
     triangles, three spheres) at 1920x1080, bounces=3, rpp=1, skybox,
     coherent scatter with the 512-ray share tile, 8 frames, backend
     "auto" (which resolves to the kernel); the kernel's launch count must
     rise by exactly frames x (bounces + 1), the image must be finite and
     not constant; segments/s timed with CUDA events after a warm-up frame
     (median and best of 5 renders);
  4. path parity: one 256x144 frame through the kernel and through the
     plain oracle (backend "torch") on the same CUDA tensors; the fraction
     of pixels off by more than 2e-2 must be below 2e-3.

Then it prints the kernels' JSON line and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. ``--profile`` adds measurements: where one main-path
frame's time goes (torch.profiler), for terrain and for the room scene at
the same settings. ``--out DIR`` writes a 4x-downsampled main-path image
(``chip_smoke_terrain.npy``) and, with ``--profile``, the profiler tables
(``chip_smoke_profile_<scene>.txt``) into DIR; without it nothing is
written.

Usage: python3 chip_smoke.py [--profile] [--out DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch import sampling
from ray_tracer_tpu_torch.ops import closest_hit as ch
from ray_tracer_tpu_torch.renderer import (render_frame, render_progressive,
                                           resolved_backend)
from ray_tracer_tpu_torch.utils import build

W, H, FRAMES, BOUNCES = 1920, 1080, 8, 3
TRIALS = 5  # timed 8-frame renders of the main path
PARAMS = dict(width=W, height=H, bounces=BOUNCES, rays_per_pixel=1,
              skybox=True, coherent_scatter=True, coherent_tile=0,
              backend="auto")
PROBE_RAYS = 65_536
MAX_ID_MISMATCHES = 2
PARITY_TOL, PARITY_GATE = 2e-2, 2e-3
KERNEL_SOURCE = "ray_tracer_tpu_torch/csrc/closest_hit.cu"
REPLACES = "ray_tracer_tpu/ops/pallas_intersect.py:531"


def heightfield(n, extent, y0, rng):
    """(n-1)^2 * 2 smooth terrain triangles over [-extent, extent]^2
    (the procedural mesh of tools/bench_blocked.py)."""
    xs = np.linspace(-extent, extent, n)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    h = np.zeros_like(gx)
    for _ in range(6):  # a few random cosine waves
        kx, kz = rng.normal(size=2) * (2.5 / extent)
        h += rng.random() * np.cos(kx * gx + kz * gz + rng.random() * 6.28)
    h = y0 + h * (extent * 0.02)
    verts = np.stack([gx, h, gz], -1).reshape(-1, 3)
    dhdx = np.gradient(h, xs, axis=0)
    dhdz = np.gradient(h, xs, axis=1)
    nrm = np.stack([-dhdx, np.ones_like(h), -dhdz], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normals = nrm.reshape(-1, 3)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = (i[:-1, :-1].ravel(), i[1:, :-1].ravel(),
                  i[:-1, 1:].ravel(), i[1:, 1:].ravel())
    idx = np.concatenate([np.stack([a, b, c], -1),
                          np.stack([b, d, c], -1)]).reshape(-1)
    return verts, normals, idx


def terrain_scene(device, n=90, aspect=W / H):
    """Terrain of 2 (n-1)^2 triangles (15,842 at n=90) with the metal
    scene's glass, diffuse and glossy spheres resting on it."""
    verts, normals, idx = heightfield(n, 4.0, -1.0, np.random.default_rng(0))
    # heightfield's winding faces -y and the intersection culls back faces:
    # reverse it so the terrain faces the camera above it
    idx = idx.reshape(-1, 3)[:, ::-1].reshape(-1)
    b = rt.SceneBuilder()
    b.add_mesh(verts, normals, idx, albedo=(0.7, 0.5, 0.3), smoothness=0.3)
    for x, albedo, smooth in ((-1.2, (0.8, 0.8, 0.8), -1.0),
                              (0.0, (0.7, 0.3, 0.3), 0.0),
                              (1.2, (0.8, 0.6, 0.2), 0.15)):
        near = np.hypot(verts[:, 0] - x, verts[:, 2]) <= 0.5 + 8.0 / (n - 1)
        y = float(verts[near, 1].max()) + 0.5
        b.add_sphere((x, y, 0.0), 0.5, albedo, (0.0, 0.0, 0.0), 0.0, smooth)
    cam = rt.Camera(origin=(0.0, 1.5, 6.0), look_at=(0.0, -0.8, 0.0),
                    fov=45.0, aspect=aspect)
    return b.build(device=device), cam


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase0_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    # fp32 stays fp32: no TF32 anywhere on the path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {card} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    return card


def phase1_build():
    t0 = time.perf_counter()
    path = build.build("closest_hit")
    build.load("closest_hit")
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(
        ".log").exists() else ""
    ptxas = " / ".join(ln.split("ptxas info    : ")[-1] for ln in
                       log.splitlines() if "Used" in ln or "spill" in ln)
    print(f"phase 1 build: {path.name} in {secs:.2f} s | {ptxas}",
          flush=True)


def probe_inputs(scene, cam, n, seed, device):
    """Half camera rays (the port's own camera_rays), half random rays;
    about half of all lanes dead."""
    g = np.random.default_rng(seed)
    k = n // 2
    basis = rt.camera_basis(cam).to(device)
    pix = torch.from_numpy(g.integers(0, 256 * 256, size=k)).to(device)
    state = torch.from_numpy(g.integers(0, 2 ** 32, size=k)).to(device)
    _, oc, dc = rt.camera_rays(basis, pix % 256, pix // 256, (256, 256),
                               state)
    orand = torch.from_numpy(g.normal(size=(n - k, 3)) * 5).float()
    drand = torch.from_numpy(g.normal(size=(n - k, 3))).float()
    o = torch.cat([oc, orand.to(device)]).contiguous()
    d = torch.cat([dc, drand.to(device)]).contiguous()
    alive = torch.from_numpy(g.random(n) < 0.5).to(device)
    return o, d, alive


def compare(got, ref, alive, label):
    """Kernel vs plain outputs → (id mismatches, max |t| difference on
    agreeing hit lanes). Raises on any breach of the contract."""
    t_k, id_k = got[0], got[1]
    t_r, id_r = ref[0], ref[1]
    # a lane agrees when both ids and both hit flags do (a miss has id 0,
    # as a hit on primitive 0 has)
    same = (id_k == id_r) & (torch.isinf(t_k) == torch.isinf(t_r))
    mism = int((~same).sum())
    if mism > MAX_ID_MISMATCHES:
        raise AssertionError(f"{label}: {mism} id mismatches")
    if not torch.equal(t_k[same], t_r[same]):
        raise AssertionError(f"{label}: t differs where ids agree")
    if len(got) == 3 and not torch.equal(got[2][:, same], ref[2][:, same]):
        raise AssertionError(f"{label}: rows differ where ids agree")
    for t, ids, rows in ((t_k, id_k, got[2] if len(got) == 3 else None),
                         (t_r, id_r, ref[2] if len(ref) == 3 else None)):
        miss = torch.isinf(t)
        if bool((~miss & ~alive).any()):
            raise AssertionError(f"{label}: a dead lane hit")
        if bool((ids[miss] != 0).any()) or (
                rows is not None and bool(rows[:, miss].any())):
            raise AssertionError(f"{label}: miss lane not (inf, 0, 0-row)")
    hit = same & ~torch.isinf(t_k)
    err = float((t_k[hit] - t_r[hit]).abs().max()) if bool(hit.any()) else 0.0
    return mism, err, int(hit.sum())


def phase2_kernel_vs_plain(device, terrain):
    scenes = {name: rt.builtin_scene(name, aspect=W / H, device=device)
              for name in ("room", "metal", "random_balls")}
    scenes["terrain"] = terrain
    counts, max_err = [], 0.0
    for si, (name, (scene, cam)) in enumerate(scenes.items()):
        o, d, alive = probe_inputs(scene, cam, PROBE_RAYS, si, device)
        for want_attrs in (True, False):
            got = ch.nearest_hit_attrs(scene, o, d, 1e-4, alive, want_attrs)
            ref = ch.nearest_hit_attrs_reference(scene, o, d, 1e-4, alive,
                                                 want_attrs)
            torch.cuda.synchronize()
            mism, err, hits = compare(got, ref, alive,
                                      f"{name} attrs={want_attrs}")
            max_err = max(max_err, err)
            counts.append(f"{name}{'' if want_attrs else '/ids'} "
                          f"{mism} mism {hits} hits")
        if name == "terrain":
            k_ms = cuda_ms(lambda: ch.nearest_hit_attrs(
                scene, o, d, 1e-4, alive), 20)
            p_ms = cuda_ms(lambda: ch.nearest_hit_attrs_reference(
                scene, o, d, 1e-4, alive), 2)
    print(f"phase 2 kernel vs plain ({PROBE_RAYS} rays): "
          + "; ".join(counts)
          + f" | terrain 65536 rays: kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms", flush=True)

    # the main path's shape: the 1920x1080 primary wavefront on terrain
    scene, cam = terrain
    basis = rt.camera_basis(cam).to(device)
    ids = torch.arange(W * H, device=device)
    state = sampling.seed_state(ids, 0)
    _, o, d = rt.camera_rays(basis, ids % W, ids // W, (W, H), state)
    alive = torch.ones(W * H, dtype=torch.bool, device=device)
    got = ch.nearest_hit_attrs(scene, o, d, 1e-4, alive)
    ref = ch.nearest_hit_attrs_reference(scene, o, d, 1e-4, alive)
    mism, err, hits = compare(got, ref, alive, "terrain 1080p primary")
    max_err = max(max_err, err)
    del got, ref
    ms = cuda_ms(lambda: ch.nearest_hit_attrs(scene, o, d, 1e-4, alive), 20)
    plain_ms = cuda_ms(lambda: ch.nearest_hit_attrs_reference(
        scene, o, d, 1e-4, alive), 1)
    print(f"phase 2 main-path shape (terrain, {W}x{H} primary rays, "
          f"{hits} hits, {mism} mism): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, max |dt| {err}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err)


def timed_render(scene, basis, params, frames):
    """(image, device seconds, host seconds to enqueue) of one
    render_progressive call, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    img = render_progressive(scene, basis, params, frames)
    stop.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return img, start.elapsed_time(stop) / 1e3, enqueue_s


def phase3_main_path(device, terrain, card, profile, out_dir):
    scene, cam = terrain
    params = rt.RenderParams(**PARAMS)
    if resolved_backend(params, scene) != "cuda":
        raise AssertionError("backend 'auto' did not resolve to cuda")
    basis = rt.camera_basis(cam)
    render_frame(scene, basis, params, 0)            # warm-up frame
    torch.cuda.synchronize()
    ch.nearest_hit_attrs.launches = 0
    img, secs, enqueue_s = timed_render(scene, basis, params, FRAMES)
    launches = ch.nearest_hit_attrs.launches
    want = FRAMES * (BOUNCES + 1)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if img.shape != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("main-path image is not finite (H, W, 3)")
    if float(img.std()) < 1e-3:
        raise AssertionError("main-path image is constant")
    runs = [secs] + [timed_render(scene, basis, params, FRAMES)[1]
                     for _ in range(TRIALS - 1)]
    med, best = float(np.median(runs)), min(runs)
    segs = W * H * 1 * (BOUNCES + 1) * FRAMES
    print(f"phase 3 main path: terrain {scene.num_tris} tris {W}x{H} "
          f"b{BOUNCES} {FRAMES} frames: {segs / med / 1e6:.3f} M segments/s"
          f" median, {segs / best / 1e6:.3f} best ({len(runs)} runs "
          f"{[round(r, 4) for r in runs]} s, spread "
          f"{(max(runs) - best) / best:.2%}; host enqueue {enqueue_s:.4f} s "
          f"of the first), {launches} kernel launches, image mean "
          f"{float(img.mean()):.4f} | {card}", flush=True)
    if out_dir:
        np.save(os.path.join(out_dir, "chip_smoke_terrain.npy"),
                img[::4, ::4].cpu().numpy())
    if profile:
        profile_frame("terrain", scene, basis, params, out_dir)
        room, room_cam = rt.builtin_scene("room", aspect=W / H,
                                          device=device)
        room_basis = rt.camera_basis(room_cam)
        render_frame(room, room_basis, params, 0)
        _, room_s, _ = timed_render(room, room_basis, params, FRAMES)
        print(f"profile: room {W}x{H} {FRAMES} frames "
              f"{segs / room_s / 1e6:.3f} M segments/s", flush=True)
        profile_frame("room", room, room_basis, params, out_dir)
    return launches


def profile_frame(name, scene, basis, params, out_dir):
    """Where one main-path frame's time goes (measurement only): the
    frame's wall time with CUDA events, then the same frame under
    torch.profiler for the kernels' device times. With ``out_dir``, the
    profiler's table goes to chip_smoke_profile_<name>.txt there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    _, frame_s, _ = timed_render(scene, basis, params, 1)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        render_frame(scene, basis, params, 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    hit_us = [e.time_range.elapsed_us() for e in kernels
              if "closest_hit" in e.name]
    if out_dir:
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(os.path.join(out_dir, f"chip_smoke_profile_{name}.txt"),
                  "w") as f:
            f.write(table)
    print(f"profile: {name} frame {frame_s * 1e3:.3f} ms wall; "
          f"{len(kernels)} device kernels busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / frame_s:.1%} of the wall time); closest_hit "
          f"per bounce {hit_us} us ({sum(hit_us) / max(busy_us, 1):.1%} of "
          f"device time)", flush=True)


def phase4_parity(device, terrain):
    scene, cam = terrain
    basis = rt.camera_basis(cam.replace(aspect=256 / 144))
    params = rt.RenderParams(**dict(PARAMS, width=256, height=144))
    a = render_frame(scene, basis, params.replace(backend="cuda"), 0)
    b = render_frame(scene, basis, params.replace(backend="torch"), 0)
    off = float(((a - b).abs().amax(-1) > PARITY_TOL).float().mean())
    if not off < PARITY_GATE:
        raise AssertionError(f"path parity: {off} of pixels off")
    print(f"phase 4 path parity (terrain 256x144, cuda vs torch): "
          f"frac_off {off} (gate {PARITY_GATE}), max |diff| "
          f"{float((a - b).abs().max())}", flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also measure where a main-path frame's time goes")
    ap.add_argument("--out", metavar="DIR",
                    help="write the main-path image and profiler tables here")
    args = ap.parse_args(argv)
    card = phase0_device()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    phase1_build()
    terrain = terrain_scene(device)
    timing = phase2_kernel_vs_plain(device, terrain)
    launches = phase3_main_path(device, terrain, card, args.profile,
                                args.out)
    phase4_parity(device, terrain)
    print(json.dumps({"kernels": [{
        "name": "closest_hit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"]}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
