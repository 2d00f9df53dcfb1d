#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths (``ray_tracer_tpu_torch``) once each,
through the entry points a user calls, and checks them: the forward render
path (phase 3) and the training path (phase 5). It imports nothing of JAX.
Phases, each printing one line (phase 1 one per kernel):

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. builds both kernels from the repository's sources, one nvcc each,
     started together, and prints ptxas's registers and spills;
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
     (median and best of 5 renders); the scatter-add kernel must not
     launch on this forward path;
  2b. (run before 3) the scatter-add kernel vs its plain version
     (``index_add_``) on the card, on the 1080p terrain primary
     wavefront's winner ids in the blocked pixel order (misses routed to
     the dropped id) with seeded random cotangents (26, R): all lanes,
     about 5% of lanes live, no lane live, and the row-major (R, 26) form;
     each entry within 1e-5 of the plain value plus 1e-6 of the sum of
     |g| over the lanes it adds up; kernel and plain ms at 1080p, and
     whether two kernel runs were bit-equal;
  4. path parity: one 256x144 frame through the kernel and through the
     plain oracle (backend "torch") on the same CUDA tensors; the fraction
     of pixels off by more than 2e-2 must be below 2e-3;
  5. the training path: ``grad.make_train_step`` over
     ``DEFAULT_TRAINABLE`` (Adam, 1e-2 on the albedos and 1e-4 on the
     geometry: ``train_optimizer``) at the main path's settings (terrain
     1920x1080, bounces=3), from the scene with its albedos scaled by 0.8
     towards the same frame of the true scene; one warm-up step and 5
     timed steps. Each step
     must launch the closest-hit and the scatter-add kernel bounces + 1
     times each, every gradient must be finite, tri_v0's and tri_albedo's
     not all zero, and the last loss below the first. Prints s/step
     (median and spread, CUDA events), forward+backward segments/s, peak
     device memory, and the host's enqueue time against the device time;
  6. gradient parity: a whole-frame MSE gradient over every float scene
     leaf of a 256x144 terrain frame through the kernels (backend "cuda")
     and through the plain oracle (backend "torch") on the same CUDA
     tensors; the images must be equal, and per leaf max |diff| <= 1e-4 x
     that leaf's max |g|.

Then it prints the kernels' JSON line and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. ``--profile`` adds measurements: where one main-path
frame's time goes (torch.profiler), for terrain and for the room scene at
the same settings, and where one training step's time goes. ``--out DIR``
writes a 4x-downsampled main-path image (``chip_smoke_terrain.npy``) and,
with ``--profile``, the profiler tables (``chip_smoke_profile_<name>.txt``)
into DIR; without it nothing is written.

Usage: python3 chip_smoke.py [--profile] [--out DIR]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch import sampling
from ray_tracer_tpu_torch.grad import DEFAULT_TRAINABLE, make_train_step
from ray_tracer_tpu_torch.ops import closest_hit as ch
from ray_tracer_tpu_torch.ops import scatter_rows as sc
from ray_tracer_tpu_torch.renderer import (_blocked_ids, render_frame,
                                           render_progressive,
                                           resolved_backend)
from ray_tracer_tpu_torch.scene import TENSOR_FIELDS
from ray_tracer_tpu_torch.utils import build

W, H, FRAMES, BOUNCES = 1920, 1080, 8, 3
TRIALS = 5  # timed 8-frame renders of the main path
PARAMS = dict(width=W, height=H, bounces=BOUNCES, rays_per_pixel=1,
              skybox=True, coherent_scatter=True, coherent_tile=0,
              backend="auto")
PROBE_RAYS = 65_536
MAX_ID_MISMATCHES = 2
PARITY_TOL, PARITY_GATE = 2e-2, 2e-3
TRAIN_STEPS = 5        # timed training steps after one warm-up step
ALBEDO_START = 0.8     # the training start scales both albedos by this
ALBEDO_LR, GEOMETRY_LR = 1e-2, 1e-4   # Adam rates of the training phase
ALBEDOS = ("sphere_albedo", "tri_albedo")
# scatter gate: |kernel - plain| <= RTOL |plain| + ATOL sum|g| per entry,
# the sum of |g| over the lanes the entry adds up: two f32 sums of the same
# n values in different orders differ by up to ~n u sum|g| (u = 6e-8), and
# on the 1080p terrain a sphere's entries sum ~1e5 lanes
SCATTER_RTOL, SCATTER_ATOL = 1e-5, 1e-6
GRAD_PARITY = 1e-4     # per leaf, x that leaf's max |g|
# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "closest_hit": ("ray_tracer_tpu_torch/csrc/closest_hit.cu",
                    "ray_tracer_tpu/ops/pallas_intersect.py:531"),
    "scatter_rows": ("ray_tracer_tpu_torch/csrc/scatter_rows.cu",
                     "ray_tracer_tpu/ops/pallas_intersect.py:1784"),
}


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        paths = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name in KERNELS:
        build.load(name)
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text() if path.with_suffix(
            ".log").exists() else ""
        ptxas = " / ".join(ln.split("ptxas info    : ")[-1] for ln in
                           log.splitlines() if "Used" in ln or "spill" in ln)
        print(f"phase 1 build: {path.name} ({len(paths)} built together in "
              f"{secs:.2f} s) | {ptxas}", flush=True)


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
    sc.scatter_rows_soa.launches = 0
    img, secs, enqueue_s = timed_render(scene, basis, params, FRAMES)
    launches = ch.nearest_hit_attrs.launches
    want = FRAMES * (BOUNCES + 1)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if sc.scatter_rows_soa.launches:
        raise AssertionError("the forward path launched the scatter-add "
                             "kernel")
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


def primary_wavefront(scene, cam, device):
    """The main path's 1080p primary rays, in render_frame's blocked pixel
    order (the order the backward's scatter sees)."""
    basis = rt.camera_basis(cam).to(device)
    ids, _ = _blocked_ids(W, H, device)
    _, o, d = rt.camera_rays(basis, ids % W, ids // W, (W, H),
                             sampling.seed_state(ids, 0))
    return o, d


def phase2b_scatter_vs_plain(device, terrain):
    scene, cam = terrain
    o, d = primary_wavefront(scene, cam, device)
    t, pid = ch.nearest_hit_attrs(scene, o, d, 1e-4, want_attrs=False)
    n_rows = scene.padded_spheres + scene.padded_tris
    R = W * H
    ids = torch.where(torch.isinf(t), n_rows, pid)
    gen = torch.Generator(device=device).manual_seed(0)
    g = torch.randn((26, R), generator=gen, device=device)
    sparse = torch.where(torch.rand(R, generator=gen, device=device) < 0.05,
                         ids, n_rows)
    all_miss = torch.full_like(ids, n_rows)
    cases = {"dense": (sc.scatter_rows_soa, ids, g),
             "sparse": (sc.scatter_rows_soa, sparse, g),
             "all-miss": (sc.scatter_rows_soa, all_miss, g),
             "row-major": (sc.scatter_rows, ids, g.T.contiguous())}
    report, max_err = [], 0.0
    for label, (fn, case_ids, case_g) in cases.items():
        got = fn(case_ids, case_g, n_rows)
        want = sc.scatter_rows_soa_reference(case_ids, g, n_rows)
        mass = sc.scatter_rows_soa_reference(case_ids, g.abs(), n_rows)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        if bool((diff > SCATTER_RTOL * want.abs()
                 + SCATTER_ATOL * mass).any()):
            raise AssertionError(f"scatter {label}: max |diff| {err} "
                                 f"(max |plain| {float(want.abs().max())})")
        max_err = max(max_err, err)
        live = int((case_ids < n_rows).sum())
        rel = float((diff / mass.clamp(min=1e-30)).max())
        report.append(f"{label} {live} live lanes max |diff| {err} (max "
                      f"|diff| / sum|g| {rel:.3g})")
    again = [sc.scatter_rows_soa(ids, g, n_rows) for _ in range(2)]
    bit_equal = torch.equal(again[0], again[1])
    del again
    ms = cuda_ms(lambda: sc.scatter_rows_soa(ids, g, n_rows), 20)
    plain_ms = cuda_ms(lambda: sc.scatter_rows_soa_reference(ids, g, n_rows),
                       5)
    print(f"phase 2b scatter-add vs plain (terrain {W}x{H} primary winners, "
          f"{n_rows} rows x 26): " + "; ".join(report)
          + f" | dense 1080p: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"two kernel runs bit-equal: {bit_equal}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err)


def phase5_training(device, terrain, card, profile, out_dir):
    scene, cam = terrain
    params = rt.RenderParams(**PARAMS)
    basis = rt.camera_basis(cam)
    with torch.no_grad():  # the same frame, so the same sample streams
        target = render_frame(scene, basis, params, 0)
    start = dataclasses.replace(
        scene, tri_albedo=scene.tri_albedo * ALBEDO_START,
        sphere_albedo=scene.sphere_albedo * ALBEDO_START)
    init_fn, step_fn = make_train_step(params, train_optimizer)
    trainable, opt = init_fn(start, DEFAULT_TRAINABLE)
    per_step = BOUNCES + 1
    losses, device_s, host_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.nearest_hit_attrs.launches = 0
    sc.scatter_rows_soa.launches = 0
    for step in range(1 + TRAIN_STEPS):             # step 0 warms up
        before = (ch.nearest_hit_attrs.launches, sc.scatter_rows_soa.launches)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        trainable, opt, loss = step_fn(trainable, opt, start, basis, target,
                                       0)
        ev1.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        b1 = ch.nearest_hit_attrs.launches - before[0]
        b2 = sc.scatter_rows_soa.launches - before[1]
        if (b1, b2) != (per_step, per_step):
            raise AssertionError(f"step {step}: {b1} closest-hit and {b2} "
                                 f"scatter-add launches, want {per_step}")
        losses.append(float(loss))
        if step:
            device_s.append(ev0.elapsed_time(ev1) / 1e3)
            host_s.append(enqueue)
    launches = (ch.nearest_hit_attrs.launches, sc.scatter_rows_soa.launches)
    peak = torch.cuda.max_memory_allocated()
    for k, p in trainable.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"gradient of {k} is missing or not finite")
    for k in ("tri_v0", "tri_albedo"):
        if not bool(trainable[k].grad.any()):
            raise AssertionError(f"gradient of {k} is all zero")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    med = float(np.median(device_s))
    segs = W * H * 1 * (BOUNCES + 1)
    print(f"phase 5 training path: terrain {W}x{H} b{BOUNCES} Adam "
          f"({ALBEDO_LR} albedos, {GEOMETRY_LR} geometry) over "
          f"{len(trainable)} leaves, whole-frame gradient: {med:.4f} s/step median "
          f"({len(device_s)} steps {[round(x, 4) for x in device_s]} s, "
          f"spread {(max(device_s) - min(device_s)) / min(device_s):.2%}), "
          f"{segs / med / 1e6:.3f} M segments/s forward+backward; peak "
          f"memory {peak / 2 ** 30:.3f} GiB; host enqueue "
          f"{float(np.median(host_s)):.4f} s vs device {med:.4f} s per step; "
          f"{launches[0]} closest-hit + {launches[1]} scatter-add launches "
          f"({per_step} + {per_step} per step); loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} | {card}", flush=True)
    if profile:
        profile_step(step_fn, trainable, opt, start, basis, target, med,
                     out_dir)
    return launches[1]


def train_optimizer(leaves):
    """Adam over DEFAULT_TRAINABLE's leaves (in that order): the default
    rate 1e-2 on the albedos, 1e-4 on the geometry. The target is the true
    scene, so its geometry is already right, and the interior gradient does
    not see the silhouettes a move shifts. On an H100 at this phase's
    settings, Adam 1e-2 on every leaf raised the loss from 7.76e-4 to
    2.00e-3 in one step; 1e-3 on the geometry lowered it for four steps
    and then raised it again."""
    names = dict(zip(DEFAULT_TRAINABLE, leaves))
    return torch.optim.Adam([
        {"params": [names[k] for k in ALBEDOS], "lr": ALBEDO_LR},
        {"params": [v for k, v in names.items() if k not in ALBEDOS],
         "lr": GEOMETRY_LR}])


def profile_step(step_fn, trainable, opt, scene, basis, target, step_s,
                 out_dir):
    """Where one training step's time goes (measurement only): its device
    kernels under torch.profiler against the step's median device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step_fn(trainable, opt, scene, basis, target, 0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)

    def us(key):
        return [e.time_range.elapsed_us() for e in kernels if key in e.name]

    hit_us, scatter_us = us("closest_hit"), us("scatter_rows")
    if out_dir:
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(os.path.join(out_dir, "chip_smoke_profile_train.txt"),
                  "w") as f:
            f.write(table)
    print(f"profile: training step {len(kernels)} device kernels busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e6 / step_s:.1%} of the "
          f"median step's {step_s * 1e3:.3f} ms); closest_hit {hit_us} us, "
          f"scatter_rows {scatter_us} us "
          f"({(sum(hit_us) + sum(scatter_us)) / max(busy_us, 1):.1%} of "
          f"device time)", flush=True)


def phase6_grad_parity(device, terrain):
    scene, cam = terrain
    basis = rt.camera_basis(cam.replace(aspect=256 / 144))
    params = rt.RenderParams(**dict(PARAMS, width=256, height=144))
    fields = [k for k in TENSOR_FIELDS
              if getattr(scene, k).is_floating_point()]
    with torch.no_grad():
        target = 0.5 * render_frame(scene, basis, params, 1)
    out = {}
    for backend in ("cuda", "torch"):
        leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                  for k in fields}
        img = render_frame(dataclasses.replace(scene, **leaves), basis,
                           params.replace(backend=backend), 0)
        loss = torch.mean((img - target) ** 2)
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        out[backend] = (img.detach(), {
            k: torch.zeros_like(leaves[k]) if gk is None else gk
            for k, gk in zip(fields, g)})
    (img_k, g_k), (img_p, g_p) = out["cuda"], out["torch"]
    if not torch.equal(img_k, img_p):
        raise AssertionError("gradient parity: the two images differ by "
                             f"{float((img_k - img_p).abs().max())}")
    worst, worst_leaf, nonzero = 0.0, None, 0
    for k in fields:
        scale = float(g_p[k].abs().max())
        err = float((g_k[k] - g_p[k]).abs().max())
        if err > GRAD_PARITY * scale:
            raise AssertionError(f"gradient parity: {k} differs by {err} "
                                 f"(max |g| {scale})")
        nonzero += scale > 0
        if scale and err / scale >= worst:
            worst, worst_leaf = err / scale, k
    print(f"phase 6 gradient parity (terrain 256x144 b{BOUNCES}, cuda vs "
          f"torch, {len(fields)} float leaves, {nonzero} with a gradient): "
          f"images equal; largest max |diff| / max |g| {worst:.3g} "
          f"({worst_leaf}; gate {GRAD_PARITY})", flush=True)


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
    timing = {"closest_hit": phase2_kernel_vs_plain(device, terrain),
              "scatter_rows": phase2b_scatter_vs_plain(device, terrain)}
    launches = {"closest_hit": phase3_main_path(device, terrain, card,
                                                args.profile, args.out)}
    phase4_parity(device, terrain)
    launches["scatter_rows"] = phase5_training(
        device, terrain, card, args.profile, args.out)
    torch.cuda.empty_cache()
    phase6_grad_parity(device, terrain)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": timing[name]["max_abs_err"],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
