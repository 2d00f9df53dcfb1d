#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths (``ray_tracer_tpu_torch``) through the entry
points a user calls, and checks them: the forward render path (phase 3),
the training path (phase 5), the forward render with next-event estimation
(phase 7) and all three on a large scene through the streaming kernel
(phase 8). It imports nothing of JAX. Each path is driven with the
kernels' launch counts set to 0 just before it and read just after.
Phases, each printing one line (phase 1 one per kernel):

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. builds the four kernels from the repository's sources, one nvcc
     each, started together, and prints ptxas's registers, stack frames
     and spills; the traversal kernels (closest hit, streaming closest hit,
     any hit) must show 0-byte stack frames and no spills;
  2. kernel vs its plain PyTorch version on the card, 65,536 rays on each
     of room, metal, random_balls and terrain (camera + random rays, about
     half of them dead), both want_attrs variants: at most 2 id mismatches
     per scene, t and rows bit-equal where ids agree, dead and miss lanes
     (inf, 0, zero row); then both timed at the main path's shape (the
     1920x1080 primary wavefront on terrain), the kernel through its
     wrapper with the scene's planes cached (what a render's launch pays)
     and with the cache cleared before each call (what a training step's
     first launch pays), with the packing alone, the kernel's shared
     memory and resident blocks, and its bound from the sphere, super,
     cluster and triangle tests its rays make (beside the bound of a sweep
     without supers); then the kernel on the bounce-1 wavefront of a
     main-path frame, held to the plain version on a 65,536-ray sample and
     timed on the whole wavefront;
  3. the main path: ``render_progressive`` of the terrain scene (15,842
     triangles, three spheres) at 1920x1080, bounces=3, rpp=1, skybox,
     coherent scatter with the 512-ray share tile, 8 frames, backend
     "auto" (which resolves to the kernel); the closest-hit kernel's launch
     count must rise by exactly frames x (bounces + 1), the image must be
     finite and not constant; segments/s timed with CUDA events after a
     warm-up frame (median and best of 5 renders); no other kernel may
     launch on this forward path (the scene is below the streaming
     kernel's crossover), and the render must not pack the scene's planes
     again (the warm-up frame packed them; so in phases 7 and 8);
  2b. (run before 3) the scatter-add kernel vs the exact sum (its plain
     version, ``index_add_``, in float64) on the card, on the 1080p
     terrain primary wavefront's winner ids in the blocked pixel order
     (misses routed to the dropped id) with seeded random cotangents
     (26, R): all lanes, about 5% of lanes live, no lane live, and the
     row-major (R, 26) form; and on the real cotangents and ids that the
     winner-row backward hands it on bounces 0 and 1 of one 1080p training
     step (both forms); each entry within 1e-5 of the exact value plus
     1e-6 of the sum of |g| over the lanes it adds up (the f32 plain
     version's own error printed beside); kernel (both forms), plain and
     ``index_add_`` ms (on a contiguous (R, 26) source, and on the
     transposed view) on the dense and the real cotangents, and whether
     two kernel runs were bit-equal;
  2c. (run before 3) the any-hit kernel vs its plain version on the card:
     65,536 shadow segments on each of room, metal, random_balls, terrain
     and terrain_nee (terrain plus a 2-triangle light quad and a small
     emissive sphere), from camera rays' hit points to points from
     ``lights.sample_lights`` (random points where a scene has no light),
     about half of the lanes dead, once as they are and once scaled by
     0.1: 0 mismatches and dead lanes false; the same on 4,096 random and
     4,096 secondary rays of the random mesh, its copies tied across
     blocks and across supers, and the terrain at n=60; then at the main
     path's shape, the 1080p bounce-0 shadow wavefront of terrain_nee: 0
     mismatches, the streaming kernel without rows against it, the
     kernel, the streaming kernel and the plain version timed, the
     kernel's shared memory and blocks per SM, and its bound from the
     sphere, super, cluster and triangle tests its warps make (beside the
     bound of the sweep without supers);
  2d. (run before 3) the streaming kernel vs its plain version on the
     card: 65,536 probe rays on terrain190k (the terrain at 190,962
     triangles, 24 blocks of 8192) and, through the wrapper, on room,
     metal, random_balls and the 16k terrain (blocks of 8192, and of 1024),
     both want_attrs variants, with phase 2's gates; the plain version
     timed on terrain190k's 65,536 rays; then the streaming kernel against
     the closest-hit kernel on the 1080p primary wavefronts of terrain190k
     and of the 16k terrain (at most 2 mismatches, bit-equal elsewhere),
     both timed as in phase 2 (cache warm, cleared, packing alone), with
     the streaming kernel's bound from the block, super, cluster and
     triangle tests its warps make (beside the bound of a ray-per-thread
     traversal without supers); the streaming kernel on terrain190k's
     bounce-1 wavefront as in phase 2; the any-hit kernel against the
     streaming kernel without rows on terrain190k_nee's 1080p bounce-0
     shadow wavefront (at most 2 mismatches), both timed; and past one
     round of 64 block boxes: the heightfield at n=520 (538,722
     triangles, 66 blocks of 8192) against the plain version on 16,384
     primary and 16,384 secondary rays (0 mismatches), its 1080p primary
     wavefront timed, and the any-hit kernel's refusal of that scene (its
     boxes exceed shared memory);
  4. path parity: one 256x144 frame through the kernel and through the
     plain oracle (backend "torch") on the same CUDA tensors; the fraction
     of pixels off by more than 2e-2 must be below 2e-3;
  4b. the same gate with NEE, on terrain_nee and room, each with nee, nee
     without MIS, and nee with Russian roulette from segment 1;
  5. the training path: ``grad.make_train_step`` over
     ``DEFAULT_TRAINABLE`` (Adam, 1e-2 on the albedos and 1e-4 on the
     geometry: ``train_optimizer``) at the main path's settings (terrain
     1920x1080, bounces=3), from the scene with its albedos scaled by 0.8
     towards the same frame of the true scene; one warm-up step and 5
     timed steps. Each step
     must launch the closest-hit and the scatter-add kernel bounces + 1
     times each and pack the scene's planes exactly once (the optimizer
     moved the scene; so in phase 8), every gradient must be finite,
     tri_v0's and tri_albedo's
     not all zero, and the last loss below the first. Prints s/step
     (median and spread, CUDA events), forward+backward segments/s, peak
     device memory, and the host's enqueue time against the device time;
  6. gradient parity: a whole-frame MSE gradient over every float scene
     leaf of a 256x144 terrain frame through the kernels (backend "cuda")
     and through the plain oracle (backend "torch") on the same CUDA
     tensors; the images must be equal, and per leaf max |diff| <= 1e-4 x
     that leaf's max |g|;
  6b. the same gradient gate with NEE on terrain_nee at 256x144 b3 (the
     emission leaves now get gradient through the light table);
  7. the NEE path: ``render_progressive`` of terrain_nee at phase 3's
     settings with ``nee=True, mis=True``; closest-hit launches must rise
     by frames x (bounces + 1), any-hit launches by frames x bounces (no
     shadow rays at the last segment), scatter-add by 0; the image finite
     and not constant; segments/s as in phase 3, and, ungated, the image
     mean against a ``nee=False`` render of the same frames; then the
     same for the room scene at 1080p without the sky;
  8. the large-scene path on terrain190k (built on the host; its build
     time printed), past the crossover: the forward render at phase 3's
     settings (streaming-kernel launches +32, closest-hit +0), the NEE
     render on terrain190k_nee (streaming +32 with rows and +24 without,
     any-hit +0), one warm-up and 3 timed training steps (streaming and
     scatter-add launches 4 each per step, gradients finite, the last loss
     below the first, peak memory), image parity at 256x144 against the
     plain oracle (backend "torch"; fraction off below 2e-3) and gradient
     parity at 128x72 (per leaf max |diff| <= 1e-4 x max |g|).

Then it prints the seconds each phase took, the kernels' JSON line (with
each kernel's bound: the larger of its bytes over 3.35 TB/s and its
operations, counted on this run's inputs, over 67 TFLOP/s f32; and the
rays its plain version was timed on) and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. ``--profile`` adds measurements: where one main-path
frame's time goes (torch.profiler), for terrain, for the room scene at
the same settings and for one NEE frame of terrain_nee, and where one
training step's time goes. ``--out DIR`` writes 4x-downsampled
images (``chip_smoke_terrain.npy``, ``chip_smoke_terrain_nee.npy``) and, with
``--profile``, the profiler tables (``chip_smoke_profile_<name>.txt``)
into DIR; without it nothing is written. With ``--profile`` phase 8 also
profiles one forward and one NEE frame of the large scene.

Usage: python3 chip_smoke.py [--profile] [--out DIR]
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch import lights, renderer, sampling
from ray_tracer_tpu_torch.grad import DEFAULT_TRAINABLE, make_train_step
from ray_tracer_tpu_torch.ops import anyhit as ah
from ray_tracer_tpu_torch.ops import blocked_hit as bh
from ray_tracer_tpu_torch.ops import closest_hit as ch
from ray_tracer_tpu_torch.ops import intersect
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
# scatter gate: |kernel - exact| <= RTOL |exact| + ATOL sum|g| per entry,
# exact the plain version's sum in float64 and sum|g| the sum of |g| over
# the lanes the entry adds up, so the bound grows with each entry's lanes.
# An f32 sum of n values errs by up to ~n u sum|g| (u = 6e-8) in the worst
# order; on the 1080p terrain a sphere's entries sum ~1e5 lanes, and real
# cotangents share a sign, so their f32 sums err alike: two f32 sums (the
# kernel and index_add_) are held to the exact one, not to each other
SCATTER_RTOL, SCATTER_ATOL = 1e-5, 1e-6
GRAD_PARITY = 1e-4     # per leaf, x that leaf's max |g|
NEE = dict(nee=True, mis=True)   # phase 7's knobs on top of PARAMS
# the NEE variants of phase 4b
NEE_VARIANTS = {"nee": dict(nee=True), "nee-nomis": dict(nee=True, mis=False),
                "nee-rr1": dict(nee=True, rr_start=1)}
# the card's published peaks (H100 SXM at 700 W) for the kernels' bounds
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# f32 operations per pair test and per slab test (the kernels' arithmetic)
OPS_PER_TRIANGLE, OPS_PER_SPHERE, OPS_PER_BOX = 30, 20, 20
GROUP = 32   # clusters per traversal group (csrc/hit_common.cuh:kGroup)
# entering lanes from which each tests a cluster's triangles itself
# (csrc/hit_common.cuh:kDenseLanes)
DENSE_LANES = 24
# kernel name -> (source, the TPU kernel it replaces); the library is the
# source's stem
KERNELS = {
    "closest_hit": ("ray_tracer_tpu_torch/csrc/closest_hit.cu",
                    "ray_tracer_tpu/ops/pallas_intersect.py:531"),
    "scatter_rows": ("ray_tracer_tpu_torch/csrc/scatter_rows.cu",
                     "ray_tracer_tpu/ops/pallas_intersect.py:1784"),
    "any_hit": ("ray_tracer_tpu_torch/csrc/anyhit.cu",
                "ray_tracer_tpu/ops/pallas_intersect.py:1965"),
    "blocked_hit": ("ray_tracer_tpu_torch/csrc/blocked_hit.cu",
                    "ray_tracer_tpu/ops/pallas_intersect.py:1084"),
}
# kernel name -> its wrapper, whose .launches counts the kernel's launches;
# "blocked_hit_ids" counts the streaming kernel's launches without rows
WRAPPERS = {"closest_hit": ch.nearest_hit_attrs,
            "scatter_rows": sc.scatter_rows_soa,
            "any_hit": ah.anyhit,
            "blocked_hit": bh.nearest_hit_blocked}
LARGE_N = 310          # terrain190k: 2 (310 - 1)^2 = 190,962 triangles
LARGE_TRAIN_STEPS = 3  # phase 8's timed training steps
HUGE_N = 520           # 538,722 triangles: 66 blocks of 8192, two rounds
LIBRARIES = [os.path.splitext(os.path.basename(src))[0]
             for src, _ in KERNELS.values()]
# the libraries of the traversal kernels (B1, B4, B3): 0-byte stack frames
# and no spills, gated in phase 1
TRAVERSAL = ("closest_hit", "blocked_hit", "anyhit")


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


def terrain_scene(device, n=90, aspect=W / H, with_lights=False):
    """Terrain of 2 (n-1)^2 triangles (15,842 at n=90) with the metal
    scene's glass, diffuse and glossy spheres resting on it. With
    ``with_lights`` (terrain_nee): a 2x2 quad high above it with the room
    scene's ceiling-light material (white, strength 10.5), wound so that
    its geometric normal faces down at the terrain, and one small warm
    emissive sphere."""
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
    if with_lights:
        quad = np.array([(-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1)],
                        np.float32)
        b.add_mesh(quad, [(0.0, -1.0, 0.0)] * 4, [0, 1, 2, 0, 2, 3],
                   albedo=(1.0, 1.0, 1.0), emission=(1.0, 1.0, 1.0),
                   emission_strength=10.5, smoothness=0.0)
        b.add_sphere((2.0, 0.2, -1.5), 0.25, (1.0, 1.0, 1.0),
                     (1.0, 0.8, 0.6), 20.0, 0.0)
    cam = rt.Camera(origin=(0.0, 1.5, 6.0), look_at=(0.0, -0.8, 0.0),
                    fov=45.0, aspect=aspect)
    return b.build(device=device), cam


def reset_counts():
    """Every kernel's launch count to 0."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    bh.nearest_hit_blocked.ids_launches = 0


def read_counts():
    """Every kernel's launch count since reset_counts()."""
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    counts["blocked_hit_ids"] = bh.nearest_hit_blocked.ids_launches
    return counts


def launches(**want):
    """The launch counts a path must show: those named, the others 0."""
    return {k: want.get(k, 0) for k in (*WRAPPERS, "blocked_hit_ids")}


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


def wrapper_ms(fn, scene, reps=20):
    """A kernel's time through its wrapper ``fn()`` on ``scene`` → (ms with
    the plane cache warm: what a render's launch pays; ms with the cache
    cleared before every call: what a training step's first launch pays;
    ms of packing the scene's planes once)."""
    fn()
    warm = cuda_ms(fn, reps)

    def cold():
        ch.clear_plane_cache()
        fn()

    cold_ms = cuda_ms(cold, max(reps // 4, 2))

    def pack():
        ch.clear_plane_cache()
        ch.scene_planes(scene)

    return warm, cold_ms, cuda_ms(pack, max(reps // 4, 2))


def bound(nbytes, ops):
    """The least time (ms) the card could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(nbytes), ops=int(ops))


def plane_bytes(scene, block=None, attrs=True):
    """Bytes of the planes a ray-query kernel reads, each input once:
    spheres, 128 bytes a triangle (the geometry plane repeats columns 0:12
    of the attribute plane, so a triangle is 48 bytes of geometry and the
    80 of its other attributes; 48 without ``attrs``: the any-hit kernel
    reads the geometry plane only), cluster and super boxes and, with
    ``block``, the streaming kernel's block boxes."""
    clusters = -(-scene.num_tris // ch.CLUSTER)
    boxes = clusters + -(-clusters // ch.SUPER) + (
        bh.block_layout(scene, block)[2] if block else 0)
    return 4 * (scene.padded_spheres * 16
                + scene.padded_tris * (32 if attrs else ch.GEO_COLS)
                + boxes * 8)


def _segments(c0, c1):
    """The (super, first cluster, end cluster) runs that the traversal core
    tests between clusters c0 and c1, and the offset from c0 of the group
    of GROUP clusters each lies in: supers span 8 clusters from cluster 0,
    groups GROUP clusters from c0."""
    segs = []
    for g0 in range(c0, c1, GROUP):
        g1 = min(g0 + GROUP, c1)
        for s in range(g0 // ch.SUPER, (g1 - 1) // ch.SUPER + 1):
            segs.append((s, max(s * ch.SUPER, g0), min((s + 1) * ch.SUPER,
                                                       g1), g0 - c0))
    return segs


def _hierarchy_work(planes, c0, c1, orr, drr, irr, best, t_min):
    """What the traversal core (csrc/hit_common.cuh:visit_group) tests for
    the rays (orr, drr, 1/d irr: (x, y, z) triples of (r, 1) columns) on
    clusters [c0, c1), from each ray's best so far ``best`` (r,) → (counts,
    best after). A ray tests every super of every group, the cluster boxes
    of the supers it enters no farther than its best at the group's start,
    and the 64 triangles of each cluster it enters no farther than its best
    over the clusters before it. ``flat_clusters`` and ``flat_pairs`` are
    what a sweep without supers tests: every cluster box, and the triangles
    of boxes entered strictly nearer than the best (the closest-hit kernel
    before it had supers). Brute force: every pair is computed."""
    r, G = orr[0].shape[0], c1 - c0
    clu, sup = planes.clu[c0:c1], planes.sup
    geo = planes.geo[c0 * ch.CLUSTER:c1 * ch.CLUSTER]
    ctn, ctf = ah._slab_pairs(ch._cols(clu, 0, 3), ch._cols(clu, 3, 6), orr,
                              irr, t_min)
    t_t, ok_t = ch._mt_pairs(*(ch._cols(geo, k, k + 3) for k in (0, 3, 6, 9)),
                             orr, drr, t_min)
    c_min = torch.where(ok_t, t_t, float("inf")).view(r, G, ch.CLUSTER).amin(2)
    before = torch.cat([best[:, None], c_min], 1).cummin(1)[0]
    segs = _segments(c0, c1)
    s_idx = torch.tensor([s for s, _, _, _ in segs], device=clu.device)
    s_len = torch.tensor([hi - lo for _, lo, hi, _ in segs],
                         device=clu.device)
    s_at = torch.tensor([at for _, _, _, at in segs], device=clu.device)
    stn, stf = ah._slab_pairs(ch._cols(sup[s_idx], 0, 3),
                              ch._cols(sup[s_idx], 3, 6), orr, irr, t_min)
    s_enter = (stf >= stn) & (stn <= before[:, s_at])
    hit_box = ctf >= ctn
    counts = dict(
        supers=r * len(segs), clusters=int((s_enter * s_len).sum()),
        pairs=ch.CLUSTER * int((hit_box & (ctn <= before[:, :G])).sum()),
        flat_clusters=r * G,
        flat_pairs=ch.CLUSTER * int((hit_box & (ctn < before[:, :G])).sum()))
    return counts, before[:, -1]


def _sphere_best(planes, oc, dc, t_min):
    """Each ray's closest valid sphere hit (inf where none) and the count
    of valid spheres."""
    sph = planes.sph
    sc, (r2,), sv = ch._cols(sph, 0, 3), ch._cols(sph, 3, 4), sph[None, :, 4]
    a_quad = (dc[0] * dc[0] + dc[1] * dc[1]) + dc[2] * dc[2]
    t_s, ok_s = ch._sphere_pairs(sc, r2, oc, dc, a_quad, t_min)
    return (torch.where(ok_s & (sv > 0.5), t_s, float("inf")).amin(1),
            int((sv > 0.5).sum()))


def _columns(x):
    return tuple(x[:, k:k + 1] for k in range(3))


@torch.no_grad()
def traversal_work(scene, o, d, alive, t_min=1e-4, chunk=2048):
    """What the closest-hit kernel tests for these rays (measurement only,
    brute force in chunks of live lanes): every live lane tests every valid
    sphere, then walks the whole hierarchy as ``_hierarchy_work`` counts →
    dict of sphere pairs, super boxes, cluster boxes, triangle pairs, and
    the ``flat_clusters`` and ``flat_pairs`` of a sweep without supers."""
    live = alive.nonzero()[:, 0]
    o, d = o[live], d[live]
    planes = ch.scene_planes(scene)
    total = dict.fromkeys(("spheres", "supers", "clusters", "pairs",
                           "flat_clusters", "flat_pairs"), 0)
    for s in range(0, o.shape[0], chunk):
        oc, dc = _columns(o[s:s + chunk]), _columns(d[s:s + chunk])
        irr = tuple(1.0 / torch.where(x == 0.0, 1e-30, x) for x in dc)
        best, n_valid = _sphere_best(planes, oc, dc, t_min)
        total["spheres"] += n_valid * best.shape[0]
        if planes.n_clusters:
            counts, _ = _hierarchy_work(planes, 0, planes.n_clusters, oc, dc,
                                        irr, best, t_min)
            for k, v in counts.items():
                total[k] += v
    return total


@torch.no_grad()
def anyhit_work(scene, o, d, alive, t_min, t_max, warp=32, chunk=2048):
    """What the any-hit kernel tests for these rays on a scene with
    triangles, as its warps visit them (measurement only, brute force in
    chunks of live lanes) → dict of sphere pairs, super boxes, cluster
    boxes and triangle pairs, and the ``flat_clusters`` and ``flat_pairs``
    of a sweep without supers (the kernel before it ran on the traversal
    core).

    A live lane tests the valid spheres in id order up to the first that
    blocks it; a lane a sphere blocks is done. The others take the groups
    of GROUP clusters in ascending order while unblocked: at a group's
    start a lane tests its supers and the clusters of the supers it enters
    before the segment's end. The warp (``warp`` consecutive lanes) walks
    the union of the entered clusters in ascending order; a cluster's
    entering lanes are those that entered it and were not blocked before
    it, so a lane is done from the first cluster in which a test blocks it.
    Where at least DENSE_LANES lanes enter a cluster, each tests its
    triangles up to the first that blocks it; where fewer do, the warp
    issues the 64 tests of each entering ray."""
    planes = ch.scene_planes(scene)
    C = planes.n_clusters
    sph, sup = planes.sph, planes.sup
    clu, geo = planes.clu[:C], planes.geo[:C * ch.CLUSTER]
    sc, (r2,), sv = ch._cols(sph, 0, 3), ch._cols(sph, 3, 4), sph[None, :, 4]
    sv = sv > 0.5
    n_valid, seen_valid = sv.sum(), sv.cumsum(1)[0]
    segs = _segments(0, C)
    s_idx = torch.tensor([s for s, _, _, _ in segs], device=o.device)
    s_len = torch.tensor([hi - lo for _, lo, hi, _ in segs], device=o.device)
    s_at = torch.tensor([at for _, _, _, at in segs], device=o.device)
    cid = torch.arange(C, device=o.device)
    n_warps = -(-o.shape[0] // warp)
    entering = torch.zeros((n_warps, C), dtype=torch.int32, device=o.device)
    own = torch.zeros((n_warps, C), dtype=torch.int32, device=o.device)
    totals = torch.zeros(5, dtype=torch.float64, device=o.device)
    live = alive.nonzero()[:, 0]
    for s in range(0, live.numel(), chunk):
        lanes = live[s:s + chunk]
        oc, dc = _columns(o[lanes]), _columns(d[lanes])
        a_quad = (dc[0] * dc[0] + dc[1] * dc[1]) + dc[2] * dc[2]
        t_s, ok_s = ch._sphere_pairs(sc, r2, oc, dc, a_quad, t_min)
        blk_s = ok_s & sv & (t_s < t_max)
        go = ~blk_s.any(1)                       # not blocked by a sphere
        spheres = torch.where(go, n_valid, seen_valid[blk_s.int().argmax(1)])
        irr = tuple(1.0 / torch.where(x == 0.0, 1e-30, x) for x in dc)
        ctn, ctf = ah._slab_pairs(ch._cols(clu, 0, 3), ch._cols(clu, 3, 6),
                                  oc, irr, t_min)
        c_enter = (ctf >= ctn) & (ctn < t_max)               # (r, C)
        stn, stf = ah._slab_pairs(ch._cols(sup[s_idx], 0, 3),
                                  ch._cols(sup[s_idx], 3, 6), oc, irr, t_min)
        s_enter = (stf >= stn) & (stn < t_max)               # (r, segments)
        t_t, ok_t = ch._mt_pairs(
            *(ch._cols(geo, k, k + 3) for k in (0, 3, 6, 9)), oc, dc, t_min)
        blk_t = (ok_t & (t_t < t_max)).view(-1, C, ch.CLUSTER)
        del t_t, ok_t
        hits = blk_t.any(2)
        tests = torch.where(hits, blk_t.int().argmax(2) + 1, ch.CLUSTER)
        blocking = c_enter & hits
        first = torch.where(blocking.any(1), blocking.int().argmax(1), C)
        part = c_enter & (cid <= first[:, None]) & go[:, None]
        # a lane takes part in a group while unblocked at its start
        at_start = go[:, None] & (first[:, None] >= s_at)
        warps = lanes // warp
        entering.index_add_(0, warps, part.int())
        own.index_add_(0, warps, (part * tests).int())
        # the sweep without supers: every cluster box up to the blocking
        # one, the 64 tests of each entered box before it, then its own
        swept = torch.where(first < C, first + 1, C)
        flat_p = ch.CLUSTER * (c_enter & (cid < first[:, None])).sum(1) \
            + torch.where(first < C, tests.gather(
                1, first.clamp(max=C - 1)[:, None])[:, 0], 0)
        totals += torch.stack([x.to(torch.float64) for x in (
            spheres.sum(), at_start.sum(),
            ((at_start & s_enter) * s_len).sum(),
            torch.where(go, swept, 0).sum(),
            torch.where(go, flat_p, 0).sum())])
    dense = entering >= DENSE_LANES
    pairs = int(own[dense].sum() + ch.CLUSTER * entering[~dense].sum())
    spheres, supers, clusters, flat, flat_pairs = (
        int(x) for x in totals.tolist())
    return dict(spheres=spheres, supers=supers, clusters=clusters,
                pairs=pairs, flat_clusters=flat, flat_pairs=flat_pairs)


def work_bound(nbytes, work, supers=True):
    """bound() of a traversal's bytes and its counted sphere, box (block,
    super, cluster) and triangle tests; without ``supers`` the bound of the
    same rays' sweep without that level (``flat_clusters`` and
    ``flat_pairs`` where the count has them)."""
    if supers:
        boxes = (work.get("blocks", 0) + work.get("supers", 0)
                 + work["clusters"])
        pairs = work["pairs"]
    else:
        boxes = work.get("blocks", 0) + work["flat_clusters"]
        pairs = work.get("flat_pairs", work["pairs"])
    return bound(nbytes, OPS_PER_SPHERE * work["spheres"]
                 + OPS_PER_BOX * boxes + OPS_PER_TRIANGLE * pairs)


@torch.no_grad()
def blocked_traversal_work(scene, o, d, alive, t_min=1e-4, block=bh.BLOCK,
                           warp=32, chunk=2048):
    """What the streaming kernel tests for these rays, as its loops visit
    them (measurement only) → dict of sphere pairs, block boxes, super
    boxes, cluster boxes and triangle pairs. Every live lane tests every
    valid sphere and every real block box. The lanes of a warp (``warp``
    consecutive rays) visit blocks together, in the order of each block's
    nearest entry over the warp's lanes, while that entry is no farther
    than the farthest best of the warp's live lanes; a lane takes part in
    a block it enters no farther than its best so far, and tests there
    what ``_hierarchy_work`` counts. ``warp=1`` gives every lane its own
    order, and with ``flat_clusters`` the count of a ray-per-thread
    traversal without supers. The triangle tests run per block, on the
    lanes that take part."""
    n = -(-o.shape[0] // warp) * warp
    pad = n - o.shape[0]
    o = torch.cat([o, o.new_zeros((pad, 3))])
    d = torch.cat([d, d.new_ones((pad, 3))])
    alive = torch.cat([alive, alive.new_zeros(pad)])
    G, C, NB = bh.block_layout(scene, block)
    planes = ch.scene_planes(scene)
    blk = planes.block_boxes(G)
    oc, dc = _columns(o), _columns(d)
    invd = tuple(1.0 / torch.where(x == 0.0, 1e-30, x) for x in dc)
    best = torch.empty(n, device=o.device)
    for s in range(0, n, 32 * chunk):
        cut = slice(s, s + 32 * chunk)
        best[cut], n_valid = _sphere_best(planes, tuple(x[cut] for x in oc),
                                          tuple(x[cut] for x in dc), t_min)
    best = torch.where(alive, best, -float("inf"))   # a dead lane enters none
    tn, tf = ah._slab_pairs(ch._cols(blk, 0, 3), ch._cols(blk, 3, 6), oc,
                            invd, t_min)                          # (n, NB)
    inside = tf >= tn
    key = torch.where(inside & (tn <= best[:, None]), tn, float("inf"))
    key, order = torch.sort(key.view(-1, warp, NB).amin(1), dim=1,
                            stable=True)                     # (n / warp, NB)
    del tf
    total = dict(spheres=n_valid * int(alive.sum()),
                 blocks=NB * int(alive.sum()), supers=0, clusters=0, pairs=0,
                 flat_clusters=0)
    for k in range(NB):
        farthest = best.view(-1, warp).amax(1)
        go = torch.isfinite(key[:, k]) & (key[:, k] <= farthest)
        if not bool(go.any()):
            break
        go = go.repeat_interleave(warp)
        at = order[:, k].repeat_interleave(warp)
        for b in range(NB):
            lanes = (go & (at == b) & inside[:, b]
                     & (tn[:, b] <= best)).nonzero()[:, 0]
            for s in range(0, lanes.numel(), chunk):
                r = lanes[s:s + chunk]
                counts, best[r] = _hierarchy_work(
                    planes, b * G, min((b + 1) * G, C),
                    *(tuple(x[r] for x in v) for v in (oc, dc, invd)),
                    best[r], t_min)
                for name in ("supers", "clusters", "pairs", "flat_clusters"):
                    total[name] += counts[name]
    return total


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


def stack_and_spills(log):
    """(function, stack frame bytes, spill store bytes, spill load bytes)
    of every function ptxas reports in a build log (``-Xptxas -v``)."""
    frames, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and fn:
            frames.append((fn, *(int(x) for x in m.groups())))
            fn = None
    return frames


def phase1_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source
        paths = dict(zip(LIBRARIES, pool.map(build.build, LIBRARIES)))
    for name in LIBRARIES:
        build.load(name)
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text() if path.with_suffix(
            ".log").exists() else ""
        ptxas = " / ".join(ln.split("ptxas info    : ")[-1] for ln in
                           log.splitlines() if "Used" in ln or "spill" in ln)
        print(f"phase 1 build: {path.name} ({len(paths)} built together in "
              f"{secs:.2f} s) | {ptxas}", flush=True)
        frames = stack_and_spills(log)
        if name in TRAVERSAL and (not frames or any(
                any(f[1:]) for f in frames)):
            raise AssertionError(f"{name}: the traversal kernels must have "
                                 f"0-byte stack frames and no spills, ptxas "
                                 f"reports {frames}")


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
    ms, cold_ms, pack_ms = wrapper_ms(
        lambda: ch.nearest_hit_attrs(scene, o, d, 1e-4, alive), scene)
    plain_ms = cuda_ms(lambda: ch.nearest_hit_attrs_reference(
        scene, o, d, 1e-4, alive), 1)
    # rays (o, d, alive: 25 bytes) in; t, id and the 26-column row out; the
    # sphere, geometry, attribute and box planes once
    work = traversal_work(scene, o, d, alive)
    nbytes = W * H * (25 + 4 * (2 + 26)) + plane_bytes(scene)
    b, flat = work_bound(nbytes, work), work_bound(nbytes, work, False)
    lib, planes = ch._library(), ch.scene_planes(scene)
    shape = (planes.n_clusters, planes.sup.shape[0])
    print(f"phase 2 main-path shape (terrain, {W}x{H} primary rays, "
          f"{hits} hits, {mism} mism): kernel {ms:.3f} ms with the plane "
          f"cache warm, {cold_ms:.3f} ms with it cleared before each call "
          f"(packing alone {pack_ms:.3f} ms), plain {plain_ms:.3f} ms, max "
          f"|dt| {err}; {lib.rtt_closest_hit_shared_bytes(*shape)} B of "
          f"shared memory a block, "
          f"{lib.rtt_closest_hit_blocks_per_sm(*shape, 1)} blocks an SM; "
          f"tested {work['spheres']} sphere pairs, {work['supers']} super "
          f"boxes, {work['clusters']} cluster boxes, {work['pairs']} "
          f"triangle pairs: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({b['bytes']} B, {b['ops']} f32 ops); a sweep without supers "
          f"{work['flat_clusters']} boxes, {work['flat_pairs']} pairs: "
          f"bound {flat['bound_ms']:.4f} ms", flush=True)
    print("phase 2 secondary rays: " + secondary_check(
        "closest-hit on terrain", scene, cam, ch.nearest_hit_attrs,
        ch.nearest_hit_attrs_reference, device), flush=True)
    return dict(ms=ms, plain_ms=plain_ms, plain_rays=W * H,
                max_abs_err=max_err, mismatches=mism, library_ms=None, **b)


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


def rate_text(runs, segs):
    """Segments/s of timed renders: median, best, the runs and their
    spread."""
    med, best = float(np.median(runs)), min(runs)
    return (f"{segs / med / 1e6:.3f} M segments/s median, "
            f"{segs / best / 1e6:.3f} best ({len(runs)} runs "
            f"{[round(r, 4) for r in runs]} s, spread "
            f"{(max(runs) - best) / best:.2%}")


def render_path(label, scene, cam, params, want):
    """One path's render, checked: a warm-up frame (which packs the
    scene's planes), every launch count to 0, ``render_progressive`` of
    FRAMES frames, the counts held to ``want`` and the planes packed no
    further time, the image finite (H, W, 3) and not constant; then TRIALS - 1
    more timed renders → (image, counts, device seconds of each render,
    host seconds to enqueue the first)."""
    basis = rt.camera_basis(cam)
    render_frame(scene, basis, params, 0)            # warm-up frame
    torch.cuda.synchronize()
    reset_counts()
    packs = ch.scene_planes.packs
    img, secs, enqueue_s = timed_render(scene, basis, params, FRAMES)
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"{label}: kernel launches {counts} != {want}")
    if ch.scene_planes.packs != packs:
        raise AssertionError(f"{label}: a render of a scene already packed "
                             f"packed its planes "
                             f"{ch.scene_planes.packs - packs} times")
    if img.shape != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label} image is not finite (H, W, 3)")
    if float(img.std()) < 1e-3:
        raise AssertionError(f"{label} image is constant")
    runs = [secs] + [timed_render(scene, basis, params, FRAMES)[1]
                     for _ in range(TRIALS - 1)]
    return img, counts, runs, enqueue_s


def phase3_main_path(device, terrain, card, profile, out_dir):
    scene, cam = terrain
    params = rt.RenderParams(**PARAMS)
    if resolved_backend(params, scene) != "cuda":
        raise AssertionError("backend 'auto' did not resolve to cuda")
    img, counts, runs, enqueue_s = render_path(
        "terrain", scene, cam, params,
        launches(closest_hit=FRAMES * (BOUNCES + 1)))
    segs = W * H * 1 * (BOUNCES + 1) * FRAMES
    print(f"phase 3 main path: terrain {scene.num_tris} tris {W}x{H} "
          f"b{BOUNCES} {FRAMES} frames: {rate_text(runs, segs)}; host "
          f"enqueue {enqueue_s:.4f} s of the first), {counts['closest_hit']} "
          f"closest-hit and {counts['blocked_hit']} streaming launches, "
          f"image mean {float(img.mean()):.4f} | {card}", flush=True)
    if out_dir:
        np.save(os.path.join(out_dir, "chip_smoke_terrain.npy"),
                img[::4, ::4].cpu().numpy())
    if profile:
        basis = rt.camera_basis(cam)
        profile_frame("terrain", scene, basis, params, out_dir)
        room, room_cam = rt.builtin_scene("room", aspect=W / H,
                                          device=device)
        room_basis = rt.camera_basis(room_cam)
        render_frame(room, room_basis, params, 0)
        _, room_s, _ = timed_render(room, room_basis, params, FRAMES)
        print(f"profile: room {W}x{H} {FRAMES} frames "
              f"{segs / room_s / 1e6:.3f} M segments/s", flush=True)
        profile_frame("room", room, room_basis, params, out_dir)
    return counts["closest_hit"]


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
    if out_dir:
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(os.path.join(out_dir, f"chip_smoke_profile_{name}.txt"),
                  "w") as f:
            f.write(table)
    shares = []
    for key in ("closest_hit", "blocked_hit", "anyhit"):
        us = [e.time_range.elapsed_us() for e in kernels if key in e.name]
        if us:
            shares.append(f"{key} per bounce {us} us "
                          f"({sum(us) / max(busy_us, 1):.1%} of device time)")
    print(f"profile: {name} frame {frame_s * 1e3:.3f} ms wall; "
          f"{len(kernels)} device kernels busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / frame_s:.1%} of the wall time); "
          + "; ".join(shares), flush=True)


def image_parity(label, scene, cam):
    """One 256x144 frame at the main path's settings through the kernels
    and through the plain oracle on the same CUDA tensors → (fraction of
    pixels off, max |diff|); raises past the gate."""
    basis = rt.camera_basis(cam.replace(aspect=256 / 144))
    params = rt.RenderParams(**dict(PARAMS, width=256, height=144))
    a = render_frame(scene, basis, params.replace(backend="cuda"), 0)
    b = render_frame(scene, basis, params.replace(backend="torch"), 0)
    off = frac_off(a, b)
    if not off < PARITY_GATE:
        raise AssertionError(f"{label} path parity: {off} of pixels off")
    return off, float((a - b).abs().max())


def phase4_parity(device, terrain):
    off, diff = image_parity("terrain", *terrain)
    print(f"phase 4 path parity (terrain 256x144, cuda vs torch): "
          f"frac_off {off} (gate {PARITY_GATE}), max |diff| {diff}",
          flush=True)


def frac_off(a, b):
    return float(((a - b).abs().amax(-1) > PARITY_TOL).float().mean())


def phase4b_nee_parity(device, terrain_nee):
    room = rt.builtin_scene("room", aspect=256 / 144, device=device)
    report = []
    for name, (scene, cam), skybox in (("terrain_nee", terrain_nee, True),
                                       ("room", room, False)):
        basis = rt.camera_basis(cam.replace(aspect=256 / 144))
        for label, knobs in NEE_VARIANTS.items():
            params = rt.RenderParams(**dict(PARAMS, width=256, height=144,
                                            skybox=skybox, **knobs))
            a = render_frame(scene, basis, params.replace(backend="cuda"), 0)
            b = render_frame(scene, basis, params.replace(backend="torch"),
                             0)
            off = frac_off(a, b)
            if not off < PARITY_GATE:
                raise AssertionError(f"NEE path parity {name} {label}: "
                                     f"{off} of pixels off")
            report.append(f"{name} {label} {off} (max |diff| "
                          f"{float((a - b).abs().max()):.3g})")
    print(f"phase 4b NEE path parity (256x144, cuda vs torch, gate "
          f"{PARITY_GATE}): " + "; ".join(report), flush=True)


def primary_wavefront(scene, cam, device):
    """The main path's 1080p primary rays, in render_frame's blocked pixel
    order (the order the backward's scatter sees)."""
    basis = rt.camera_basis(cam).to(device)
    ids, _ = _blocked_ids(W, H, device)
    _, o, d = rt.camera_rays(basis, ids % W, ids // W, (W, H),
                             sampling.seed_state(ids, 0))
    return o, d


def scatter_gate(label, fn, ids, g_soa, n_rows, g=None):
    """Scatter-add wrapper ``fn(ids, g, n_rows)`` (``g`` its layout of the
    SoA cotangents ``g_soa``) against the plain version's sum in float64:
    each entry within SCATTER_RTOL of it plus SCATTER_ATOL of the sum of
    |g| over the lanes it adds up → (max |diff|, report text, with the f32
    plain version's own max |diff| beside). Raises past it."""
    got = fn(ids, g_soa if g is None else g, n_rows)
    exact = sc.scatter_rows_soa_reference(ids, g_soa.double(), n_rows)
    mass = sc.scatter_rows_soa_reference(ids, g_soa.abs().double(), n_rows)
    plain = sc.scatter_rows_soa_reference(ids, g_soa, n_rows)
    torch.cuda.synchronize()
    diff = (got.double() - exact).abs()
    plain_diff = (plain.double() - exact).abs()
    err = float(diff.max())
    if bool((diff > SCATTER_RTOL * exact.abs() + SCATTER_ATOL * mass).any()):
        raise AssertionError(f"scatter {label}: max |diff| {err} "
                             f"(max |exact| {float(exact.abs().max())})")
    live = int((ids < n_rows).sum())
    rel = float((diff / mass.clamp(min=1e-300)).max())
    plain_rel = float((plain_diff / mass.clamp(min=1e-300)).max())
    return err, (f"{label} {live} live lanes max |diff| {err:.3g} (/ sum|g| "
                 f"{rel:.3g}; plain f32 {float(plain_diff.max()):.3g}, / "
                 f"sum|g| {plain_rel:.3g})")


def scatter_times(ids, g_soa, n_rows):
    """(kernel ms, index_add_ ms on a contiguous (R, W) source into
    n_rows + 1 rows (the dropped id's lanes land in the extra one), the
    same on the transposed view) of one scatter's inputs."""
    g_rows = g_soa.T.contiguous()
    acc = torch.zeros((n_rows + 1, g_soa.shape[0]), device=g_soa.device)
    return (cuda_ms(lambda: sc.scatter_rows_soa(ids, g_soa, n_rows), 20),
            cuda_ms(lambda: acc.index_add_(0, ids, g_rows), 20),
            cuda_ms(lambda: acc.index_add_(0, ids, g_soa.T), 20))


def winner_cotangents(scene, cam):
    """What the winner-row backward hands the scatter-add on bounces 0 and
    1 of one training step at the main path's settings (``train_setup``'s
    start and target) → [(ids, g (26, R)), ...] in bounce order, n_rows.
    Each scatter is matched to its bounce by its ids, which are the
    forward's winners with the misses routed to n_rows."""
    fwd, bwd = [], []
    real_rows, real_scatter = intersect._nearest_rows, sc.scatter_rows_soa

    def rows_spy(*args, **kw):
        out = real_rows(*args, **kw)
        fwd.append(out[1:])
        return out

    def scatter_spy(ids, g_soa, n_rows):
        bwd.append((ids, g_soa, n_rows))
        return real_scatter(ids, g_soa, n_rows)

    scatter_spy.launches = 0  # the wrapper counts on its module's name

    step_fn, args = train_setup(scene, cam)
    intersect._nearest_rows, sc.scatter_rows_soa = rows_spy, scatter_spy
    try:
        step_fn(*args)
    finally:
        intersect._nearest_rows, sc.scatter_rows_soa = real_rows, real_scatter
    n_rows = bwd[0][2]
    out = []
    for pid, miss in fwd[:2]:
        want = torch.where(miss, n_rows, pid)
        out += [(ids, g) for ids, g, _ in bwd if torch.equal(ids, want)][:1]
    if len(out) != 2:
        raise AssertionError("the training step's scatters do not match its "
                             "bounces 0 and 1")
    return out, n_rows


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
    real, real_rows = winner_cotangents(scene, cam)
    if real_rows != n_rows:
        raise AssertionError(f"the backward's table has {real_rows} rows")
    cases = [("dense", sc.scatter_rows_soa, ids, g, None),
             ("sparse", sc.scatter_rows_soa, sparse, g, None),
             ("all-miss", sc.scatter_rows_soa, all_miss, g, None),
             ("row-major", sc.scatter_rows, ids, g, g.T.contiguous())]
    for b, (r_ids, r_g) in enumerate(real):
        cases += [(f"real bounce {b}", sc.scatter_rows_soa, r_ids, r_g, None),
                  (f"real bounce {b} row-major", sc.scatter_rows, r_ids, r_g,
                   r_g.T.contiguous())]
    report, max_err = [], 0.0
    for label, fn, case_ids, case_g, layout in cases:
        err, text = scatter_gate(label, fn, case_ids, case_g, n_rows, layout)
        max_err = max(max_err, err)
        report.append(text)
    again = [sc.scatter_rows_soa(ids, g, n_rows) for _ in range(2)]
    bit_equal = torch.equal(again[0], again[1])
    del again
    ms, library_ms, view_ms = scatter_times(ids, g, n_rows)
    g_rows = cases[3][4]
    row_major_ms = cuda_ms(lambda: sc.scatter_rows(ids, g_rows, n_rows), 20)
    plain_ms = cuda_ms(lambda: sc.scatter_rows_soa_reference(ids, g, n_rows),
                       5)
    real_text = []
    for b, (r_ids, r_g) in enumerate(real):
        k_ms, l_ms, v_ms = scatter_times(r_ids, r_g, n_rows)
        nonzero = float((r_g != 0).float().mean())
        real_text.append(
            f"bounce {b} ({int((r_ids < n_rows).sum())} live lanes, "
            f"{nonzero:.1%} of entries nonzero): kernel {k_ms:.3f} ms, "
            f"index_add_ {l_ms:.3f} ms (on the transposed view {v_ms:.3f} "
            f"ms)")
    # ids and cotangents in, the table out; one add per live entry
    live = int((ids < n_rows).sum())
    b = bound(R * 4 * (1 + 26) + n_rows * 26 * 4, live * 26)
    print(f"phase 2b scatter-add vs exact (the plain version in float64; "
          f"terrain {W}x{H} primary winners, {n_rows} rows x 26; real: the "
          f"cotangents of one training step): "
          + "; ".join(report)
          + f" | dense 1080p: kernel {ms:.3f} ms (its row-major form "
          f"{row_major_ms:.3f} ms), plain "
          f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms (on the "
          f"transposed view {view_ms:.3f} ms), bound {b['bound_ms']:.4f} ms "
          f"by {b['bound_by']}; two kernel runs bit-equal: {bit_equal} | "
          f"real: " + "; ".join(real_text), flush=True)
    return dict(ms=ms, plain_ms=plain_ms, plain_rays=R, max_abs_err=max_err,
                mismatches=0, library_ms=library_ms, **b)


def shadow_segments(scene, cam, n, seed, device):
    """n shadow segments (o, d, alive): from the hit points of camera rays
    (a point 5 units along the ray where it misses) to points from
    ``lights.sample_lights``, or to random points around the scene where
    it has no light; about half of the lanes dead."""
    g = np.random.default_rng(seed)
    basis = rt.camera_basis(cam).to(device)
    pix = torch.from_numpy(g.integers(0, 256 * 256, size=n)).to(device)
    state = torch.from_numpy(g.integers(0, 2 ** 32, size=n)).to(device)
    state, o, d = rt.camera_rays(basis, pix % 256, pix // 256, (256, 256),
                                 state)
    t, _ = ch.nearest_hit_attrs(scene, o, d, 1e-4, want_attrs=False)
    p = o + d * torch.where(torch.isinf(t), 5.0, t)[:, None]
    table = lights.build_light_table(scene)
    if bool(table.has_lights):
        _, ls = lights.sample_lights(table, scene, state, p)
        seg = ls["wi"]
    else:
        spread = torch.from_numpy(g.normal(size=(n, 3)) * 3.0).float()
        seg = p.mean(0) + spread.to(device) - p
    alive = torch.from_numpy(g.random(n) < 0.5).to(device)
    return p.contiguous(), seg.contiguous(), alive


def wavefront(scene, cam, params, seg):
    """The closest-hit query of segment ``seg`` of one frame of the path:
    (o, d, alive) as ``renderer.trace`` hands them to ``intersect``
    (segment 1 is the first wavefront of secondary rays)."""
    seen, real = [], renderer.intersect

    def spy(scene, o, d, t_min, backend, alive):
        seen.append((o, d, alive))
        return real(scene, o, d, t_min=t_min, backend=backend, alive=alive)

    renderer.intersect = spy
    try:
        render_frame(scene, rt.camera_basis(cam), params, 0)
    finally:
        renderer.intersect = real
    return tuple(x.detach().contiguous() for x in seen[seg])


def secondary_check(label, scene, cam, hit, plain, device):
    """Kernel wrapper ``hit`` on the bounce-1 wavefront of one main-path
    frame of ``scene``: held to ``plain`` on a PROBE_RAYS-ray sample
    (``compare``'s gates), then timed on the whole wavefront → text."""
    o, d, alive = wavefront(scene, cam, rt.RenderParams(**PARAMS), 1)
    pick = torch.from_numpy(np.random.default_rng(5).choice(
        o.shape[0], PROBE_RAYS, replace=False)).to(device)
    got = hit(scene, o[pick], d[pick], 1e-4, alive[pick])
    ref = plain(scene, o[pick], d[pick], 1e-4, alive[pick])
    torch.cuda.synchronize()
    mism, err, hits = compare(got, ref, alive[pick], f"{label} bounce 1")
    if err:
        raise AssertionError(f"{label} bounce 1: max |dt| {err}")
    ms = cuda_ms(lambda: hit(scene, o, d, 1e-4, alive), 20)
    return (f"{label} bounce-1 wavefront ({int(alive.sum())} of "
            f"{o.shape[0]} lanes live; {PROBE_RAYS}-ray sample vs plain "
            f"{mism} mism, {hits} hits, max |dt| {err}): kernel {ms:.3f} ms")


def first_shadow_wavefront(scene, cam, params):
    """The any-hit arguments of the first shadow query of one frame of the
    NEE path, bounce 0's: (scene, o, d, t_min, t_max, alive)."""
    seen, real = [], renderer.occluded

    def spy(scene, o, d, t_min, backend, alive):
        seen.append((scene, o, d, t_min, ah.SHADOW_T_MAX, alive))
        return real(scene, o, d, t_min=t_min, backend=backend, alive=alive)

    renderer.occluded = spy
    try:
        render_frame(scene, rt.camera_basis(cam), params, 0)
    finally:
        renderer.occluded = real
    return seen[0]


def random_mesh(device, n_tris=2400, seed=3):
    """n_tris random triangles with random materials and six spheres (the
    random mesh of tests/test_blocked.py: 2,432 padded triangles)."""
    rng = np.random.default_rng(seed)
    b = rt.SceneBuilder()
    for _ in range(n_tris):
        c = rng.normal(size=3) * 4.0
        v = c + rng.normal(size=(3, 3))
        n = np.cross(v[1] - v[0], v[2] - v[0])
        n /= max(np.linalg.norm(n), 1e-9)
        b.add_mesh([tuple(x) for x in v], [tuple(n)] * 3, [0, 1, 2],
                   albedo=tuple(rng.random(3)),
                   smoothness=float(rng.random()))
    for _ in range(6):
        b.add_sphere(tuple(rng.normal(size=3) * 4.0), 0.5 + rng.random(),
                     albedo=tuple(rng.random(3)))
    return b.build(device=device)


def tied(scene, n):
    """``scene`` with triangles [n, 2n) made copies of [0, n): a ray that
    hits one of a pair hits the other at the same t (n = 512: in the next
    super; n = 1024: in the next 1024-triangle block)."""
    fields = {f.name: getattr(scene, f.name)
              for f in dataclasses.fields(scene)}
    for k, v in fields.items():
        if k.startswith("tri_") and isinstance(v, torch.Tensor):
            v = v.clone()
            v[n:2 * n] = v[0:n]
            fields[k] = v
    return dataclasses.replace(scene, **fields)


def random_rays(n, seed, device, spread=8.0):
    """n rays with normal origins (spread ``spread``) and directions."""
    g = np.random.default_rng(seed)
    o = torch.from_numpy(g.normal(size=(n, 3)) * spread).float()
    return o.to(device), torch.from_numpy(g.normal(size=(n, 3))).float().to(
        device)


def secondary_rays(scene, n, seed, device):
    """n rays as a bounce leaves them: origins uniform inside the bounds of
    the scene's real triangles, random directions."""
    g = np.random.default_rng(seed)
    k = scene.num_tris
    pts = torch.cat([scene.tri_v0[:k], scene.tri_v1[:k], scene.tri_v2[:k]])
    lo, hi = pts.amin(0), pts.amax(0)
    u = torch.from_numpy(g.random((n, 3))).float().to(device)
    return (lo + u * (hi - lo)).contiguous(), torch.from_numpy(
        g.normal(size=(n, 3))).float().to(device)


def anyhit_cases(device):
    """The any-hit kernel against its plain version on the scenes of the
    streaming kernel's card test: the random mesh, its copies tied across
    blocks and across supers, and the terrain at n=60, on 4096 random and
    4096 secondary rays (70% alive), segments as they are and scaled by
    0.1: 0 mismatches → report text."""
    mesh = random_mesh(device)
    scenes = {"mesh": mesh, "tied": tied(mesh, 1024),
              "tied-supers": tied(mesh, 512),
              "terrain60": terrain_scene(device, n=60)[0]}
    alive = torch.from_numpy(np.random.default_rng(18).random(4096)
                             < 0.7).to(device)
    report = []
    for name, scene in scenes.items():
        for kind, (o, d) in (("random", random_rays(4096, 17, device)),
                             ("secondary", secondary_rays(scene, 4096, 19,
                                                          device))):
            for scale in (1.0, 0.1):
                got = ah.anyhit(scene, o, d * scale, 1e-4, ah.SHADOW_T_MAX,
                                alive)
                want = ah.anyhit_reference(scene, o, d * scale, 1e-4,
                                           ah.SHADOW_T_MAX, alive)
                mism = int((got != want).sum())
                if mism or bool(got[~alive].any()):
                    raise AssertionError(f"any-hit {name} {kind} x{scale}: "
                                         f"{mism} mismatches")
                report.append(f"{name} {kind}{'' if scale == 1.0 else ' x0.1'}"
                              f" {int(got.sum())} blocked")
    return "; ".join(report)


def phase2c_anyhit_vs_plain(device, terrain, terrain_nee):
    scenes = {name: rt.builtin_scene(name, aspect=W / H, device=device)
              for name in ("room", "metal", "random_balls")}
    scenes["terrain"], scenes["terrain_nee"] = terrain, terrain_nee
    report = []
    for si, (name, (scene, cam)) in enumerate(scenes.items()):
        o, d, alive = shadow_segments(scene, cam, PROBE_RAYS, si, device)
        for scale in (1.0, 0.1):
            got = ah.anyhit(scene, o, d * scale, 1e-4, ah.SHADOW_T_MAX,
                            alive)
            want = ah.anyhit_reference(scene, o, d * scale, 1e-4,
                                       ah.SHADOW_T_MAX, alive)
            mism = int((got != want).sum())
            if mism or bool(got[~alive].any()):
                raise AssertionError(f"any-hit {name} x{scale}: {mism} "
                                     f"mismatches, dead lanes blocked: "
                                     f"{bool(got[~alive].any())}")
            report.append(f"{name}{'' if scale == 1.0 else ' x0.1'} {mism} "
                          f"mism {int(got.sum())}/{int(alive.sum())} "
                          f"blocked")
    print(f"phase 2c any-hit vs plain ({PROBE_RAYS} segments): "
          + "; ".join(report) + " | 0 mism each on 4096 rays (70% alive): "
          + anyhit_cases(device), flush=True)

    # the main path's shape: terrain_nee's 1080p bounce-0 shadow wavefront
    scene, cam = terrain_nee
    args = first_shadow_wavefront(scene, cam,
                                  rt.RenderParams(**PARAMS, **NEE))
    _, o, d, t_min, t_max, alive = args
    got, want = ah.anyhit(*args), ah.anyhit_reference(*args)
    mism = int((got != want).sum())
    if mism or bool(got[~alive].any()):
        raise AssertionError(f"any-hit 1080p shadow wavefront: {mism} "
                             f"mismatches")
    b4 = bh.nearest_hit_blocked(scene, o, d, t_min, alive, False)[0] < t_max
    b4_mism = int((got != b4).sum())
    if b4_mism > MAX_ID_MISMATCHES:
        raise AssertionError(f"any-hit vs streaming without rows on the 1080p "
                             f"shadow wavefront: {b4_mism} mismatches")
    ms = cuda_ms(lambda: ah.anyhit(*args), 20)
    b4_ms = cuda_ms(lambda: bh.nearest_hit_blocked(scene, o, d, t_min, alive,
                                                   False), 20)
    plain_ms = cuda_ms(lambda: ah.anyhit_reference(*args), 1)
    work = anyhit_work(scene, o, d, alive, t_min, t_max)
    # rays (o, d, alive: 25 bytes) in, one bool out; the sphere, geometry
    # and box planes once
    nbytes = o.shape[0] * 26 + plane_bytes(scene, attrs=False)
    b, flat = work_bound(nbytes, work), work_bound(nbytes, work, False)
    lib, planes = ah._library(), ch.scene_planes(scene)
    shape = (planes.n_clusters, planes.sup.shape[0])
    print(f"phase 2c main-path shape (terrain_nee {W}x{H} bounce-0 shadow "
          f"rays, {int(alive.sum())} live, {int(got.sum())} blocked, {mism} "
          f"mism): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, streaming "
          f"without rows {b4_ms:.3f} ms ({b4_mism} mism); "
          f"{lib.rtt_anyhit_shared_bytes(*shape)} B of shared memory a "
          f"block, {lib.rtt_anyhit_blocks_per_sm(*shape)} blocks an SM; "
          f"tested {work['spheres']} sphere pairs, {work['supers']} super "
          f"boxes, {work['clusters']} cluster boxes, {work['pairs']} triangle "
          f"pairs: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({b['bytes']} B, {b['ops']} f32 ops); the sweep without supers "
          f"{work['flat_clusters']} boxes, {work['flat_pairs']} pairs: bound "
          f"{flat['bound_ms']:.4f} ms by {flat['bound_by']}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, plain_rays=o.shape[0],
                max_abs_err=0.0, mismatches=mism, library_ms=None, **b)


def train_setup(scene, cam):
    """The training path's step at the main path's settings: Adam over
    DEFAULT_TRAINABLE (``train_optimizer``), from the scene with its
    albedos scaled by ALBEDO_START towards frame 0 of the true scene →
    (step_fn, its first arguments: trainable, opt, start, basis, target,
    frame)."""
    params = rt.RenderParams(**PARAMS)
    basis = rt.camera_basis(cam)
    with torch.no_grad():  # the same frame, so the same sample streams
        target = render_frame(scene, basis, params, 0)
    start = dataclasses.replace(
        scene, tri_albedo=scene.tri_albedo * ALBEDO_START,
        sphere_albedo=scene.sphere_albedo * ALBEDO_START)
    init_fn, step_fn = make_train_step(params, train_optimizer)
    trainable, opt = init_fn(start, DEFAULT_TRAINABLE)
    return step_fn, (trainable, opt, start, basis, target, 0)


def train_path(label, scene, cam, card, steps, hit, profile, out_dir):
    """The training path: ``grad.make_train_step`` over DEFAULT_TRAINABLE
    at the main path's settings, from the scene with its albedos scaled by
    ALBEDO_START towards frame 0 of the true scene; one warm-up step and
    ``steps`` timed steps, each driven with every launch count at 0 and
    held to bounces + 1 launches of the ``hit`` kernel and of the
    scatter-add and to one packing of the scene's planes (the optimizer
    moved the scene); gradients finite, tri_v0's and tri_albedo's not all zero,
    the last loss below the first → (line, the launches summed over all
    steps)."""
    step_fn, (trainable, opt, start, basis, target, _) = train_setup(scene,
                                                                     cam)
    per_step = launches(**{hit: BOUNCES + 1, "scatter_rows": BOUNCES + 1})
    totals = dict.fromkeys(per_step, 0)
    losses, device_s, host_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(1 + steps):                   # step 0 warms up
        reset_counts()
        packs = ch.scene_planes.packs
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        trainable, opt, loss = step_fn(trainable, opt, start, basis, target,
                                       0)
        ev1.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != per_step:
            raise AssertionError(f"{label} step {step}: launches {counts}, "
                                 f"want {per_step}")
        if ch.scene_planes.packs != packs + 1:
            raise AssertionError(
                f"{label} step {step}: the optimizer moved the scene, so the "
                f"step must pack its planes once; it packed "
                f"{ch.scene_planes.packs - packs} times")
        totals = {k: totals[k] + counts[k] for k in totals}
        losses.append(float(loss))
        if step:
            device_s.append(ev0.elapsed_time(ev1) / 1e3)
            host_s.append(enqueue)
    peak = torch.cuda.max_memory_allocated()
    for k, p in trainable.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{label}: gradient of {k} is missing or "
                                 f"not finite")
    for k in ("tri_v0", "tri_albedo"):
        if not bool(trainable[k].grad.any()):
            raise AssertionError(f"{label}: gradient of {k} is all zero")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    med = float(np.median(device_s))
    segs = W * H * 1 * (BOUNCES + 1)
    line = (f"{label} {scene.num_tris} tris {W}x{H} b{BOUNCES} Adam "
            f"({ALBEDO_LR} albedos, {GEOMETRY_LR} geometry) over "
            f"{len(trainable)} leaves, whole-frame gradient: {med:.4f} s/step "
            f"median ({len(device_s)} steps "
            f"{[round(x, 4) for x in device_s]} s, spread "
            f"{(max(device_s) - min(device_s)) / min(device_s):.2%}), "
            f"{segs / med / 1e6:.3f} M segments/s forward+backward; peak "
            f"memory {peak / 2 ** 30:.3f} GiB; host enqueue "
            f"{float(np.median(host_s)):.4f} s vs device {med:.4f} s per "
            f"step; {totals[hit]} {hit} + {totals['scatter_rows']} "
            f"scatter_rows launches ({BOUNCES + 1} + {BOUNCES + 1} per step); "
            f"loss {losses[0]:.6g} -> {losses[-1]:.6g} | {card}")
    if profile:
        profile_step(step_fn, trainable, opt, start, basis, target, med, hit,
                     out_dir)
    return line, totals


def phase5_training(device, terrain, card, profile, out_dir):
    line, totals = train_path("terrain", *terrain, card, TRAIN_STEPS,
                              "closest_hit", profile, out_dir)
    print(f"phase 5 training path: {line}", flush=True)
    return totals["scatter_rows"]


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
                 hit, out_dir):
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

    hit_us, scatter_us = us(hit), us("scatter_rows")
    if out_dir:
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(os.path.join(out_dir, "chip_smoke_profile_train.txt"),
                  "w") as f:
            f.write(table)
    print(f"profile: training step {len(kernels)} device kernels busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e6 / step_s:.1%} of the "
          f"median step's {step_s * 1e3:.3f} ms); {hit} {hit_us} us, "
          f"scatter_rows {scatter_us} us "
          f"({(sum(hit_us) + sum(scatter_us)) / max(busy_us, 1):.1%} of "
          f"device time)", flush=True)


def grad_parity(scene, cam, params, size=(256, 144)):
    """Whole-frame MSE gradients of every float leaf at ``size`` through
    the kernels (backend "cuda") and the plain oracle ("torch") on the same
    CUDA tensors → (image equal, image max |diff|, each leaf's max |g|,
    largest max |diff| / max |g|, its leaf). Raises where a leaf breaks the
    gate."""
    basis = rt.camera_basis(cam.replace(aspect=size[0] / size[1]))
    params = params.replace(width=size[0], height=size[1])
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
    worst, worst_leaf, scales = 0.0, None, {}
    for k in fields:
        scale = scales[k] = float(g_p[k].abs().max())
        err = float((g_k[k] - g_p[k]).abs().max())
        if err > GRAD_PARITY * scale:
            raise AssertionError(f"gradient parity: {k} differs by {err} "
                                 f"(max |g| {scale})")
        if scale and err / scale >= worst:
            worst, worst_leaf = err / scale, k
    return (torch.equal(img_k, img_p), float((img_k - img_p).abs().max()),
            scales, worst, worst_leaf)


def phase6_grad_parity(device, terrain):
    equal, diff, scales, worst, leaf = grad_parity(
        *terrain, rt.RenderParams(**PARAMS))
    if not equal:
        raise AssertionError(f"gradient parity: the two images differ by "
                             f"{diff}")
    print(f"phase 6 gradient parity (terrain 256x144 b{BOUNCES}, cuda vs "
          f"torch, {len(scales)} float leaves, "
          f"{sum(v > 0 for v in scales.values())} with a gradient): images "
          f"equal; largest max |diff| / max |g| {worst:.3g} ({leaf}; gate "
          f"{GRAD_PARITY})", flush=True)


def phase6b_nee_grad_parity(device, terrain_nee):
    equal, diff, scales, worst, leaf = grad_parity(
        *terrain_nee, rt.RenderParams(**PARAMS, **NEE))
    emitting = {k: scales[k] for k in (
        "tri_emission", "tri_emission_strength", "sphere_emission",
        "sphere_emission_strength")}
    if not all(emitting.values()):
        raise AssertionError(f"gradient parity with NEE: an emission leaf "
                             f"has no gradient: {emitting}")
    print(f"phase 6b gradient parity with NEE (terrain_nee 256x144 "
          f"b{BOUNCES}, cuda vs torch, {len(scales)} float leaves, "
          f"{sum(v > 0 for v in scales.values())} with a gradient; emission "
          f"leaves' max |g| {emitting}): images equal {equal} (max |diff| "
          f"{diff}); largest max |diff| / max |g| {worst:.3g} ({leaf}; gate "
          f"{GRAD_PARITY})", flush=True)


def nee_render(phase, name, scene, cam, params, want, card, profile,
               out_dir):
    """A NEE path on one scene: ``render_path`` held to ``want``, then,
    ungated, the image mean against a ``nee=False`` render of the same
    frames → the launch counts of the checked render."""
    img, counts, runs, enqueue_s = render_path(f"{name} NEE", scene, cam,
                                               params, want)
    basis = rt.camera_basis(cam)
    plain = render_progressive(scene, basis, params.replace(nee=False),
                               FRAMES)
    segs = W * H * (BOUNCES + 1) * FRAMES
    print(f"phase {phase} NEE path: {name} {scene.num_tris} tris {W}x{H} "
          f"b{BOUNCES} {FRAMES} frames nee+mis skybox={params.skybox}: "
          f"{rate_text(runs, segs)}; host enqueue {enqueue_s:.4f} s of the "
          f"first); {counts['closest_hit']} closest-hit, "
          f"{counts['blocked_hit']} streaming ({counts['blocked_hit_ids']} "
          f"without rows), {counts['any_hit']} any-hit, "
          f"{counts['scatter_rows']} scatter-add launches; image mean "
          f"{float(img.mean()):.5f} vs {float(plain.mean()):.5f} with "
          f"nee=False (same frames, ungated) | {card}", flush=True)
    if out_dir:
        np.save(os.path.join(out_dir, f"chip_smoke_{name}.npy"),
                img[::4, ::4].cpu().numpy())
    if profile:
        profile_frame(name, scene, basis, params, out_dir)
    return counts


def phase7_nee_path(device, terrain_nee, card, profile, out_dir):
    params = rt.RenderParams(**PARAMS, **NEE)
    if resolved_backend(params, terrain_nee[0]) != "cuda":
        raise AssertionError("backend 'auto' did not resolve to cuda")
    want = launches(closest_hit=FRAMES * (BOUNCES + 1),
                    any_hit=FRAMES * BOUNCES)
    counts = nee_render("7", "terrain_nee", *terrain_nee, params, want, card,
                        profile, out_dir)
    room = rt.builtin_scene("room", aspect=W / H, device=device)
    nee_render("7", "room", *room, params.replace(skybox=False), want, card,
               profile, None)
    return counts["any_hit"]


def past_64_blocks(device, huge):
    """The streaming kernel on a scene of more than one round of block
    boxes: the heightfield at n=520 (538,722 triangles, 66 blocks of
    8192) against its plain version on 16,384 rays of its 1080p primary
    wavefront and 16,384 secondary rays (0 mismatches, t and rows
    bit-equal), the whole wavefront timed; and the any-hit kernel's
    refusal of it (its boxes exceed shared memory) → report text."""
    scene, cam = huge
    o, d = primary_wavefront(scene, cam, device)
    alive = torch.ones(W * H, dtype=torch.bool, device=device)
    pick = torch.from_numpy(np.random.default_rng(7).choice(
        W * H, 16_384, replace=False)).to(device)
    so, sd = secondary_rays(scene, 16_384, 23, device)
    report = []
    for kind, (po, pd) in (("primary", (o[pick], d[pick])),
                           ("secondary", (so, sd))):
        live = alive[:po.shape[0]]
        got = bh.nearest_hit_blocked(scene, po, pd, 1e-4, live)
        ref = bh.nearest_hit_blocked_reference(scene, po, pd, 1e-4, live)
        torch.cuda.synchronize()
        mism, err, hits = compare(got, ref, live, f"66 blocks {kind}")
        if mism:
            raise AssertionError(f"66 blocks {kind}: {mism} mismatches")
        report.append(f"{kind} 0 mism {hits} hits")
    ms = cuda_ms(lambda: bh.nearest_hit_blocked(scene, o, d, 1e-4, alive), 10)
    before, refused = ah.anyhit.launches, ""
    try:
        ah.anyhit(scene, so, sd)
    except ValueError as e:
        refused = str(e)
    if "shared memory" not in refused or ah.anyhit.launches != before:
        raise AssertionError(f"any-hit took a scene whose boxes exceed "
                             f"shared memory: {refused!r}")
    _, n_clusters, n_blocks = bh.block_layout(scene)
    return (f"{scene.num_tris} tris, {n_blocks} blocks of {bh.BLOCK} "
            f"({n_clusters} clusters): " + "; ".join(report)
            + f" against plain on 16384 rays each; {W}x{H} primary "
            f"wavefront {ms:.3f} ms; any-hit refuses it ({refused})")


def phase2d_blocked_vs_plain(device, terrain, large, large_nee, huge):
    cases = [(name, rt.builtin_scene(name, aspect=W / H, device=device),
              bh.BLOCK) for name in ("room", "metal", "random_balls")]
    cases += [("terrain", terrain, bh.BLOCK), ("terrain/1024", terrain, 1024),
              ("terrain190k", large, bh.BLOCK)]
    report, max_err = [], 0.0
    for si, (name, (scene, cam), block) in enumerate(cases):
        o, d, alive = probe_inputs(scene, cam, PROBE_RAYS, si, device)
        for want_attrs in (True, False):
            got = bh.nearest_hit_blocked(scene, o, d, 1e-4, alive,
                                         want_attrs, block)
            ref = bh.nearest_hit_blocked_reference(scene, o, d, 1e-4, alive,
                                                   want_attrs, block)
            torch.cuda.synchronize()
            mism, err, hits = compare(got, ref, alive,
                                      f"streaming {name} attrs={want_attrs}")
            max_err = max(max_err, err)
            report.append(f"{name}{'' if want_attrs else '/ids'} {mism} mism "
                          f"{hits} hits")
    del got, ref
    # o, d, alive are terrain190k's probe rays, the last case's
    probe_ms = cuda_ms(lambda: bh.nearest_hit_blocked(
        scene, o, d, 1e-4, alive), 20)
    plain_ms = cuda_ms(lambda: bh.nearest_hit_blocked_reference(
        scene, o, d, 1e-4, alive), 1)
    print(f"phase 2d streaming kernel vs plain ({PROBE_RAYS} rays): "
          + "; ".join(report) + f" | terrain190k {PROBE_RAYS} rays: kernel "
          f"{probe_ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)

    # the main path's shape: the 1080p primary wavefronts (blocked pixel
    # order), streaming vs closest-hit kernel, at 16k and at 190k triangles
    alive = torch.ones(W * H, dtype=torch.bool, device=device)
    side = {}
    for name, (scene, cam) in (("terrain", terrain), ("terrain190k", large)):
        o, d = primary_wavefront(scene, cam, device)
        got = bh.nearest_hit_blocked(scene, o, d, 1e-4, alive)
        ref = ch.nearest_hit_attrs(scene, o, d, 1e-4, alive)
        torch.cuda.synchronize()
        mism, err, hits = compare(got, ref, alive, f"{name} 1080p primary: "
                                  f"streaming vs closest-hit kernel")
        max_err = max(max_err, err)
        del got, ref
        b4 = wrapper_ms(lambda: bh.nearest_hit_blocked(
            scene, o, d, 1e-4, alive), scene)
        b1 = wrapper_ms(lambda: ch.nearest_hit_attrs(
            scene, o, d, 1e-4, alive), scene, 10)
        side[name] = dict(mism=mism, hits=hits, b4=b4, b1=b1)
    # o, d are terrain190k's; rays (o, d, alive: 25 bytes) in, t, id and the
    # 26-column row out; the sphere, geometry, attribute and box planes once
    nbytes = W * H * (25 + 4 * (2 + 26)) + plane_bytes(scene, bh.BLOCK)
    work = blocked_traversal_work(scene, o, d, alive)
    b = work_bound(nbytes, work)
    # a ray-per-thread traversal without supers, every lane in its own order
    lone = blocked_traversal_work(scene, o, d, alive, warp=1)
    flat = work_bound(nbytes, lone, False)
    # the closest-hit kernel sweeps every super for every live ray (it swept
    # every cluster box before it had supers)
    planes = ch.scene_planes(scene)
    b1_supers = W * H * planes.sup.shape[0]
    b1_floor = bound(0, OPS_PER_BOX * b1_supers)
    lib = bh._library()
    print(f"phase 2d main-path shape ({W}x{H} primary rays, blocked pixel "
          f"order; ms with the plane cache warm / cleared before each call "
          f"/ packing alone): " + "; ".join(
              f"{k} ({v['hits']} hits, {v['mism']} mism) streaming "
              + " / ".join(f"{x:.3f}" for x in v["b4"]) + " ms vs closest-hit "
              + " / ".join(f"{x:.3f}" for x in v["b1"]) + " ms"
              for k, v in side.items())
          + f" | streaming kernel: {lib.rtt_blocked_hit_shared_bytes()} B of "
          f"shared memory a block, {lib.rtt_blocked_hit_blocks_per_sm(1)} "
          f"blocks an SM | terrain190k streaming: tested {work['spheres']} "
          f"sphere pairs, {work['blocks']} block boxes, {work['supers']} "
          f"super boxes, {work['clusters']} cluster boxes, {work['pairs']} "
          f"triangle pairs: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({b['bytes']} B, {b['ops']} f32 ops); a ray-per-thread traversal "
          f"without supers {lone['flat_clusters']} cluster boxes, "
          f"{lone['pairs']} pairs: bound {flat['bound_ms']:.4f} ms; "
          f"closest-hit on these rays sweeps {planes.sup.shape[0]} supers a "
          f"ray ({planes.n_clusters} cluster boxes a ray before it had "
          f"supers): {b1_supers} boxes, {b1_floor['bound_ms']:.4f} ms",
          flush=True)
    print("phase 2d secondary rays: " + secondary_check(
        "streaming on terrain190k", *large, bh.nearest_hit_blocked,
        bh.nearest_hit_blocked_reference, device), flush=True)
    print("phase 2d past 64 blocks: " + past_64_blocks(device, huge),
          flush=True)

    # terrain190k_nee's 1080p bounce-0 shadow wavefront: any-hit vs the
    # streaming kernel without rows (the large-scene path's shadow query)
    scene, cam = large_nee
    args = first_shadow_wavefront(scene, cam,
                                  rt.RenderParams(**PARAMS, **NEE))
    _, o, d, t_min, t_max, alive = args
    b3 = ah.anyhit(*args)
    b4 = bh.nearest_hit_blocked(scene, o, d, t_min, alive, False)[0] < t_max
    mism = int((b3 != b4).sum())
    if mism > MAX_ID_MISMATCHES or bool(b4[~alive].any()):
        raise AssertionError(f"shadow wavefront: any-hit vs streaming "
                             f"{mism} mismatches")
    b3_ms = cuda_ms(lambda: ah.anyhit(*args), 10)
    b4_ms = cuda_ms(lambda: bh.nearest_hit_blocked(scene, o, d, t_min, alive,
                                                   False), 20)
    print(f"phase 2d shadow wavefront (terrain190k_nee {W}x{H} bounce 0, "
          f"{int(alive.sum())} live, {int(b4.sum())} blocked): any-hit vs "
          f"streaming without rows {mism} mism; any-hit {b3_ms:.3f} ms, "
          f"streaming {b4_ms:.3f} ms", flush=True)
    return dict(ms=side["terrain190k"]["b4"][0], plain_ms=plain_ms,
                plain_rays=PROBE_RAYS, max_abs_err=max_err,
                mismatches=side["terrain190k"]["mism"], library_ms=None, **b)


def phase8_large_scene(device, large, large_nee, build_s, card, profile,
                       out_dir):
    scene, cam = large
    params = rt.RenderParams(**PARAMS)
    if not bh.uses_blocked(scene) or resolved_backend(params, scene) != "cuda":
        raise AssertionError("terrain190k does not take the streaming kernel")
    img, counts, runs, enqueue_s = render_path(
        "terrain190k", scene, cam, params,
        launches(blocked_hit=FRAMES * (BOUNCES + 1)))
    segs = W * H * 1 * (BOUNCES + 1) * FRAMES
    print(f"phase 8 large-scene forward: terrain190k {scene.num_tris} tris "
          f"({scene.padded_tris} padded, {bh.block_layout(scene)[2]} blocks "
          f"of {bh.BLOCK}; both large scenes built on the host in "
          f"{build_s:.2f} s) {W}x{H} b{BOUNCES} {FRAMES} frames: {rate_text(runs, segs)}; "
          f"host enqueue {enqueue_s:.4f} s of the first), "
          f"{counts['blocked_hit']} streaming and {counts['closest_hit']} "
          f"closest-hit launches, image mean {float(img.mean()):.4f} | "
          f"{card}", flush=True)
    if out_dir:
        np.save(os.path.join(out_dir, "chip_smoke_terrain190k.npy"),
                img[::4, ::4].cpu().numpy())
    if profile:
        profile_frame("terrain190k", scene, rt.camera_basis(cam), params,
                      out_dir)
    nee_render("8", "terrain190k_nee", *large_nee,
               rt.RenderParams(**PARAMS, **NEE),
               launches(blocked_hit=FRAMES * (BOUNCES + 1) + FRAMES * BOUNCES,
                        blocked_hit_ids=FRAMES * BOUNCES),
               card, profile, out_dir)
    line, _ = train_path("terrain190k", scene, cam, card, LARGE_TRAIN_STEPS,
                         "blocked_hit", False, None)
    print(f"phase 8 large-scene training: {line}", flush=True)
    torch.cuda.empty_cache()
    off, diff = image_parity("terrain190k", scene, cam)
    equal, gdiff, scales, worst, leaf = grad_parity(
        scene, cam, params, size=(128, 72))
    print(f"phase 8 large-scene parity (terrain190k, cuda vs torch): 256x144 "
          f"image frac_off {off} (gate {PARITY_GATE}), max |diff| {diff}; "
          f"128x72 b{BOUNCES} gradient over {len(scales)} float leaves, "
          f"images equal {equal} (max |diff| {gdiff}), largest max |diff| / "
          f"max |g| {worst:.3g} ({leaf}; gate {GRAD_PARITY})", flush=True)
    return counts["blocked_hit"]


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also measure where a main-path frame's time goes")
    ap.add_argument("--out", metavar="DIR",
                    help="write the main-path image and profiler tables here")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    card = phase0_device()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    secs = {}

    def run(phase, fn, *fn_args):
        """fn(*fn_args), its seconds (to the card's end) kept under phase."""
        t0 = time.perf_counter()
        out = fn(*fn_args)
        torch.cuda.synchronize()
        secs[phase] = round(time.perf_counter() - t0, 1)
        return out

    run("1", phase1_build)
    terrain = terrain_scene(device)
    terrain_nee = terrain_scene(device, with_lights=True)
    t0 = time.perf_counter()
    large = terrain_scene(device, n=LARGE_N)
    large_nee = terrain_scene(device, n=LARGE_N, with_lights=True)
    build_s = time.perf_counter() - t0
    huge = terrain_scene(device, n=HUGE_N)
    timing = {"closest_hit": run("2", phase2_kernel_vs_plain, device,
                                 terrain),
              "scatter_rows": run("2b", phase2b_scatter_vs_plain, device,
                                  terrain),
              "any_hit": run("2c", phase2c_anyhit_vs_plain, device, terrain,
                             terrain_nee),
              "blocked_hit": run("2d", phase2d_blocked_vs_plain, device,
                                 terrain, large, large_nee, huge)}
    del huge
    torch.cuda.empty_cache()
    counts = {"closest_hit": run("3", phase3_main_path, device, terrain,
                                 card, args.profile, args.out)}
    run("4", phase4_parity, device, terrain)
    run("4b", phase4b_nee_parity, device, terrain_nee)
    counts["scatter_rows"] = run("5", phase5_training, device, terrain, card,
                                 args.profile, args.out)
    torch.cuda.empty_cache()
    run("6", phase6_grad_parity, device, terrain)
    run("6b", phase6b_nee_grad_parity, device, terrain_nee)
    torch.cuda.empty_cache()
    counts["any_hit"] = run("7", phase7_nee_path, device, terrain_nee, card,
                            args.profile, args.out)
    torch.cuda.empty_cache()
    counts["blocked_hit"] = run("8", phase8_large_scene, device, large,
                                large_nee, build_s, card, args.profile,
                                args.out)
    print(f"seconds per phase: {secs}; whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("max_abs_err", "mismatches", "ms", "plain_ms", "plain_rays",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=counts[name], **{k: timing[name][k] for k in keys})
        for name, (source, replaces) in KERNELS.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
