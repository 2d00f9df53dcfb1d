#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths (``ray_tracer_tpu_torch``) through the entry
points a user calls, and checks them: the forward render path (phase 3),
the training path (phase 5), the forward render with next-event estimation
(phase 7), all three on a large scene through the streaming kernel
(phase 8) and on textured scenes through both closest-hit kernels'
textured variants (phase 9), and the image extras: AOVs, adaptive
sampling, QMC, the denoiser, wavefront compaction and remat (phase 10),
mesh recovery from loaded models: the OBJ / glTF / GLB loaders, the
edge-sampled boundary gradients and the per-vertex recovery loop
(phase 11), and multi-device rendering and training on
``torch.distributed``, the command line, the viewer, the differentiable
camera and the metrics (phase 12), and the rigid recovery loop with the
repairs of the renderer's safe points and of the plane cache's lifetime
(phase 13). It imports nothing of JAX. Each path is
driven with the kernels' launch counts set to 0 just before it and read
just after. On untextured scenes each closest-hit launch that copies rows
out brings one launch of the hit-record kernel (the winner recompute), and
each backward through it one of its VJP kernel, as many as the
scatter-add's: every count below holds them so, and the textured paths
to none.
Phases, each printing one line (phase 1 one per kernel):

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. builds the kernel libraries from the repository's sources, one
     nvcc each, started together, and prints ptxas's registers (by
     template arguments <want_attrs, textured>), stack frames and spills;
     the traversal kernels (closest hit, streaming closest hit, any hit)
     must show 0-byte stack frames and no spills, and their untextured
     instantiations the registers they had before the textured variants
     (REGISTERS, within 3);
  2. kernel vs its plain PyTorch version on the card, 65,536 rays on each
     of room, metal, random_balls and terrain (camera + random rays, about
     half of them dead), both want_attrs variants: at most 2 id mismatches
     per scene, t and rows bit-equal where ids agree, dead and miss lanes
     (inf, 0, zero row); then both timed at the main path's shape (the
     1920x1080 primary wavefront on terrain), the kernel through its
     wrapper with the scene's planes cached (what a render's launch pays:
     phases 2 to 2e run in one plane scope) and with the cache cleared
     before each call (what each call's first launch pays), with the
     packing alone, the kernel's shared
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
     finite and not constant; no other kernel but the hit-record kernel,
     once a segment, may launch on this forward path (the scene is below
     the streaming kernel's crossover), and the render must pack the
     scene's planes exactly once (they live one top-level call; so in
     phases 7, 8 and 9);
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
     two kernel runs were bit-equal; the same gate on the real bounce-0
     cotangents of a texture-recovery step on terrain_tex (40 columns);
     and the row-major form on what that step's texture-fetch backward
     hands it (bounce 0's albedo fetch: 2,073,600 lanes x 12 columns into
     the 524,288-row quad table), timed beside its plain version,
     ``index_add_`` and autograd's own transpose of the gather;
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
  2e. (run before 3) the textured variants of the closest-hit and
     streaming kernels against their plain versions on 65,536 probe and
     65,536 secondary rays of terrain_tex (the terrain with UVs repeating
     8 times, a 512x512 sRGB albedo map and a normal map) and of
     terrain190k_tex, and of copies tied across supers and blocks (the
     streaming kernel at blocks of 8192 and 1024): 0 mismatches in t, ids
     and all 40 row columns; then on the 1080p primary wavefronts beside
     the untextured variants on the untextured terrains (the same
     triangles in the same order): the same t and ids, the first 26
     columns equal, all 40 the winners' table rows; ms warm, cleared and
     packing (textured, textured, untextured, untextured), the bound with
     the 40-column row and 48-column planes, registers, shared memory and
     blocks per SM;
  2f. (run before 3) the hit-record kernels (``ops/hit_record.py``) on the
     closest-hit kernel's winners of terrain's 1080p primary wavefront and
     of a main-path frame's bounce-1 wavefront (dead lanes too): the
     forward's eight outputs bit-equal to
     ``intersect.hit_attributes_from_rows``, the VJP through
     ``intersect._HitRecord`` within rtol 1e-5 plus 2e-4 x the largest
     cotangent of ``torch.autograd.grad`` through it (seeded cotangents on
     all seven float outputs), plus that autograd's own distance from the
     same in float64 on each entry (a ray grazing a sphere moves by more
     under the forward's float32 rounding); each timed beside its plain
     version, with
     its bound from the lanes' own ids (26 row columns read on a triangle
     lane, 12 on the others);
  2g. the viewer's sRGB encode kernel (``ops/srgb_encode.py``) at 800x800
     and 1920x1080 (values over [-0.25, 1.25], the level thresholds to 2
     ulp, NaN and inf): ``to_uint8`` of the card image launches it once
     and returns the numpy encode's bytes, as ``torch.searchsorted`` over
     the same thresholds does; its device time (launches queued behind a
     spin of the card) beside its bound of 5 bytes a value, its host time
     a launch, ``to_uint8`` with its pinned copy, the numpy path after a
     blocking copy, and the library search's device and host time;
  4. path parity: one 256x144 frame through the kernel and through the
     plain oracle (backend "torch") on the same CUDA tensors; the fraction
     of pixels off by more than 2e-2 must be below 2e-3;
  4b. the same gate with NEE, on terrain_nee and room, each with nee, nee
     without MIS, and nee with Russian roulette from segment 1;
  5. the training path: ``grad.make_train_step`` over
     ``DEFAULT_TRAINABLE`` (Adam, 1e-2 on the albedos and 1e-4 on the
     geometry: ``train_optimizer``) at the main path's settings (terrain
     1920x1080, bounces=3), from the scene with its albedos scaled by 0.8
     towards the same frame of the true scene; six steps. Each step must
     launch the closest-hit and the scatter-add kernel bounces + 1 times
     each and pack the scene's planes exactly once (the optimizer moved
     the scene; so in phase 8), every gradient must be finite, tri_v0's
     and tri_albedo's not all zero, and the last loss below the first;
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
     and not constant; then the same for the room scene at 1080p without
     the sky;
  8. the large-scene path on terrain190k (built on the host), past the
     crossover: the forward render at phase 3's settings (streaming-kernel
     launches +32, closest-hit +0), the NEE render on terrain190k_nee
     (streaming +32 with rows and +24 without, any-hit +0), four training
     steps (streaming and scatter-add launches 4 each per step, gradients
     finite, the last loss below the first), image parity at 256x144
     against the plain oracle (backend "torch"; fraction off below 2e-3)
     and gradient parity at 128x72 (per leaf max |diff| <= 1e-4 x max
     |g|);
  9. the textured paths: ``render_progressive`` of terrain_tex at phase
     3's settings (32 launches of the closest-hit kernel's textured
     variant, no other kernel) and of terrain190k_tex (32 of the streaming
     kernel's); the NEE render of terrain_tex with terrain_nee's emitters
     (32 textured closest-hit, 24 any-hit); 256x144 image parity; four
     texture-recovery steps
     (Adam 1e-2 over the albedos and the texture stack, from both scaled
     by 0.8: 4 textured closest-hit, 4 scatter-add and 7 row-major
     scatter-add launches a step, one packing, the loss falls, the
     texture gradient nonzero); gradient parity at 128x72 over every
     float leaf, the texture stack and the UVs included, all finite;
  10. the image extras, at phase 3's settings on terrain unless named:
     every AOV (``render_aov``) at 1920x1080 on terrain, terrain190k and
     terrain_tex, each call launching its closest-hit kernel (the
     streaming one on terrain190k, the textured variant on terrain_tex)
     once and no other kernel; the AOVs through the kernels
     against the plain path on the same tensors at 256x144 and at
     250x142 (not a whole number of 16x8 blocks): coverage equal, depth,
     normal and albedo within rtol 3e-4 / atol 1e-5 on hit pixels; the
     gradient of the 256x144 depth AOV's sum over every float leaf
     through the closest-hit kernel and the scatter-add against the plain
     path (the phase 6 gate, tri_v0's nonzero); ``render_adaptive`` at
     target 0 over 16 frames in chunks of 8 (16 x (bounces + 1)
     closest-hit launches, the mean within rtol 1e-4 / atol 1e-6 of
     ``render_progressive`` of the same frames) and, ungated, at target
     0.05 (frames used); the 8-frame ``qmc=True`` render as in phase 3;
     ``denoise_render`` on a 1-frame render without coherent scatter
     (finite, mean within 5%, the mean |difference between rows| below 0.6
     of the input's); wavefront
     compaction ("octant" and "morton"): with coherent scatter off each
     compacted frame bit-equal to the uncompacted one on terrain,
     terrain190k and terrain_nee (NEE + MIS); the closest-hit kernel on
     terrain's four wavefronts, the streaming kernel on terrain190k's and
     the any-hit kernel on terrain_nee's bounce-0 and bounce-1 shadow
     wavefronts, each timed unsorted and in each compaction's order on
     the same rays (the same results required), with the sort's ms (and
     on int64 keys), with the gathers of a segment's tensors, and the
     live share; the 256x144 training gradient with each compaction
     against without (coherent scatter off, the phase 6 gate); and one
     1080p training gradient with ``remat=True`` against without: the
     forward image bit-equal, every gradient within rtol 1e-3 / atol
     1e-7, then the hit-record and hit-record VJP launches of a
     ``make_train_step`` step of each.
  11. mesh recovery and model loading (after 10), model files written by
     the script into build/chip_smoke_models/: the terrain190k heightfield
     as an OBJ, a closed torus of the teapot's scale (R 1, r 0.4, 112 x 70
     quads: 7,840 vertices, 15,680 triangles) as an OBJ with an MTL whose
     map_Kd is a PNG (written by the port's codec) and as a GLB with the
     PNG embedded. Loading: the OBJs through the native parser (which
     must build here) and the Python one, equal; the loaded OBJ (190,962
     triangles) and the textured GLB rendered at phase 3's settings (32
     streaming launches, 32 textured closest-hit launches, no other
     kernel) and held to the plain path at 256x144 (the phase 4 gate). Edge gradients: ``gradients_from_draws`` through the
     kernels against the plain path on the same draws (the per-leaf
     phase 6 gate) on the torus at 128x128 (a 10%-perturbed torus against
     the truth, its MSE cotangent, 4,096 edge samples, topology on) and on
     terrain at 1080p (albedos x 0.8, 4,096 edge and 4,096 sphere samples),
     2 side traces x (bounces + 1) closest-hit launches a sample family;
     four 1080p terrain training steps with ``edge_samples=4096`` and the
     topology (24 closest-hit and 4 scatter-add launches and one packing a
     step, gradients finite). Recovery: ``run_vertex_recovery`` at the
     reference CPU test's configuration (the octasphere at subdivision 2,
     64x64, 4 views, 300 steps, 1,024 edge samples, lambda 2, frame
     cycle 2, start RMS 10% of the extent), held to that test's bars
     (offset RMS < 0.02 of the extent, albedo error < 0.03, last loss <
     0.1 x the first); then BASELINE config 5 (its 600 steps cut to 400
     to keep the phase near 90 s; 128x128, 6 views, 4,096 edge samples,
     lambda 50, smooth weight 0.08) on the torus loaded from its OBJ,
     its RMS and albedo error printed beside the reference's bars
     (< 0.01, < 0.05; ungated); both with their launches held to what the
     loop makes (per step 2 + 1 + 4 closest-hit and 2 + 2 scatter-add
     launches; the targets and coverage masks before the loop) and one
     packing a step, finite and the last cycle of views' loss below the
     first's; packings and launches a step printed.
  12. multi-device rendering and training, the command line, the viewer
     (one packing and one sRGB encode launch per frame, each frame's bytes
     equal to the numpy encode of its accumulation), the camera pose and
     the metrics (see the section's functions).
  13. the rigid recovery loop (after 12): ``invert_teapot.run_recovery``
     on the reference CPU test's cube (12 triangles padded to 128, 64x64,
     rpp 2, bounces 1, 100 steps from 0.12 x ext x (1, -0.6, 0.4) and
     albedo (0.35, 0.6, 0.55)), held to that test's bars (offset error <
     0.02 of the extent, albedo error < 0.05, last loss < 0.05 x the
     first); then the recorded teapot run's settings (192x192, rpp 2, 300
     steps, the tool's default start) on phase 11's torus through
     ``recovery_setup``, held to the reference's recovered bars (offset
     error < 0.02, albedo error < 0.05) and printed beside its three TPU
     runs' errors; both with the launches the loop makes (one coverage
     AOV before the loop, then per step 8 x rpp x (bounces + 1) + 1
     closest-hit and rpp x (bounces + 1) scatter-add launches: 33 and 4),
     1 + 8 packings a step; then C.2
     (``render_progressive(chunk=2, resilient=True)`` and
     ``render_adaptive(resilient=True)`` bit-equal to the default calls on
     terrain at phase 3's settings) and C.1 (a ``.data`` write to
     terrain's tri_v0 between two kernel frames changes the second, which
     equals a fresh copy's).

Then it prints the seconds each phase took, the kernels' JSON line (the
four kernels, the scatter-add's row-major form on the texture fetch's
backward, the two textured variants, the hit-record kernels and the sRGB
encode (its launches: phase 12's viewer frames), with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its operations, counted on this
run's inputs, over 67 TFLOP/s f32; and the rays its plain version was
timed on) and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. The times are the kernels' alone: the end-to-end
metrics of the paths (frame rates, step times, memory) are the
benchmark's (``rtbench/``, ``BENCHMARK.json``).

Usage: python3 chip_smoke.py
"""

import argparse
import dataclasses
import json
import math
import os
import re
import socket
import struct
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

import ray_tracer_tpu_torch as rt
from ray_tracer_tpu_torch import cli, lights, renderer, sampling, viewer
from ray_tracer_tpu_torch.grad import DEFAULT_TRAINABLE, make_train_step
from ray_tracer_tpu_torch.grad import edges, topology
from ray_tracer_tpu_torch.io import loaders
from ray_tracer_tpu_torch.io.image import srgb_thresholds, to_uint8
from ray_tracer_tpu_torch.io.png import decode_png, encode_png
from ray_tracer_tpu_torch.ops import anyhit as ah
from ray_tracer_tpu_torch.ops import blocked_hit as bh
from ray_tracer_tpu_torch.ops import closest_hit as ch
from ray_tracer_tpu_torch.ops import hit_record as hr
from ray_tracer_tpu_torch.ops import intersect
from ray_tracer_tpu_torch.ops import scatter_rows as sc
from ray_tracer_tpu_torch.ops.srgb_encode import srgb_encode
from ray_tracer_tpu_torch.parallel import (distributed, make_mesh,
                                           render_frame_distributed)
from ray_tracer_tpu_torch.renderer import (_blocked_ids, render_frame,
                                           render_progressive,
                                           resolved_backend)
from ray_tracer_tpu_torch.scene import TENSOR_FIELDS
from ray_tracer_tpu_torch.tools import invert_teapot, invert_vertices
from ray_tracer_tpu_torch.utils import build, native
from ray_tracer_tpu_torch.utils.metrics import StageTimer

W, H, FRAMES, BOUNCES = 1920, 1080, 8, 3
PARAMS = dict(width=W, height=H, bounces=BOUNCES, rays_per_pixel=1,
              skybox=True, coherent_scatter=True, coherent_tile=0,
              backend="auto")
PROBE_RAYS = 65_536
MAX_ID_MISMATCHES = 2
PARITY_TOL, PARITY_GATE = 2e-2, 2e-3
TRAIN_STEPS = 6        # phase 5's training steps: the loss must fall
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
# the hit-record VJP against autograd through the plain recompute: rtol
# with a floor x the largest cotangent (tests/test_torch_hit_record.py's)
HIT_RECORD_RTOL, HIT_RECORD_FLOOR = 1e-5, 2e-4
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
    # the scatter-add's row-major form (B5): the texture fetch's backward
    "scatter_rows_rows": ("ray_tracer_tpu_torch/csrc/scatter_rows.cu",
                          "ray_tracer_tpu/ops/pallas_intersect.py:1672"),
    # the textured variants: _make_kernel / _make_blocked_kernel with
    # textured=True (switched on at pallas_intersect.py:947 and :1528)
    "closest_hit_tex": ("ray_tracer_tpu_torch/csrc/closest_hit.cu",
                        "ray_tracer_tpu/ops/pallas_intersect.py:531"),
    "blocked_hit_tex": ("ray_tracer_tpu_torch/csrc/blocked_hit.cu",
                        "ray_tracer_tpu/ops/pallas_intersect.py:1084"),
    # the winner recompute from untextured rows and its VJP: no TPU kernel
    # (the JAX package's hit_attributes_from_rows is elementwise code)
    "hit_record": ("ray_tracer_tpu_torch/csrc/hit_record.cu",
                   "ray_tracer_tpu/ops/intersect.py:224"),
    "hit_record_vjp": ("ray_tracer_tpu_torch/csrc/hit_record.cu",
                       "ray_tracer_tpu/ops/intersect.py:224"),
    # the viewer's linear -> 8-bit sRGB encode: no TPU kernel (the JAX
    # package's to_uint8 is numpy on the host)
    "srgb_encode": ("ray_tracer_tpu_torch/csrc/srgb_encode.cu",
                    "ray_tracer_tpu/io/image.py:21"),
}
TEXTURED = ("closest_hit_tex", "blocked_hit_tex")
# launch count name -> (wrapper, its attribute that counts the launches):
# each kernel's own, "blocked_hit_ids" for the streaming kernel's launches
# without rows (a part of "blocked_hit"), "scatter_rows_rows" for the
# scatter-add's row-major form (B5), the backward of the texture fetch, and
# the hit-record kernels: one forward launch a closest-hit launch with
# untextured rows, one VJP launch a backward through it; the sRGB encode's,
# one a viewer frame on the card
COUNTS = {"closest_hit": (ch.nearest_hit_attrs, "launches"),
          "closest_hit_tex": (ch.nearest_hit_attrs, "tex_launches"),
          "scatter_rows": (sc.scatter_rows_soa, "launches"),
          "scatter_rows_rows": (sc.scatter_rows, "launches"),
          "any_hit": (ah.anyhit, "launches"),
          "blocked_hit": (bh.nearest_hit_blocked, "launches"),
          "blocked_hit_tex": (bh.nearest_hit_blocked, "tex_launches"),
          "blocked_hit_ids": (bh.nearest_hit_blocked, "ids_launches"),
          "hit_record": (hr.hit_record, "launches"),
          "hit_record_vjp": (hr.hit_record_vjp, "launches"),
          "srgb_encode": (srgb_encode, "launches")}
LARGE_N = 310          # terrain190k: 2 (310 - 1)^2 = 190,962 triangles
LARGE_TRAIN_STEPS = 4  # phase 8's training steps
HUGE_N = 520           # 538,722 triangles: 66 blocks of 8192, two rounds
LIBRARIES = list(dict.fromkeys(os.path.splitext(os.path.basename(src))[0]
                               for src, _ in KERNELS.values()))
# the libraries of the traversal kernels (B1, B4, B3): 0-byte stack frames
# and no spills, gated in phase 1
TRAVERSAL = ("closest_hit", "blocked_hit", "anyhit")
# registers of the untextured instantiations (mangled template arguments:
# <want_attrs, textured>) on an H100 before the textured variants were
# added, each held within REGISTER_SLACK in phase 1
REGISTERS = {("closest_hit", "ILb0ELb0E"): 69,
             ("closest_hit", "ILb1ELb0E"): 71,
             ("blocked_hit", "ILb0ELb0E"): 88,
             ("blocked_hit", "ILb1ELb0E"): 86,
             ("anyhit", "anyhit_kernel"): 72}
REGISTER_SLACK = 3
TEX_RES = 512          # texture_resolution of the textured terrains
TEX_REPEATS = 8        # their UVs span [-8, 8]: the repeat wrap
TEX_START = 0.8        # the texture-recovery start scales the stack by this
TEX_TRAIN_STEPS = 4    # phase 9's training steps
# texture recovery's trainable leaves. On an H100 (1080p, 5 steps from the
# start above) adding DEFAULT_TRAINABLE's geometry at 1e-4 raised the loss
# from 3.05e-4 to 5.88e-4 on terrain_tex, where it lowers it on the
# untextured terrain; the albedos and the stack alone lowered it to 2.08e-4
TEX_FIELDS = ALBEDOS + ("textures",)


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


def texture_images(res, seed=0):
    """(albedo, normal map), each (res, res, 3) uint8: a seeded two-colour
    checker of 8x8 cells times a left-to-right ramp, and the tangent-space
    normals of a periodic heightfield's slopes encoded as (n + 1) / 2."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    cell = max(res // 8, 1)
    colours = 0.3 + 0.6 * rng.random((2, 3))
    ramp = 0.4 + 0.6 * j / max(res - 1, 1)
    albedo = colours[(i // cell + j // cell) % 2] * ramp[..., None]
    # h(u, v) = a cos(2 pi (2 u + p)) + b cos(2 pi (3 v + q)), u = j / res
    a, b, p, q = 0.05, 0.04, rng.random(), rng.random()
    dh_du = -a * 4 * np.pi * np.sin(2 * np.pi * (2 * j / res + p))
    dh_dv = -b * 6 * np.pi * np.sin(2 * np.pi * (3 * i / res + q))
    nrm = np.stack([-dh_du, -dh_dv, np.ones_like(dh_du)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    to_u8 = (lambda x: np.clip(np.round(x * 255), 0, 255).astype(np.uint8))
    return to_u8(albedo), to_u8((nrm + 1) / 2)


def terrain_scene(device, n=90, aspect=W / H, with_lights=False,
                  textured=False):
    """Terrain of 2 (n-1)^2 triangles (15,842 at n=90) with the metal
    scene's glass, diffuse and glossy spheres resting on it. With
    ``with_lights`` (terrain_nee): a 2x2 quad high above it with the room
    scene's ceiling-light material (white, strength 10.5), wound so that
    its geometric normal faces down at the terrain, and one small warm
    emissive sphere. With ``textured`` (terrain_tex): the heightfield
    carries UVs u = x / 4 * 8, v = z / 4 * 8 (repeating 8 times) and
    ``texture_images``' albedo (sRGB) and normal map at 512 x 512; the
    spheres and lights stay untextured. The triangles' order, so their
    ids, is the untextured terrain's."""
    verts, normals, idx = heightfield(n, 4.0, -1.0, np.random.default_rng(0))
    # heightfield's winding faces -y and the intersection culls back faces:
    # reverse it so the terrain faces the camera above it
    idx = idx.reshape(-1, 3)[:, ::-1].reshape(-1)
    b = rt.SceneBuilder(texture_resolution=TEX_RES)
    tex = {}
    if textured:
        albedo_map, normal_map = texture_images(TEX_RES)
        tex = dict(uvs=verts[:, [0, 2]] / 4.0 * TEX_REPEATS,
                   tex=b.add_texture(albedo_map, srgb=True),
                   normal_tex=b.add_texture(normal_map, srgb=False))
    b.add_mesh(verts, normals, idx, albedo=(0.7, 0.5, 0.3), smoothness=0.3,
               **tex)
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
    for wrapper, attr in COUNTS.values():
        setattr(wrapper, attr, 0)


def read_counts():
    """Every kernel's launch count since reset_counts()."""
    return {k: getattr(w, attr) for k, (w, attr) in COUNTS.items()}


def launches(**want):
    """The launch counts a path must show: those named, the others 0."""
    if set(want) - set(COUNTS):
        raise KeyError(f"no launch count {set(want) - set(COUNTS)}")
    return {k: want.get(k, 0) for k in COUNTS}


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
    spheres, 128 bytes a triangle, 192 on a textured scene (the geometry
    plane repeats columns 0:12 of the attribute plane, so a triangle is 48
    bytes of geometry and the 80, or 144, of its other attributes; 48
    without ``attrs``: the any-hit kernel and the ids-only variants read
    the geometry plane only), cluster and super boxes and, with ``block``,
    the streaming kernel's block boxes."""
    clusters = -(-scene.num_tris // ch.CLUSTER)
    boxes = clusters + -(-clusters // ch.SUPER) + (
        bh.block_layout(scene, block)[2] if block else 0)
    tri = ch.tri_cols(scene.num_textures > 0) if attrs else ch.GEO_COLS
    return 4 * (scene.padded_spheres * 16 + scene.padded_tris * tri
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


def registers(log):
    """{function: registers} of every entry function ptxas reports in a
    build log (``-Xptxas -v``)."""
    regs, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            regs[fn] = int(m.group(1))
            fn = None
    return regs


def check_registers(name, regs):
    """Hold the untextured instantiations of library ``name`` to their
    REGISTERS within REGISTER_SLACK; raise where one moved or is
    missing."""
    for (lib, key), want in REGISTERS.items():
        if lib != name:
            continue
        got = [r for fn, r in regs.items() if key in fn]
        if len(got) != 1 or abs(got[0] - want) > REGISTER_SLACK:
            raise AssertionError(f"{name} {key}: registers {got}, want "
                                 f"{want} +- {REGISTER_SLACK}")


def phase1_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source
        paths = dict(zip(LIBRARIES, pool.map(build.build, LIBRARIES)))
    for name in LIBRARIES:
        build.load(name)
    secs = time.perf_counter() - t0
    regs = {}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text() if path.with_suffix(
            ".log").exists() else ""
        ptxas = " / ".join(ln.split("ptxas info    : ")[-1] for ln in
                           log.splitlines() if "Used" in ln or "spill" in ln)
        # registers by template arguments (<want_attrs, textured>)
        named = {(re.search(r"I(?:Lb[01]E)+E", fn) or re.search(
            r"[a-z_]+_kernel", fn)).group(0): r for fn, r in registers(
                log).items()}
        print(f"phase 1 build: {path.name} ({len(paths)} built together in "
              f"{secs:.2f} s) | registers {named} | {ptxas}", flush=True)
        frames = stack_and_spills(log)
        if name in TRAVERSAL and (not frames or any(
                any(f[1:]) for f in frames)):
            raise AssertionError(f"{name}: the traversal kernels must have "
                                 f"0-byte stack frames and no spills, ptxas "
                                 f"reports {frames}")
        regs[name] = registers(log)
        check_registers(name, regs[name])
    return regs


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
    lib = build.library("closest_hit", ch.SIGNATURES)
    planes = ch.scene_planes(scene)
    shape = (planes.n_clusters, planes.sup.shape[0])
    print(f"phase 2 main-path shape (terrain, {W}x{H} primary rays, "
          f"{hits} hits, {mism} mism): kernel {ms:.3f} ms with the plane "
          f"cache warm, {cold_ms:.3f} ms with it cleared before each call "
          f"(packing alone {pack_ms:.3f} ms), plain {plain_ms:.3f} ms, max "
          f"|dt| {err}; {lib.rtt_closest_hit_shared_bytes(*shape)} B of "
          f"shared memory a block, "
          f"{lib.rtt_closest_hit_blocks_per_sm(*shape, 1, 0)} blocks an SM; "
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


def render_path(label, scene, cam, params, want):
    """One path's render, checked: every launch count to 0,
    ``render_progressive`` of FRAMES frames, the counts held to ``want``
    and the scene's planes packed exactly once (they live one call), the
    image finite (H, W, 3) and not constant → (image, counts)."""
    reset_counts()
    packs = ch.scene_planes.packs
    img = render_progressive(scene, rt.camera_basis(cam), params, FRAMES)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"{label}: kernel launches {counts} != {want}")
    if ch.scene_planes.packs != packs + 1:
        raise AssertionError(f"{label}: a render must pack the scene's "
                             f"planes once; it packed them "
                             f"{ch.scene_planes.packs - packs} times")
    if img.shape != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label} image is not finite (H, W, 3)")
    if float(img.std()) < 1e-3:
        raise AssertionError(f"{label} image is constant")
    return img, counts


def phase3_main_path(device, terrain, card):
    scene, cam = terrain
    params = rt.RenderParams(**PARAMS)
    if resolved_backend(params, scene) != "cuda":
        raise AssertionError("backend 'auto' did not resolve to cuda")
    img, counts = render_path(
        "terrain", scene, cam, params,
        launches(closest_hit=FRAMES * (BOUNCES + 1),
                 hit_record=FRAMES * (BOUNCES + 1)))
    print(f"phase 3 main path: terrain {scene.num_tris} tris {W}x{H} "
          f"b{BOUNCES} {FRAMES} frames: {counts['closest_hit']} "
          f"closest-hit, {counts['blocked_hit']} streaming and "
          f"{counts['hit_record']} hit-record launches, one packing, "
          f"image mean {float(img.mean()):.4f} | {card}", flush=True)
    return counts


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


def winner_cotangents(scene, cam, textured=False):
    """What the winner-row backward hands the scatter-add on bounces 0 and
    1 of one training step at the main path's settings (``train_setup``'s
    start and target; with ``textured`` its texture-recovery step) →
    [(ids, g (26 or 40, R)), ...] in bounce order, n_rows, and what the
    texture fetches' backward hands the row-major scatter-add, [(ids,
    g (R, 12), n_rows), ...] in the order of the calls. Each winner-row
    scatter is matched to its bounce by its ids, which are the forward's
    winners with the misses routed to n_rows."""
    fwd, bwd, fetches = [], [], []
    real_rows, real_scatter = intersect._nearest_rows, sc.scatter_rows_soa
    real_fetch = sc.scatter_rows

    def rows_spy(*args, **kw):
        out = real_rows(*args, **kw)
        fwd.append(out[1:])
        return out

    def scatter_spy(ids, g_soa, n_rows):
        bwd.append((ids, g_soa, n_rows))
        return real_scatter(ids, g_soa, n_rows)

    def fetch_spy(ids, g_rows, n_rows):
        fetches.append((ids, g_rows, n_rows))
        return real_fetch(ids, g_rows, n_rows)

    # the wrappers count on their module's names
    scatter_spy.launches = fetch_spy.launches = 0

    step_fn, args = train_setup(scene, cam, textured)
    intersect._nearest_rows, sc.scatter_rows_soa = rows_spy, scatter_spy
    sc.scatter_rows = fetch_spy
    try:
        step_fn(*args)
    finally:
        intersect._nearest_rows, sc.scatter_rows_soa = real_rows, real_scatter
        sc.scatter_rows = real_fetch
    n_rows = bwd[0][2]
    out = []
    for pid, miss in fwd[:2]:
        want = torch.where(miss, n_rows, pid)
        out += [(ids, g) for ids, g, _ in bwd if torch.equal(ids, want)][:1]
    if len(out) != 2:
        raise AssertionError("the training step's scatters do not match its "
                             "bounces 0 and 1")
    return out, n_rows, fetches


def phase2b_scatter_vs_plain(device, terrain, terrain_tex):
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
    real, real_rows, _ = winner_cotangents(scene, cam)
    tex_real, tex_rows, fetches = winner_cotangents(*terrain_tex,
                                                    textured=True)
    if real_rows != n_rows or tex_rows != n_rows:
        raise AssertionError(f"the backward's tables have {real_rows} and "
                             f"{tex_rows} rows, not {n_rows}")
    tex_ids, tex_g = tex_real[0]
    if tex_g.shape != (40, R):
        raise AssertionError(f"textured cotangents {tuple(tex_g.shape)}")
    cases = [("dense", sc.scatter_rows_soa, ids, g, None),
             ("sparse", sc.scatter_rows_soa, sparse, g, None),
             ("all-miss", sc.scatter_rows_soa, all_miss, g, None),
             ("row-major", sc.scatter_rows, ids, g, g.T.contiguous())]
    for b, (r_ids, r_g) in enumerate(real):
        cases += [(f"real bounce {b}", sc.scatter_rows_soa, r_ids, r_g, None),
                  (f"real bounce {b} row-major", sc.scatter_rows, r_ids, r_g,
                   r_g.T.contiguous())]
    cases += [("real textured bounce 0 (40 columns)", sc.scatter_rows_soa,
               tex_ids, tex_g, None)]
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
    k_ms, l_ms, v_ms = scatter_times(tex_ids, tex_g, n_rows)
    real_text.append(
        f"textured bounce 0 (terrain_tex's texture-recovery step, 40 "
        f"columns, {int((tex_ids < n_rows).sum())} live lanes, "
        f"{float((tex_g != 0).float().mean()):.1%} of entries nonzero): "
        f"kernel {k_ms:.3f} ms, index_add_ {l_ms:.3f} ms (on the transposed "
        f"view {v_ms:.3f} ms)")
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

    # the row-major form on the main path: the texture fetches' backward,
    # bounce 0's albedo fetch the last that the backward scatters
    f_ids, f_g, f_rows = fetches[-1]
    if len(fetches) != 2 * BOUNCES + 1 or f_g.shape != (R, 12):
        raise AssertionError(f"{len(fetches)} texture-fetch scatters, the "
                             f"last {tuple(f_g.shape)}")
    f_err, f_text = scatter_gate("real texture fetch bounce 0",
                                 sc.scatter_rows, f_ids, f_g.T, f_rows, f_g)
    f_ms = cuda_ms(lambda: sc.scatter_rows(f_ids, f_g, f_rows), 20)
    f_plain = cuda_ms(lambda: sc.scatter_rows_reference(f_ids, f_g, f_rows),
                      5)
    acc = torch.zeros((f_rows, 12), device=device)
    f_lib = cuda_ms(lambda: acc.index_add_(0, f_ids, f_g), 20)
    # autograd's own transpose of the gather: index_put_ with accumulate
    f_sort = cuda_ms(lambda: torch.zeros_like(acc).index_put_(
        (f_ids.long(),), f_g, accumulate=True), 1)
    # ids and cotangents in, the quad table's gradient out; one add a lane
    # and column
    fb = bound(R * 4 * (1 + 12) + f_rows * 12 * 4, R * 12)
    print(f"phase 2b row-major scatter-add (B5) on the texture fetch's "
          f"backward (terrain_tex's texture-recovery step, {f_rows} quad "
          f"rows x 12, {len(fetches)} scatters a step): {f_text} | kernel "
          f"{f_ms:.3f} ms, plain {f_plain:.3f} ms, index_add_ {f_lib:.3f} ms, "
          f"autograd's own transpose (index_put_ with accumulate) "
          f"{f_sort:.3f} ms, bound {fb['bound_ms']:.4f} ms by "
          f"{fb['bound_by']}", flush=True)
    return (dict(ms=ms, plain_ms=plain_ms, plain_rays=R, max_abs_err=max_err,
                 mismatches=0, library_ms=library_ms, **b),
            dict(ms=f_ms, plain_ms=f_plain, plain_rays=R, max_abs_err=f_err,
                 mismatches=0, library_ms=f_lib, **fb))


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
    lib = build.library("anyhit", ah.SIGNATURES)
    planes = ch.scene_planes(scene)
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


def train_setup(scene, cam, textured=False):
    """The training path's step at the main path's settings: Adam over
    DEFAULT_TRAINABLE (``train_optimizer``), from the scene with its
    albedos scaled by ALBEDO_START towards frame 0 of the true scene →
    (step_fn, its first arguments: trainable, opt, start, basis, target,
    frame). With ``textured``, texture recovery: the albedos and the
    texture stack (TEX_FIELDS, at the albedos' rate), the stack from the
    true one scaled by TEX_START."""
    params = rt.RenderParams(**PARAMS)
    basis = rt.camera_basis(cam)
    with torch.no_grad():  # the same frame, so the same sample streams
        target = render_frame(scene, basis, params, 0)
    start = dataclasses.replace(
        scene, tri_albedo=scene.tri_albedo * ALBEDO_START,
        sphere_albedo=scene.sphere_albedo * ALBEDO_START)
    fields = DEFAULT_TRAINABLE
    if textured:
        start = dataclasses.replace(start,
                                    textures=scene.textures * TEX_START)
        fields = TEX_FIELDS
    init_fn, step_fn = make_train_step(
        params, lambda leaves: train_optimizer(leaves, fields))
    trainable, opt = init_fn(start, fields)
    return step_fn, (trainable, opt, start, basis, target, 0)


def train_path(label, scene, cam, card, steps, hit, textured=False):
    """The training path: ``grad.make_train_step`` over DEFAULT_TRAINABLE
    (over TEX_FIELDS with ``textured``) at the main path's settings, from
    ``train_setup``'s start towards frame 0 of the true scene; ``steps``
    steps, each driven with every launch count at
    0 and held to bounces + 1 launches of the ``hit`` kernel and of the
    scatter-add (with ``textured`` also bounces * 2 + 1 of its row-major
    form: the backward of the albedo fetch of every segment and of the
    normal-map fetch of every segment but the last, whose normal scatters
    no further ray; without, bounces + 1 of each hit-record kernel) and to
    one packing of the scene's planes (the
    optimizer moved the scene);
    gradients finite, tri_v0's (textures', with ``textured``) and
    tri_albedo's not all zero, the last loss below the first → (line, the
    launches summed over all steps)."""
    step_fn, (trainable, opt, start, basis, target, _) = train_setup(
        scene, cam, textured)
    seg = BOUNCES + 1
    per_step = launches(**{hit: seg, "scatter_rows": seg},
                        scatter_rows_rows=2 * BOUNCES + 1 if textured else 0,
                        hit_record=0 if textured else seg,
                        hit_record_vjp=0 if textured else seg)
    totals = dict.fromkeys(per_step, 0)
    losses = []
    for step in range(steps):
        reset_counts()
        packs = ch.scene_planes.packs
        trainable, opt, loss = step_fn(trainable, opt, start, basis, target,
                                       0)
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
    for k, p in trainable.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{label}: gradient of {k} is missing or "
                                 f"not finite")
    for k in ("textures" if textured else "tri_v0", "tri_albedo"):
        if not bool(trainable[k].grad.any()):
            raise AssertionError(f"{label}: gradient of {k} is all zero")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    rates = (f"{ALBEDO_LR} albedos and textures" if textured
             else f"{ALBEDO_LR} albedos, {GEOMETRY_LR} geometry")
    line = (f"{label} {scene.num_tris} tris {W}x{H} b{BOUNCES} Adam "
            f"({rates}) over {len(trainable)} leaves, whole-frame gradient, "
            f"{steps} steps: launches {totals} over the steps ({per_step} "
            f"per step), one packing a step; loss {losses[0]:.6g} -> "
            f"{losses[-1]:.6g} | {card}")
    return line, totals


def phase5_training(device, terrain, card):
    line, totals = train_path("terrain", *terrain, card, TRAIN_STEPS,
                              "closest_hit")
    print(f"phase 5 training path: {line}", flush=True)
    return totals


def train_optimizer(leaves, fields=DEFAULT_TRAINABLE):
    """Adam over the leaves of ``fields`` (in that order): the default
    rate 1e-2 on the albedos and the texture stack, 1e-4 on the geometry.
    The target is the true
    scene, so its geometry is already right, and the interior gradient does
    not see the silhouettes a move shifts. On an H100 at this phase's
    settings, Adam 1e-2 on every leaf raised the loss from 7.76e-4 to
    2.00e-3 in one step; 1e-3 on the geometry lowered it for four steps
    and then raised it again."""
    names = dict(zip(fields, leaves))
    colour = ALBEDOS + ("textures",)
    groups = [{"params": [v for k, v in names.items() if k in colour],
               "lr": ALBEDO_LR},
              {"params": [v for k, v in names.items() if k not in colour],
               "lr": GEOMETRY_LR}]
    return torch.optim.Adam([g for g in groups if g["params"]])


def grad_gate(label, g, ref, tol=GRAD_PARITY):
    """Per leaf max |g - ref| <= tol x max |ref|, all finite → (largest
    ratio, its leaf, each leaf's max |ref|)."""
    worst, worst_leaf, scales = 0.0, None, {}
    for k in ref:
        if not (bool(torch.isfinite(g[k]).all())
                and bool(torch.isfinite(ref[k]).all())):
            raise AssertionError(f"{label}: {k}'s gradient is not finite")
        scale = scales[k] = float(ref[k].abs().max())
        err = float((g[k] - ref[k]).abs().max())
        if err > tol * scale:
            raise AssertionError(f"{label}: {k} differs by {err} (max |g| "
                                 f"{scale})")
        if scale and err / scale >= worst:
            worst, worst_leaf = err / scale, k
    return worst, worst_leaf, scales


def float_fields(scene):
    return [k for k in TENSOR_FIELDS
            if getattr(scene, k).is_floating_point()]


def grad_parity(scene, cam, params, size=(256, 144)):
    """Whole-frame MSE gradients of every float leaf at ``size`` through
    the kernels (backend "cuda") and the plain oracle ("torch") on the same
    CUDA tensors → (image equal, image max |diff|, each leaf's max |g|,
    largest max |diff| / max |g|, its leaf). Raises where a leaf breaks the
    gate or a gradient is not finite."""
    basis = rt.camera_basis(cam.replace(aspect=size[0] / size[1]))
    params = params.replace(width=size[0], height=size[1])
    fields = float_fields(scene)
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
    worst, worst_leaf, scales = grad_gate("gradient parity", g_k, g_p)
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


def nee_render(phase, name, scene, cam, params, want, card):
    """A NEE path on one scene: ``render_path`` held to ``want`` → the
    launch counts of the checked render."""
    img, counts = render_path(f"{name} NEE", scene, cam, params, want)
    print(f"phase {phase} NEE path: {name} {scene.num_tris} tris {W}x{H} "
          f"b{BOUNCES} {FRAMES} frames nee+mis skybox={params.skybox}: "
          f"launches {counts}; image mean {float(img.mean()):.5f} | {card}",
          flush=True)
    return counts


def phase7_nee_path(device, terrain_nee, card):
    params = rt.RenderParams(**PARAMS, **NEE)
    if resolved_backend(params, terrain_nee[0]) != "cuda":
        raise AssertionError("backend 'auto' did not resolve to cuda")
    want = launches(closest_hit=FRAMES * (BOUNCES + 1),
                    any_hit=FRAMES * BOUNCES,
                    hit_record=FRAMES * (BOUNCES + 1))
    counts = nee_render("7", "terrain_nee", *terrain_nee, params, want, card)
    room = rt.builtin_scene("room", aspect=W / H, device=device)
    nee_render("7", "room", *room, params.replace(skybox=False), want, card)
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
        report.append(exact(f"66 blocks {kind}", got, ref, live))
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
    lib = build.library("blocked_hit", bh.SIGNATURES)
    print(f"phase 2d main-path shape ({W}x{H} primary rays, blocked pixel "
          f"order; ms with the plane cache warm / cleared before each call "
          f"/ packing alone): " + "; ".join(
              f"{k} ({v['hits']} hits, {v['mism']} mism) streaming "
              + " / ".join(f"{x:.3f}" for x in v["b4"]) + " ms vs closest-hit "
              + " / ".join(f"{x:.3f}" for x in v["b1"]) + " ms"
              for k, v in side.items())
          + f" | streaming kernel: {lib.rtt_blocked_hit_shared_bytes()} B of "
          f"shared memory a block, {lib.rtt_blocked_hit_blocks_per_sm(1, 0)} "
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


def phase8_large_scene(device, large, large_nee, card):
    scene, cam = large
    params = rt.RenderParams(**PARAMS)
    if not bh.uses_blocked(scene) or resolved_backend(params, scene) != "cuda":
        raise AssertionError("terrain190k does not take the streaming kernel")
    img, counts = render_path(
        "terrain190k", scene, cam, params,
        launches(blocked_hit=FRAMES * (BOUNCES + 1),
                 hit_record=FRAMES * (BOUNCES + 1)))
    print(f"phase 8 large-scene forward: terrain190k {scene.num_tris} tris "
          f"({scene.padded_tris} padded, {bh.block_layout(scene)[2]} blocks "
          f"of {bh.BLOCK}) {W}x{H} b{BOUNCES} {FRAMES} frames: "
          f"{counts['blocked_hit']} streaming and {counts['closest_hit']} "
          f"closest-hit launches, image mean {float(img.mean()):.4f} | "
          f"{card}", flush=True)
    nee_render("8", "terrain190k_nee", *large_nee,
               rt.RenderParams(**PARAMS, **NEE),
               launches(blocked_hit=FRAMES * (BOUNCES + 1) + FRAMES * BOUNCES,
                        blocked_hit_ids=FRAMES * BOUNCES,
                        hit_record=FRAMES * (BOUNCES + 1)), card)
    line, _ = train_path("terrain190k", scene, cam, card, LARGE_TRAIN_STEPS,
                         "blocked_hit")
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


def exact(label, got, ref, alive):
    """``compare`` with no id mismatch allowed: t, ids and every row
    column equal on every lane → report text."""
    mism, _, hits = compare(got, ref, alive, label)
    if mism:
        raise AssertionError(f"{label}: {mism} mismatches")
    return f"{label} 0 mism {hits} hits"


def phase2e_textured_vs_plain(device, terrain, terrain_tex, large, large_tex,
                              regs, b1, b4):
    """The textured variants (40-column rows from 48-column triangle
    planes) against their plain versions on PROBE_RAYS probe and secondary
    rays of the textured terrains and their tied copies: 0 mismatches in
    t, ids and all 40 row columns; then on the 1080p primary wavefronts
    beside the untextured variants on the untextured terrains (the same
    geometry in the same order): t, ids and the first 26 columns equal to
    the untextured kernel's, all 40 equal to the winners' table rows, both
    timed. The bounds count the operations phases 2 and 2d counted on the
    same rays (the traversal is the same) and the bytes of the textured
    rows and planes."""
    report = []
    scene, cam = terrain_tex
    o, d, alive = probe_inputs(scene, cam, PROBE_RAYS, 10, device)
    so, sd = secondary_rays(scene, PROBE_RAYS, 11, device)
    for name, s in (("terrain_tex", scene), ("tied", tied(scene, 512))):
        for kind, (ro, rd) in (("primary", (o, d)), ("secondary", (so, sd))):
            got = ch.nearest_hit_attrs(s, ro, rd, 1e-4, alive)
            ref = ch.nearest_hit_attrs_reference(s, ro, rd, 1e-4, alive)
            torch.cuda.synchronize()
            report.append(exact(f"B1-tex {name} {kind}", got, ref, alive))
    b1_plain_ms = cuda_ms(lambda: ch.nearest_hit_attrs_reference(
        scene, o, d, 1e-4, alive), 2)
    big, big_cam = large_tex
    o4, d4, alive4 = probe_inputs(big, big_cam, PROBE_RAYS, 12, device)
    so4, sd4 = secondary_rays(big, PROBE_RAYS, 13, device)
    for name, s in (("terrain190k_tex", big), ("tied", tied(big, 1024))):
        for kind, (ro, rd) in (("primary", (o4, d4)),
                               ("secondary", (so4, sd4))):
            # the plain version's result does not depend on the block size
            ref = bh.nearest_hit_blocked_reference(s, ro, rd, 1e-4, alive4)
            for block in (bh.BLOCK, 1024):
                got = bh.nearest_hit_blocked(s, ro, rd, 1e-4, alive4,
                                             block=block)
                torch.cuda.synchronize()
                report.append(exact(f"B4-tex {name} {kind} /{block}", got,
                                    ref, alive4))
    b4_plain_ms = cuda_ms(lambda: bh.nearest_hit_blocked_reference(
        big, o4, d4, 1e-4, alive4), 1)
    print(f"phase 2e textured kernels vs plain ({PROBE_RAYS} rays, t, ids "
          f"and all 40 row columns): " + "; ".join(report)
          + f" | plain on {PROBE_RAYS} probe rays: B1-tex's {b1_plain_ms:.3f}"
          f" ms (terrain_tex), B4-tex's {b4_plain_ms:.3f} ms "
          f"(terrain190k_tex)", flush=True)

    # the 1080p primary wavefronts, beside the untextured variants
    alive = torch.ones(W * H, dtype=torch.bool, device=device)
    out, text = {}, []
    for key, (base, _), (tex, tex_cam), hit, work, block in (
            ("closest_hit_tex", terrain, terrain_tex, ch.nearest_hit_attrs,
             b1, None),
            ("blocked_hit_tex", large, large_tex, bh.nearest_hit_blocked,
             b4, bh.BLOCK)):
        o, d = primary_wavefront(tex, tex_cam, device)
        got = hit(tex, o, d, 1e-4, alive)
        plain = hit(base, o, d, 1e-4, alive)
        table = ch._plain_result(tex, o, [got[0]], [got[1]], True)[2]
        torch.cuda.synchronize()
        if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
                and torch.equal(got[2][:26], plain[2])
                and torch.equal(got[2], table)):
            raise AssertionError(f"{key} 1080p primary: not the untextured "
                                 f"kernel's hits and the table's rows")
        hits = int(torch.isfinite(got[0]).sum())
        del got, plain, table
        untex1 = wrapper_ms(lambda: hit(base, o, d, 1e-4, alive), base, 10)
        tex1 = wrapper_ms(lambda: hit(tex, o, d, 1e-4, alive), tex, 10)
        tex2 = wrapper_ms(lambda: hit(tex, o, d, 1e-4, alive), tex, 10)
        untex2 = wrapper_ms(lambda: hit(base, o, d, 1e-4, alive), base, 10)
        # rays (o, d, alive: 25 bytes) in; t, id and the 40-column row out;
        # the sphere, geometry, 48-column attribute and box planes once
        b = bound(W * H * (25 + 4 * (2 + 40)) + plane_bytes(tex, block),
                  work["ops"])
        planes = ch.scene_planes(tex)
        if key == "closest_hit_tex":
            lib = build.library("closest_hit", ch.SIGNATURES)
            shape = (planes.n_clusters, planes.sup.shape[0])
            shared = lib.rtt_closest_hit_shared_bytes(*shape)
            per_sm = lib.rtt_closest_hit_blocks_per_sm(*shape, 1, 1)
        else:
            lib = build.library("blocked_hit", bh.SIGNATURES)
            shared = lib.rtt_blocked_hit_shared_bytes()
            per_sm = lib.rtt_blocked_hit_blocks_per_sm(1, 1)
        reg = [r for fn, r in regs[key[:-4]].items() if "ILb1ELb1E" in fn]
        text.append(
            f"{key} on {tex.num_tris} tris ({hits} hits): textured "
            + " / ".join(f"{x:.3f}" for x in tex1) + ", "
            + " / ".join(f"{x:.3f}" for x in tex2) + " ms; untextured on "
            "the untextured terrain "
            + " / ".join(f"{x:.3f}" for x in untex1) + ", "
            + " / ".join(f"{x:.3f}" for x in untex2)
            + f" ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes']} B, {b['ops']} f32 ops); {reg} registers, "
            f"{shared} B of shared memory a block, {per_sm} blocks an SM")
        out[key] = dict(ms=min(tex1[0], tex2[0]),
                        plain_ms=(b1_plain_ms if key == "closest_hit_tex"
                                  else b4_plain_ms),
                        plain_rays=PROBE_RAYS, max_abs_err=0.0, mismatches=0,
                        library_ms=None, **b)
    print(f"phase 2e main-path shape ({W}x{H} primary rays, blocked pixel "
          f"order; ms with the plane cache warm / cleared before each call "
          f"/ packing alone, in the order textured, textured, untextured, "
          f"untextured as printed): " + "; ".join(text), flush=True)
    return out


HIT_FIELDS = ("t", "point", "normal", "albedo", "emission",
              "emission_strength", "smoothness", "hit")


def recompute_bound(ids, padded_spheres, vjp=False):
    """The hit-record kernels' bound on these lanes: each reads its
    branch's row columns (26 on a triangle lane; 12 on a sphere lane, and
    on a miss or dead lane, whose id is 0), o, d, its id and its miss flag;
    the forward writes 15 floats and the hit flag, the VJP reads the seven
    outputs' 15 cotangents and writes the rows' 26 cotangents, o's and
    d's."""
    R = ids.numel()
    tri = int((ids >= padded_spheres).sum())
    lane = 24 + 4 + 1 + (4 * (15 + 26 + 6) if vjp else 4 * 15 + 1)
    return bound(4 * (26 * tri + 12 * (R - tri)) + R * lane, 0), tri


def recompute_check(label, scene, o, d, alive):
    """The hit-record kernels on one wavefront's winners (the closest-hit
    kernel's rows): the forward's eight outputs bit-equal to
    ``intersect.hit_attributes_from_rows``; the VJP through
    ``intersect._HitRecord`` against ``torch.autograd.grad`` of the plain
    version, seeded normal cotangents on all seven float outputs, each
    entry of the rows', o's and d's cotangents within HIT_RECORD_RTOL of
    autograd's plus HIT_RECORD_FLOOR of the largest cotangent plus
    autograd's own distance there from the same autograd in float64 (on
    a ray grazing a sphere the float32 forward's rounding moves the
    gradient by more than the floor: the float32 oracle fixes such an
    entry no closer than that); each timed (CUDA events), beside its plain
    version and its bound → (the forward's and the VJP's timing entries,
    text)."""
    S = scene.padded_spheres
    t, ids, rows = ch.nearest_hit_attrs(scene, o, d, 1e-4, alive)
    miss = torch.isinf(t)
    args = (rows, o, d, ids, miss)
    R = ids.numel()
    got = hr.hit_record(*args, S)
    want = intersect.hit_attributes_from_rows(scene, *args, 1e-4)
    off = {}
    for f, g in zip(HIT_FIELDS, got):
        n = int((g != getattr(want, f)).reshape(R, -1).any(1).sum())
        if n:
            off[f] = n
    if off:
        raise AssertionError(f"hit record {label}: lanes off the plain "
                             f"version {off}")
    del want
    gen = torch.Generator(device=o.device).manual_seed(17)
    cots = [torch.randn(g.shape, generator=gen, device=o.device)
            for g in got[:7]]
    cmax = max(float(c.abs().max()) for c in cots)
    leaves = {dt: [x.detach().to(dt).clone().requires_grad_(True)
                   for x in (rows, o, d)]
              for dt in (torch.float32, torch.float64)}
    f32 = leaves[torch.float32]

    def kernel():
        return intersect._HitRecord.apply(*f32, ids, miss, S)[:7]

    def plain(dt=torch.float32):
        h = intersect.hit_attributes_from_rows(scene, *leaves[dt], ids, miss,
                                               1e-4)
        return [getattr(h, f) for f in HIT_FIELDS[:7]]

    def grads(fn, dt=torch.float32):
        return torch.autograd.grad(fn(), leaves[dt],
                                   [c.to(dt) for c in cots])

    worst, widened, err, past, over = 0.0, 0.0, 0.0, 0, 0
    for name, a, b, x in zip(("rows", "o", "d"), grads(kernel), grads(plain),
                             grads(lambda: plain(torch.float64),
                                   torch.float64)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"hit-record VJP {label}: {name}'s "
                                 f"cotangent is not finite")
        gap = (a - b).abs() - HIT_RECORD_RTOL * b.abs()
        wide = gap.double() - (b.double() - x).abs()
        err = max(err, float((a - b).abs().max()))
        worst = max(worst, float(gap.max()) / cmax)
        widened = max(widened, float(wide.max()) / cmax)
        past += int((gap > HIT_RECORD_FLOOR * cmax).sum())
        over += int((wide > HIT_RECORD_FLOOR * cmax).sum())
    if over:
        raise AssertionError(f"hit-record VJP {label}: {over} entries past "
                             f"rtol {HIT_RECORD_RTOL} + {HIT_RECORD_FLOOR} x "
                             f"the largest cotangent + float32 autograd's "
                             f"distance from float64 (worst {widened:.3g})")
    fwd_ms = cuda_ms(lambda: hr.hit_record(*args, S), 20)
    plain_ms = cuda_ms(lambda: intersect.hit_attributes_from_rows(
        scene, *args, 1e-4), 3)
    vjp_ms = cuda_ms(lambda: hr.hit_record_vjp(*args, S, cots,
                                               (True, True, True)), 20)
    pair_ms = cuda_ms(lambda: grads(kernel), 10)
    plain_pair_ms = cuda_ms(lambda: grads(plain), 3)
    fb, tri = recompute_bound(ids, S)
    vb, _ = recompute_bound(ids, S, vjp=True)
    hits = int((~miss).sum())
    fwd = dict(ms=fwd_ms, plain_ms=plain_ms, plain_rays=R, max_abs_err=0.0,
               mismatches=0, library_ms=None, **fb)
    vjp = dict(ms=vjp_ms, plain_ms=plain_pair_ms, plain_rays=R,
               max_abs_err=err, mismatches=over, library_ms=None, **vb)
    return fwd, vjp, (
        f"{label} {R} lanes ({hits} hits, {tri} on triangles, "
        f"{R - tri} sphere, miss or dead lanes): forward bit-equal in all "
        f"{len(HIT_FIELDS)} outputs, {fwd_ms:.4f} ms (bound "
        f"{fb['bound_ms']:.4f} ms by {fb['bytes']} B: "
        f"{fb['bound_ms'] / fwd_ms:.1%}), plain {plain_ms:.3f} ms; VJP "
        f"against float32 autograd: worst gap past rtol {worst:.3g} x the "
        f"largest cotangent ({past} entries past {HIT_RECORD_FLOOR}), less "
        f"float32 autograd's distance from float64 {widened:.3g} (gate "
        f"{HIT_RECORD_FLOOR}), max |diff| {err:.3g}, {vjp_ms:.4f} ms (bound "
        f"{vb['bound_ms']:.4f} ms by {vb['bytes']} B: "
        f"{vb['bound_ms'] / vjp_ms:.1%}); forward + backward through "
        f"_HitRecord {pair_ms:.3f} ms, autograd through the plain version "
        f"{plain_pair_ms:.3f} ms")


def phase2f_recompute_vs_plain(device, terrain):
    """The hit-record kernels against the plain recompute and autograd
    through it (``recompute_check``) on the terrain's 1080p primary
    wavefront (blocked order, every lane live) and on a main-path frame's
    bounce-1 wavefront (dead lanes too) → the primary's timing entries of
    the forward and the VJP."""
    scene, cam = terrain
    o, d = primary_wavefront(scene, cam, device)
    alive = torch.ones(W * H, dtype=torch.bool, device=device)
    fwd, vjp, text0 = recompute_check("primary", scene, o, d, alive)
    _, _, text1 = recompute_check("bounce 1", scene, *wavefront(
        scene, cam, rt.RenderParams(**PARAMS), 1))
    print(f"phase 2f hit-record kernels vs plain (terrain {W}x{H}): "
          f"{text0}; {text1}", flush=True)
    return fwd, vjp


# the sRGB encode's images in phase 2g: the viewer cell's and the main
# path's; the card's spin (cycles) that the timed launches queue behind
SRGB_SHAPES = ((800, 800, 3), (H, W, 3))
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card alone: the calls are
    queued behind a spin of the card (SPIN_CYCLES, ~50 ms), so the events
    time the device's work and not the host's issue of it (which must end
    inside the spin: raises otherwise)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    spin.record()
    torch.cuda.synchronize()
    spin_ms = stop.elapsed_time(spin)
    if issue_ms > 0.5 * spin_ms:
        raise AssertionError(f"device_ms: {reps} calls took {issue_ms:.2f} "
                             f"ms to issue, past half the {spin_ms:.2f} ms "
                             f"spin")
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps):
    """Mean wall milliseconds per call of fn(), to the card's end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def srgb_image(shape, seed):
    """A linear float32 image for the encode: half the values uniform over
    [-0.25, 1.25], half the thresholds and their neighbours to 2 ulp, and
    64 of NaN, +inf, -inf and -0.0."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    t = srgb_thresholds().view(np.int32)
    near = (rng.choice(t, n) + rng.integers(-2, 3, n)).astype(np.int32)
    x = np.where(rng.random(n) < 0.5, rng.uniform(-0.25, 1.25, n),
                 near.view(np.float32)).astype(np.float32)
    x[rng.choice(n, 64, replace=False)] = np.float32(
        [np.nan, np.inf, -np.inf, -0.0] * 16)
    return x.reshape(shape)


def searchsorted_encode(x, table):
    """The same encode from torch's own search over the same thresholds
    (the library alternative to the kernel): flip, the number of
    thresholds at or below each value, NaN to 0, uint8."""
    x = x.flip(0)
    return torch.searchsorted(table, x, right=True).masked_fill_(
        torch.isnan(x), 0).to(torch.uint8)


def phase2g_srgb_vs_numpy(device):
    """The sRGB encode kernel (``ops/srgb_encode.py``) against the numpy
    encode on SRGB_SHAPES (``srgb_image``): ``to_uint8`` of the card
    image launches it once and returns the numpy encode's bytes, as
    ``torch.searchsorted`` over the same table does; each timed: the
    kernel's device ms (``device_ms``) beside its 5-byte-a-value bound and
    its host ms a launch, ``to_uint8`` with its pinned copy and wait, the
    library search's device and host ms, and the path before the kernel (a
    blocking copy of the float image, then numpy) → the main path's
    timing entry."""
    table = torch.from_numpy(srgb_thresholds().copy()).to(device)
    texts, entry = [], None
    for k, shape in enumerate(SRGB_SHAPES):
        img = srgb_image(shape, 31 + k)
        x = torch.from_numpy(img).to(device)
        want = to_uint8(torch.from_numpy(img))   # the numpy encode
        before = srgb_encode.launches
        got = to_uint8(x)
        if srgb_encode.launches != before + 1:
            raise AssertionError(f"sRGB encode {shape}: "
                                 f"{srgb_encode.launches - before} launches "
                                 f"in to_uint8, want 1")
        lib = searchsorted_encode(x, table).cpu().numpy()
        off = {"kernel": int((got != want).sum()),
               "library": int((lib != want).sum())}
        if any(off.values()):
            raise AssertionError(f"sRGB encode {shape}: values off the numpy "
                                 f"encode {off}")
        ms = device_ms(lambda: srgb_encode(x, True), 50)
        issue = host_ms(lambda: srgb_encode(x, True), 50)
        lib_ms = device_ms(lambda: searchsorted_encode(x, table), 50)
        lib_issue = host_ms(lambda: searchsorted_encode(x, table), 50)
        call = host_ms(lambda: to_uint8(x), 20)
        plain = host_ms(lambda: to_uint8(x.cpu()), 5)
        b = bound(5 * img.size, 0)
        texts.append(
            f"{shape[1]}x{shape[0]}x{shape[2]}: equal to the numpy encode "
            f"(kernel and library), {ms * 1e3:.2f} us on the card (bound "
            f"{b['bound_ms'] * 1e3:.2f} us by {b['bytes']} B: "
            f"{b['bound_ms'] / ms:.1%}), {issue:.4f} ms a launch on the "
            f"host; to_uint8 with its pinned copy {call:.3f} ms, the numpy "
            f"path after a blocking copy {plain:.2f} ms; torch.searchsorted "
            f"{lib_ms * 1e3:.2f} us on the card, {lib_issue:.4f} ms on the "
            f"host")
        entry = dict(ms=ms, plain_ms=plain, plain_rays=shape[0] * shape[1],
                     max_abs_err=0.0, mismatches=0, library_ms=lib_ms, **b)
    print(f"phase 2g sRGB encode vs numpy: {'; '.join(texts)}", flush=True)
    return entry


def phase9_textured(device, terrain_tex, terrain_nee_tex, large_tex, card):
    """The textured paths: the forward render of terrain_tex through the
    closest-hit kernel's textured variant and of terrain190k_tex through
    the streaming kernel's, the NEE render of terrain_nee_tex (the
    any-hit kernel on a textured scene), image parity, the
    texture-recovery training step and gradient parity → the textured
    variants' launch counts of the forward renders, and the row-major
    scatter-add's of the training steps."""
    scene, cam = terrain_tex
    params = rt.RenderParams(**PARAMS)
    counts = {}
    for name, (s, c), key in (("terrain_tex", terrain_tex, "closest_hit_tex"),
                              ("terrain190k_tex", large_tex,
                               "blocked_hit_tex")):
        img, got = render_path(name, s, c, params,
                               launches(**{key: FRAMES * (BOUNCES + 1)}))
        counts[key] = got[key]
        print(f"phase 9 textured forward: {name} {s.num_tris} tris, "
              f"{s.num_textures} textures of {TEX_RES}x{TEX_RES} (albedo and "
              f"normal map) {W}x{H} b{BOUNCES} {FRAMES} frames: launches "
              f"{got}; image mean {float(img.mean()):.4f} | {card}",
              flush=True)
        del img
    nee_render("9", "terrain_nee_tex", *terrain_nee_tex,
               rt.RenderParams(**PARAMS, **NEE),
               launches(closest_hit_tex=FRAMES * (BOUNCES + 1),
                        any_hit=FRAMES * BOUNCES), card)
    off, diff = image_parity("terrain_tex", scene, cam)
    line, totals = train_path("terrain_tex", scene, cam, card,
                              TEX_TRAIN_STEPS, "closest_hit_tex",
                              textured=True)
    counts["scatter_rows_rows"] = totals["scatter_rows_rows"]
    print(f"phase 9 texture recovery: {line}", flush=True)
    torch.cuda.empty_cache()
    equal, gdiff, scales, worst, leaf = grad_parity(scene, cam, params,
                                                    size=(128, 72))
    if not scales["textures"]:
        raise AssertionError("gradient parity: the textures' gradient is "
                             "zero")
    uv = {k: scales[k] for k in ("textures", "tri_uv0", "tri_uv1",
                                 "tri_uv2")}
    print(f"phase 9 textured parity (terrain_tex, cuda vs torch): 256x144 "
          f"image frac_off {off} (gate {PARITY_GATE}), max |diff| {diff}; "
          f"128x72 b{BOUNCES} gradient over {len(scales)} float leaves, all "
          f"finite, images equal {equal} (max |diff| {gdiff}), largest max "
          f"|diff| / max |g| {worst:.3g} ({leaf}; gate {GRAD_PARITY}); max "
          f"|g| of the texture leaves {uv}", flush=True)
    return counts


# --------------------------------------------------------------------------
# Phase 10: the image extras
# --------------------------------------------------------------------------

AOV_RTOL, AOV_ATOL = 3e-4, 1e-5   # AOVs kernel vs plain (the reference's)
AOV_SIZES = ((256, 144), (250, 142))   # the second does not divide into
                                       # 16x8 blocks
ADAPTIVE_FRAMES, ADAPTIVE_CHUNK = 16, 8
ADAPTIVE_TARGET, ADAPTIVE_MAX = 0.05, 64   # the ungated adaptive run
DENOISE_ITERATIONS = 3
REMAT_RTOL, REMAT_ATOL = 1e-3, 1e-7   # tests/test_grad.py's remat bound
COMPACTIONS = ("octant", "morton")


def aov_path(label, scene, cam, key):
    """Every AOV of ``scene`` at 1920x1080 through ``render_aov``: each
    call launches kernel ``key`` once and no other kernel but, on an
    untextured scene, the hit-record kernel once → text."""
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**PARAMS)
    for aov in renderer.AOVS:
        reset_counts()
        img = rt.render_aov(scene, basis, params, aov)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != launches(**{key: 1},
                              hit_record=int(key not in TEXTURED)):
            raise AssertionError(f"{label} AOV {aov}: launches {counts}")
        if img.shape[:2] != (H, W) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label} AOV {aov} is not finite (H, W, C)")
    return f"{label} ({key} x1 each): " + ", ".join(renderer.AOVS)


def aov_parity(scene, cam):
    """Every AOV through the kernels and through the plain path on the same
    tensors, at each of AOV_SIZES: coverage equal, depth and normal (and
    albedo) within AOV_RTOL / AOV_ATOL on hit pixels → text."""
    out = []
    for w, h in AOV_SIZES:
        basis = rt.camera_basis(cam.replace(aspect=w / h))
        params = rt.RenderParams(**dict(PARAMS, width=w, height=h))
        got = {b: {aov: rt.render_aov(scene, basis,
                                      params.replace(backend=b), aov)
                   for aov in renderer.AOVS} for b in ("cuda", "torch")}
        if not torch.equal(got["cuda"]["hit"], got["torch"]["hit"]):
            raise AssertionError(f"AOV parity {w}x{h}: coverage differs")
        hit = got["torch"]["hit"][..., 0] > 0
        worst = 0.0
        for aov in ("depth", "normal", "albedo"):
            a, b = got["cuda"][aov][hit], got["torch"][aov][hit]
            excess = float(((a - b).abs()
                            / (AOV_ATOL + AOV_RTOL * b.abs())).max())
            if excess > 1.0:
                raise AssertionError(f"AOV parity {w}x{h} {aov}: "
                                     f"{excess} x the tolerance")
            worst = max(worst, excess)
        out.append(f"{w}x{h} {int(hit.sum())} hit pixels, worst "
                   f"{worst:.3g} of the tolerance")
    return "; ".join(out)


def leaf_grads(scene, fields, fn):
    """(fn's output detached, d(fn(scene with fresh leaves).sum()) /
    d(each leaf of ``fields``), zero where unused)."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in fields}
    out = fn(dataclasses.replace(scene, **leaves))
    g = torch.autograd.grad(out.sum(), list(leaves.values()),
                            allow_unused=True)
    return out.detach(), {k: torch.zeros_like(leaves[k]) if gk is None
                          else gk for k, gk in zip(fields, g)}


def aov_grad_parity(scene, cam):
    """The gradient of the 256x144 depth AOV's sum with respect to every
    float leaf through B1 + B2 against the plain path → text."""
    basis = rt.camera_basis(cam.replace(aspect=256 / 144))
    params = rt.RenderParams(**dict(PARAMS, width=256, height=144))
    grads = {b: leaf_grads(scene, float_fields(scene), lambda s, b=b:
                           rt.render_aov(s, basis, params.replace(backend=b),
                                         "depth"))[1]
             for b in ("cuda", "torch")}
    worst, leaf, scales = grad_gate("depth AOV gradient", grads["cuda"],
                                    grads["torch"])
    if not scales["tri_v0"]:
        raise AssertionError("depth AOV gradient: tri_v0's is zero")
    return (f"256x144 depth-AOV gradient over {len(scales)} float leaves, "
            f"all finite, tri_v0 max |g| {scales['tri_v0']:.4g}, largest "
            f"max |diff| / max |g| {worst:.3g} ({leaf}; gate {GRAD_PARITY})")


def adaptive_path(scene, cam):
    """``render_adaptive`` at target 0 (never met: ADAPTIVE_FRAMES frames,
    frames x (bounces + 1) closest-hit launches, the mean within rtol 1e-4
    of ``render_progressive`` over the same frames), then one ungated run
    at ADAPTIVE_TARGET → text."""
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**PARAMS)
    reset_counts()
    mean, used = rt.render_adaptive(scene, basis, params, ADAPTIVE_FRAMES,
                                    0.0, chunk=ADAPTIVE_CHUNK)
    torch.cuda.synchronize()
    counts = read_counts()
    want = launches(closest_hit=ADAPTIVE_FRAMES * (BOUNCES + 1),
                    hit_record=ADAPTIVE_FRAMES * (BOUNCES + 1))
    if used != ADAPTIVE_FRAMES or counts != want:
        raise AssertionError(f"adaptive: {used} frames, launches {counts}")
    prog = render_progressive(scene, basis, params, ADAPTIVE_FRAMES)
    excess = float(((mean - prog).abs() / (1e-6 + 1e-4 * prog.abs())).max())
    if excess > 1.0:
        raise AssertionError(f"adaptive mean vs progressive: {excess} x "
                             f"the tolerance")
    _, used_t = rt.render_adaptive(scene, basis, params, ADAPTIVE_MAX,
                                   ADAPTIVE_TARGET, chunk=ADAPTIVE_CHUNK)
    return (f"target 0: {used} frames, {counts['closest_hit']} closest-hit "
            f"launches, mean vs render_progressive worst {excess:.3g} of "
            f"rtol 1e-4; target {ADAPTIVE_TARGET} (chunk {ADAPTIVE_CHUNK}, "
            f"cap {ADAPTIVE_MAX}, ungated): {used_t} frames")


def denoise_path(scene, cam):
    """``denoise_render`` on a 1-frame 1080p render without coherent
    scatter, as the reference's test renders (coherent scatter shares a
    tile's diffuse draw, so its noise comes in 512-pixel blotches, not
    from pixel to pixel): finite, the image mean within 5%, the
    high-frequency energy (mean |difference between rows|) below 0.6 of
    the input's → text."""
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**dict(PARAMS, coherent_scatter=False))
    img = render_frame(scene, basis, params, 0)
    out = rt.denoise_render(scene, basis, params, img,
                            iterations=DENOISE_ITERATIONS)
    if out.shape != img.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("denoised image is not finite (H, W, 3)")
    m_in, m_out = float(img.mean()), float(out.mean())
    if not abs(m_out - m_in) < 0.05 * m_in:
        raise AssertionError(f"denoise moved the mean {m_in} -> {m_out}")

    def hf(x):
        return float((x[1:] - x[:-1]).abs().mean())

    if not hf(out) < 0.6 * hf(img):
        raise AssertionError(f"denoise: high frequencies {hf(img)} -> "
                             f"{hf(out)}")
    return (f"1080p, {DENOISE_ITERATIONS} iterations: mean {m_in:.5f} -> "
            f"{m_out:.5f}, high frequencies {hf(img):.5f} -> {hf(out):.5f} "
            f"({hf(out) / hf(img):.3f} x, gate 0.6)")


def qmc_path(scene, cam, card):
    """The 8-frame ``qmc=True`` render through ``render_path`` (closest-hit
    launches frames x (bounces + 1), finite, not constant) → text."""
    img, counts = render_path(
        "terrain qmc", scene, cam, rt.RenderParams(**PARAMS, qmc=True),
        launches(closest_hit=FRAMES * (BOUNCES + 1),
                 hit_record=FRAMES * (BOUNCES + 1)))
    return (f"{counts['closest_hit']} closest-hit launches; image mean "
            f"{float(img.mean()):.4f} | {card}")


def frame_queries(scene, cam, params):
    """One frame of the path with every hit and shadow query recorded:
    ([(o, d, alive)] per segment as ``intersect`` gets them, [(o, d,
    alive)] per shadow query as ``occluded`` gets them)."""
    hits, shadows = [], []
    real_hit, real_occ = renderer.intersect, renderer.occluded

    def spy_hit(scene, o, d, t_min, backend, alive):
        hits.append(tuple(x.detach().contiguous() for x in (o, d, alive)))
        return real_hit(scene, o, d, t_min=t_min, backend=backend,
                        alive=alive)

    def spy_occ(scene, o, d, t_min, backend, alive):
        shadows.append(tuple(x.detach().contiguous() for x in (o, d, alive)))
        return real_occ(scene, o, d, t_min=t_min, backend=backend,
                        alive=alive)

    renderer.intersect, renderer.occluded = spy_hit, spy_occ
    try:
        render_frame(scene, rt.camera_basis(cam), params, 0)
    finally:
        renderer.intersect, renderer.occluded = real_hit, real_occ
    return hits, shadows


def sort_order(scene, mode, o, d, alive):
    """The permutation ``renderer.trace`` applies before a segment."""
    if mode == "octant":
        return renderer._octant_order(d, alive)
    return renderer._morton_order(*renderer._scene_aabb(scene), o, d, alive)


def reorder_ms(scene, mode, o, d, alive):
    """ms of one segment's reorder in ``trace`` without NEE: the sort
    order, the same order sorted on int64 keys (the reference's uint32
    key as the port holds it; the port sorts uint8 octants and int32
    Morton keys), and the order with the gathers of the seven per-lane
    tensors (nine with NEE)."""
    R = o.shape[0]
    carry = (o, d, o.clone(), d.clone(), alive,
             torch.zeros(R, dtype=torch.int64, device=o.device),
             torch.arange(R, device=o.device))
    aabb = renderer._scene_aabb(scene)

    def order():
        if mode == "octant":
            return renderer._octant_order(d, alive)
        return renderer._morton_order(*aabb, o, d, alive)

    def wide_order():
        if mode == "octant":
            key = torch.where(alive, renderer._octant(d), 8)
        else:
            key = renderer._ray_sort_key(*aabb, o, d, alive)
        return torch.argsort(key, stable=True)

    def reorder():
        idx = order()
        return [x.index_select(0, idx) for x in carry]

    if not torch.equal(order(), wide_order()):
        raise AssertionError(f"{mode}: the narrow keys sort differently")
    return cuda_ms(order, 10), cuda_ms(wide_order, 10), cuda_ms(reorder, 10)


@ch.plane_scope()   # the kernels timed with the scene's planes packed once
def sorted_kernel_times(scene, cam, params, kernel):
    """``kernel`` (the closest-hit wrapper, or "any_hit") timed on each
    wavefront of one frame of the path, unsorted and in each compaction's
    order (the same rays; the shadow rays of a segment in the order of its
    path rays, as the compacted trace hands them over), with the sort's
    ms and the live share → (text, {mode: [ms per wavefront]})."""
    hits, shadows = frame_queries(scene, cam, params)
    waves = []
    if kernel == "any_hit":
        for seg in (0, 1):
            o, d, alive = shadows[seg]
            waves.append((f"shadow {seg}", hits[seg], (o, d, alive)))
    else:
        waves = [(f"bounce {seg}", w, w) for seg, w in enumerate(hits)]
    out, times = [], {m: [] for m in ("off",) + COMPACTIONS}
    for label, path, (o, d, alive) in waves:
        if kernel == "any_hit":
            def run(o, d, alive):
                return ah.anyhit(scene, o, d, 1e-4, ah.SHADOW_T_MAX, alive)
        else:
            def run(o, d, alive):
                return kernel(scene, o, d, 1e-4, alive=alive)
        ms = {"off": cuda_ms(lambda: run(o, d, alive), 20)}
        ref = run(o, d, alive)
        sort = {}
        for mode in COMPACTIONS:
            idx = sort_order(scene, mode, *path)
            os_, ds, als = (x.index_select(0, idx) for x in (o, d, alive))
            got = run(os_, ds, als)
            same = (got if kernel == "any_hit" else got[1]).eq(
                (ref if kernel == "any_hit" else ref[1]).index_select(0, idx))
            if not bool(same.all()):
                raise AssertionError(f"sorted {label} ({mode}): the kernel's "
                                     f"result moved")
            ms[mode] = cuda_ms(lambda: run(os_, ds, als), 20)
            sort[mode] = reorder_ms(scene, mode, *path)
        for m in times:
            times[m].append(ms[m])
        out.append(
            f"{label} ({float(alive.float().mean()):.1%} live): "
            f"unsorted {ms['off']:.3f}, " + ", ".join(
                f"{m} {ms[m]:.3f} (sort {sort[m][0]:.3f}, on int64 keys "
                f"{sort[m][1]:.3f}, with the gathers {sort[m][2]:.3f})"
                for m in COMPACTIONS))
    return "; ".join(out), times


def compaction_equality(label, scene, cam, params):
    """Coherent scatter off: each compacted 1080p frame equals the
    uncompacted one bit for bit → text."""
    basis = rt.camera_basis(cam)
    params = params.replace(coherent_scatter=False)
    off = render_frame(scene, basis, params, 0)
    for mode in COMPACTIONS:
        got = render_frame(scene, basis, params.replace(compaction=mode), 0)
        if not torch.equal(got, off):
            raise AssertionError(f"{label} {mode}: the compacted frame "
                                 f"differs by {float((got - off).abs().max())}")
    return f"{label} bit-equal"


def step_launches(scene, cam, params):
    """One ``make_train_step`` step at ``params`` from train_setup's start
    → its launches."""
    basis = rt.camera_basis(cam)
    with torch.no_grad():
        target = render_frame(scene, basis, params, 0)
    start = dataclasses.replace(
        scene, tri_albedo=scene.tri_albedo * ALBEDO_START,
        sphere_albedo=scene.sphere_albedo * ALBEDO_START)
    init_fn, step_fn = make_train_step(params, train_optimizer)
    trainable, opt = init_fn(start, DEFAULT_TRAINABLE)
    reset_counts()
    step_fn(trainable, opt, start, basis, target, 0)
    torch.cuda.synchronize()
    return read_counts()


def compaction_training(scene, cam):
    """The 256x144 training gradient with each compaction against without
    (coherent scatter off) → text."""
    basis = rt.camera_basis(cam.replace(aspect=256 / 144))
    params = rt.RenderParams(**dict(PARAMS, width=256, height=144,
                                    coherent_scatter=False))
    with torch.no_grad():
        target = 0.5 * render_frame(scene, basis, params, 1)

    def loss(p):
        return lambda s: ((render_frame(s, basis, p, 0) - target) ** 2).mean()

    fields = float_fields(scene)
    _, ref = leaf_grads(scene, fields, loss(params))
    out = []
    for mode in COMPACTIONS:
        _, g = leaf_grads(scene, fields, loss(params.replace(compaction=mode)))
        worst, leaf, _ = grad_gate(f"compacted gradient ({mode})", g, ref)
        out.append(f"{mode} largest max |diff| / max |g| {worst:.3g} "
                   f"({leaf})")
    return (f"256x144 gradient vs uncompacted (coherent off, gate "
            f"{GRAD_PARITY}): " + ", ".join(out))


def remat_path(scene, cam, card):
    """One 1080p training step (the MSE over DEFAULT_TRAINABLE from
    train_setup's start) with remat against without: the forward images
    bit-equal, the gradients within REMAT_RTOL / REMAT_ATOL, the launches
    of each step → text."""
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**PARAMS)
    with torch.no_grad():
        target = render_frame(scene, basis, params, 0)
    start = dataclasses.replace(
        scene, tri_albedo=scene.tri_albedo * ALBEDO_START,
        sphere_albedo=scene.sphere_albedo * ALBEDO_START)
    got = {}
    for remat in (False, True):
        leaves = {k: getattr(start, k).detach().clone().requires_grad_(True)
                  for k in DEFAULT_TRAINABLE}
        img = render_frame(dataclasses.replace(start, **leaves), basis,
                           params.replace(remat=remat), 0)
        g = torch.autograd.grad(((img - target) ** 2).mean(),
                                list(leaves.values()))
        got[remat] = (img.detach(), dict(zip(leaves, g)))
    if not torch.equal(got[False][0], got[True][0]):
        raise AssertionError("remat changed the forward image")
    worst = 0.0
    for k in DEFAULT_TRAINABLE:
        a, b = got[True][1][k], got[False][1][k]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"remat gradient of {k} is not finite")
        excess = float(((a - b).abs() / (REMAT_ATOL + REMAT_RTOL * b.abs()))
                       .max())
        if excess > 1.0:
            raise AssertionError(f"remat gradient of {k}: {excess} x the "
                                 f"tolerance")
        worst = max(worst, excess)
    text = []
    for remat in (False, True):
        c = step_launches(scene, cam, params.replace(remat=remat))
        # remat's backward reruns each segment's forward, recompute too
        seg = (BOUNCES + 1) * (2 if remat else 1)
        if (c["hit_record"], c["hit_record_vjp"]) != (seg, BOUNCES + 1):
            raise AssertionError(f"remat={remat}: launches {c}, want "
                                 f"{seg} hit-record and {BOUNCES + 1} "
                                 f"hit-record VJP a step")
        torch.cuda.empty_cache()
        text.append(f"remat={remat}: {c['closest_hit']} closest-hit, "
                    f"{c['scatter_rows']} scatter-add, {c['hit_record']} "
                    f"hit-record and {c['hit_record_vjp']} hit-record VJP "
                    f"launches a step")
    return (f"forward bit-equal, gradient worst {worst:.3g} of rtol "
            f"{REMAT_RTOL} / atol {REMAT_ATOL}; " + "; ".join(text)
            + f" | {card}")


def phase10_image_extras(device, terrain, terrain_nee, terrain_tex, large,
                         card):
    """The image extras on the card: AOVs, adaptive sampling, QMC, the
    denoiser, wavefront compaction and remat (module docstring)."""
    print("phase 10 AOVs 1080p: " + "; ".join(
        aov_path(label, *scene, key) for label, scene, key in (
            ("terrain", terrain, "closest_hit"),
            ("terrain190k", large, "blocked_hit"),
            ("terrain_tex", terrain_tex, "closest_hit_tex"))), flush=True)
    print(f"phase 10 AOV parity (terrain, cuda vs torch): "
          f"{aov_parity(*terrain)}; {aov_grad_parity(*terrain)}", flush=True)
    print(f"phase 10 adaptive (terrain 1080p): {adaptive_path(*terrain)}",
          flush=True)
    print(f"phase 10 QMC (terrain 1080p, {FRAMES} frames): "
          f"{qmc_path(*terrain, card)}", flush=True)
    print(f"phase 10 denoiser (terrain, coherent scatter off): "
          f"{denoise_path(*terrain)}",
          flush=True)
    params = rt.RenderParams(**PARAMS)
    print("phase 10 compaction equality (coherent scatter off, 1080p, "
          f"{' and '.join(COMPACTIONS)} vs off): " + "; ".join(
              compaction_equality(label, *scene, p) for label, scene, p in (
                  ("terrain", terrain, params),
                  ("terrain190k", large, params),
                  ("terrain_nee", terrain_nee,
                   params.replace(**NEE)))), flush=True)
    for label, scene, kernel, p in (
            ("B1 terrain", terrain, ch.nearest_hit_attrs, params),
            ("B4 terrain190k", large, bh.nearest_hit_blocked, params),
            ("B3 terrain_nee", terrain_nee, "any_hit",
             params.replace(**NEE))):
        text, _ = sorted_kernel_times(*scene, p, kernel)
        print(f"phase 10 compaction kernel ms, {label} 1080p wavefronts "
              f"(sorted vs unsorted, same rays): {text} | {card}",
              flush=True)
    print(f"phase 10 compaction training (terrain): "
          f"{compaction_training(*terrain)}", flush=True)
    print(f"phase 10 remat (terrain 1080p training step): "
          f"{remat_path(*terrain, card)}", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: mesh recovery and model loading
# ---------------------------------------------------------------------------

# the teapot-scale torus: R 1, r 0.4, 112 x 70 quads → 7,840 vertices,
# 15,680 triangles (the reference's teapot: 7,850 and 15,704)
TORUS = dict(R=1.0, r=0.4, nu=112, nv=70)
TORUS_TEX = 256        # its base-colour map, TORUS_TEX x TORUS_TEX RGB
EDGE_SAMPLES = 4096    # boundary samples a family (the reference's default)
EDGE_TRAIN_STEPS = 4   # 1080p training steps with edge gradients
# the reference CPU test's recovery (tests/test_invert_vertices.py:95-122)
OCTA = dict(subdiv=2, size=64, views=4, steps=300, edge_samples=1024,
            sobolev_lam=2.0, frame_cycle=2, ext=2.0)
OCTA_BARS = dict(rms=0.02, albedo=0.03, loss_ratio=0.1)
# BASELINE config 5 (tools/invert_vertices.py:main) on the torus, its 600
# steps cut to 400 to keep the phase near 90 s: on an NVIDIA H100 80GB
# HBM3 at 700.00 W the 600 steps took 63.6 s (0.106 s/step) and reached an
# offset RMS of 0.00118
FULL = dict(size=128, views=6, steps=400, edge_samples=4096,
            sobolev_lam=50.0, smooth_weight=0.08, frame_cycle=2, seed=1)
FULL_STEPS_REFERENCE = 600
FULL_BARS = dict(rms=0.01, albedo=0.05)   # the reference's "recovered"
START_RMS = 0.10
START_ALBEDO = (0.35, 0.6, 0.55)
MODEL_DIR = os.path.join("build", "chip_smoke_models")


def torus_mesh(R, r, nu, nv):
    """Closed torus around the y axis: (positions, normals, uvs, indices),
    nu x nv vertices, 2 nu nv triangles wound outward, UVs (i / nu,
    j / nv)."""
    u = np.arange(nu) * (2 * np.pi / nu)
    v = np.arange(nv) * (2 * np.pi / nv)
    U, V = np.meshgrid(u, v, indexing="ij")
    ring = R + r * np.cos(V)
    pos = np.stack([ring * np.cos(U), r * np.sin(V), ring * np.sin(U)], -1)
    nrm = np.stack([np.cos(V) * np.cos(U), np.sin(V),
                    np.cos(V) * np.sin(U)], -1)
    uv = np.stack(np.meshgrid(np.arange(nu) / nu, np.arange(nv) / nv,
                              indexing="ij"), -1)
    i = np.arange(nu * nv).reshape(nu, nv)
    a, b = i, np.roll(i, -1, 0)
    c, d = np.roll(i, -1, 1), np.roll(b, -1, 1)
    tri = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                          np.stack([b, c, d], -1).reshape(-1, 3)])
    pos, nrm = pos.reshape(-1, 3), nrm.reshape(-1, 3)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                  pos[tri[:, 2]] - pos[tri[:, 0]])
    if np.mean(np.sum(fn * nrm[tri[:, 0]], -1)) < 0:
        tri = tri[:, ::-1]
    return (pos.astype(np.float32), nrm.astype(np.float32),
            uv.reshape(-1, 2).astype(np.float32),
            np.ascontiguousarray(tri).reshape(-1).astype(np.uint32))


def octasphere(subdiv=2, radius=1.0):
    """Subdivided octahedron projected to the sphere (the reference test's
    closed mesh, tests/test_invert_vertices.py:25)."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], np.float64)
    f = [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]]
    for _ in range(subdiv):
        nf, cache, vl = [], {}, v.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.array(vl[a]) + np.array(vl[b])) / 2
                cache[key] = len(vl)
                vl.append((m / np.linalg.norm(m)).tolist())
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.array(vl), nf
    return (v * radius).astype(np.float32), np.array(f, np.int64)


def write_obj(path, pos, nrm, idx, uvs=None, mtl=None):
    """An OBJ with one vertex, normal (and UV) line per vertex and faces
    indexing all three alike; ``mtl`` = (mtllib file, material name)."""
    n = np.arange(1, pos.shape[0] + 1)
    with open(path, "w") as f:
        if mtl:
            f.write(f"mtllib {mtl[0]}\nusemtl {mtl[1]}\n")
        np.savetxt(f, pos, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, nrm, fmt="vn %.9g %.9g %.9g")
        if uvs is not None:
            # OBJ's v runs up; the loaders flip it to the renderer's v-down
            np.savetxt(f, np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], -1),
                       fmt="vt %.9g %.9g")
        corners = np.repeat(n[idx.reshape(-1, 3)], 3 if uvs is not None
                            else 2, axis=1)
        fmt = ("f %d/%d/%d %d/%d/%d %d/%d/%d" if uvs is not None
               else "f %d//%d %d//%d %d//%d")
        np.savetxt(f, corners, fmt=fmt)


def write_glb(path, pos, nrm, uvs, idx, png):
    """A GLB of one textured mesh: positions, normals, UVs, uint32
    indices and the PNG ``png`` embedded as a bufferView image."""
    parts = [pos.astype(np.float32).tobytes(), nrm.astype(np.float32)
             .tobytes(), uvs.astype(np.float32).tobytes(),
             idx.astype(np.uint32).tobytes(), png]
    views, blob = [], b""
    for p in parts:
        blob += b"\0" * ((-len(blob)) % 4)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(p)})
        blob += p
    blob += b"\0" * ((-len(blob)) % 4)
    n = pos.shape[0]
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"name": "torus", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": 4, "mimeType": "image/png"}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": n,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": n,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": idx.size,
             "type": "SCALAR"}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def write_models():
    """The phase's model files in MODEL_DIR: terrain190k.obj (the
    heightfield at n=LARGE_N, winding as terrain_scene), torus.obj with
    torus.mtl and its map_Kd torus.png (written by the port's PNG codec),
    and torus.glb with the PNG embedded → their paths."""
    os.makedirs(MODEL_DIR, exist_ok=True)
    verts, normals, idx = heightfield(LARGE_N, 4.0, -1.0,
                                      np.random.default_rng(0))
    idx = idx.reshape(-1, 3)[:, ::-1].reshape(-1)
    paths = {k: os.path.join(MODEL_DIR, k) for k in
             ("terrain190k.obj", "torus.obj", "torus.glb")}
    write_obj(paths["terrain190k.obj"], verts, normals, idx)
    pos, nrm, uvs, tidx = torus_mesh(**TORUS)
    png = encode_png(texture_images(TORUS_TEX)[0], filters=4)
    with open(os.path.join(MODEL_DIR, "torus.png"), "wb") as f:
        f.write(png)
    with open(os.path.join(MODEL_DIR, "torus.mtl"), "w") as f:
        f.write("newmtl torus\nKd 1 1 1\nmap_Kd torus.png\n")
    write_obj(paths["torus.obj"], pos, nrm, tidx, uvs, ("torus.mtl", "torus"))
    write_glb(paths["torus.glb"], pos, nrm, uvs, tidx, png)
    return paths


def same_meshes(a, b):
    """Two load_meshes results hold equal arrays and materials."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for k in ("positions", "normals", "indices", "uvs"):
            u, v = getattr(x, k), getattr(y, k)
            if (u is None) != (v is None) or (
                    u is not None and not np.array_equal(u, v)):
                return False
        mx, my = x.material or {}, y.material or {}
        if mx.keys() != my.keys() or not all(
                np.array_equal(mx[k], my[k]) for k in mx):
            return False
    return True


def load_both_parsers(path):
    """load_meshes through the native parser and through the Python one:
    both must run here and agree."""
    if not native.available():
        raise AssertionError("the native OBJ parser did not build here")
    fast = loaders.load_meshes(path)
    parse = native.parse_obj
    native.parse_obj = lambda p: None     # the pure-Python parser
    try:
        slow = loaders.load_meshes(path)
    finally:
        native.parse_obj = parse
    if not same_meshes(fast, slow):
        raise AssertionError(f"{path}: the native and Python parsers differ")


def loaded_scene(path, device, **kw):
    """``load_model`` of ``path`` at the origin into a new builder, built
    on ``device``."""
    b = rt.SceneBuilder(texture_resolution=TEX_RES)
    rt.load_model(path, b, placement="origin", **kw)
    return b.build(device=device)


def torus_camera(aspect):
    return rt.Camera(origin=(0.0, 1.6, 2.6), look_at=(0.0, 0.0, 0.0),
                     fov=45.0, aspect=aspect)


def loading_path(device, paths, card):
    """Part 1: the models through both parsers, then the loaded terrain190k
    OBJ (B4) and textured GLB torus (B1-tex) rendered at the main path's
    settings and held to the plain path at 256x144."""
    objs = ("terrain190k.obj", "torus.obj")
    for k in objs:
        load_both_parsers(paths[k])
    big = loaded_scene(paths["terrain190k.obj"], device,
                       albedo=(0.7, 0.5, 0.3), smoothness=0.3)
    glb = loaded_scene(paths["torus.glb"], device)
    if big.num_tris != 2 * (LARGE_N - 1) ** 2 or not bh.uses_blocked(big):
        raise AssertionError(f"the loaded OBJ has {big.num_tris} triangles")
    if glb.num_textures != 1 or glb.num_tris != 2 * TORUS["nu"] * TORUS["nv"]:
        raise AssertionError("the loaded GLB lost its texture or triangles")
    params = rt.RenderParams(**PARAMS)
    cam = rt.Camera(origin=(0.0, 1.5, 6.0), look_at=(0.0, -0.8, 0.0),
                    fov=45.0, aspect=W / H)
    out = []
    for label, scene, cam_, key in (
            ("terrain190k.obj", big, cam, "blocked_hit"),
            ("torus.glb", glb, torus_camera(W / H), "closest_hit_tex")):
        _, c = render_path(
            f"loaded {label}", scene, cam_, params,
            launches(**{key: FRAMES * (BOUNCES + 1)},
                     hit_record=0 if key in TEXTURED
                     else FRAMES * (BOUNCES + 1)))
        off, diff = image_parity(f"loaded {label}", scene, cam_)
        out.append(f"{label} {scene.num_tris} tris: {c[key]} {key} "
                   f"launches, 256x144 parity frac_off {off} (gate "
                   f"{PARITY_GATE}) max |diff| {diff}")
    print(f"phase 11 loading (native parser built: {native.available()}): "
          f"{' and '.join(objs)} equal through both parsers; torus.glb's "
          f"texture {TORUS_TEX}x{TORUS_TEX} PNG decoded by the port's codec "
          f"| {card}", flush=True)
    print(f"phase 11 loaded renders {W}x{H} b{BOUNCES} {FRAMES} frames: "
          + "; ".join(out) + f" | {card}", flush=True)


def estimator_check(label, scene, cam, params, cot, topo, n_sph):
    """The estimator on ``scene`` through the kernels against the plain
    path on the same draws (grad_gate), its B1 launches held to 2 side
    traces x (bounces + 1) a family → text."""
    basis = rt.camera_basis(cam)
    g = torch.Generator(device=scene.device)
    g.manual_seed(1)
    draws = edges.draw_edge_samples(scene, basis, params, g, EDGE_SAMPLES,
                                    n_sph, topo)
    reset_counts()
    got = edges.gradients_from_draws(scene, basis, params, cot, draws,
                                     topology=topo)
    torch.cuda.synchronize()
    counts = read_counts()
    families = 1 + (n_sph > 0 and scene.num_spheres > 0)
    key = "closest_hit_tex" if scene.num_textures else "closest_hit"
    n = 2 * (params.bounces + 1) * families
    want = launches(**{key: n}, hit_record=0 if scene.num_textures else n)
    if counts != want:
        raise AssertionError(f"{label} estimator launches {counts} != {want}")
    ref = edges.gradients_from_draws(scene, basis,
                                     params.replace(backend="torch"), cot,
                                     draws, topology=topo)
    worst, leaf, scales = grad_gate(f"{label} estimator", got, ref)
    if not any(scales[k] > 0 for k in ("tri_v0", "tri_v1", "tri_v2")):
        raise AssertionError(f"{label} estimator: all-zero edge gradient")
    return (f"{label} {params.width}x{params.height} b{params.bounces} "
            f"{EDGE_SAMPLES} edge + {n_sph if families > 1 else 0} sphere "
            f"samples: {counts[key]} {key} launches; kernels vs plain largest "
            f"max |diff| / max |g| {worst:.3g} ({leaf}; gate {GRAD_PARITY})")


def mse_cot(scene, start, basis, params):
    """The MSE cotangent 2 (img − target) / n of frame 0 of ``start``
    against frame 0 of ``scene``."""
    with torch.no_grad():
        target = render_frame(scene, basis, params, 0)
        img = render_frame(start, basis, params, 0)
    return 2.0 * (img - target) / img.numel()


def edge_train_steps(scene, cam, topo, card):
    """EDGE_TRAIN_STEPS 1080p training steps of phase 5's set-up with
    ``edge_samples=EDGE_SAMPLES`` and the topology:
    per step (bounces + 1) B1 and B2 launches for the interior gradient,
    bounces + 1 B1 for the frame the cotangent is taken from, and 2 side
    traces x (bounces + 1) a family; one packing; every gradient finite
    → text."""
    params = rt.RenderParams(**PARAMS)
    _, (_, _, start, basis, target, _) = train_setup(scene, cam)
    init_fn, step_fn = make_train_step(params, train_optimizer,
                                       edge_samples=EDGE_SAMPLES,
                                       topology=topo)
    trainable, opt = init_fn(start, DEFAULT_TRAINABLE)
    seg = BOUNCES + 1
    want = launches(closest_hit=seg + seg + 2 * 2 * seg, scatter_rows=seg,
                    hit_record=seg + seg + 2 * 2 * seg, hit_record_vjp=seg)
    losses = []
    for step in range(EDGE_TRAIN_STEPS):
        reset_counts()
        packs = ch.scene_planes.packs
        trainable, opt, loss = step_fn(trainable, opt, start, basis, target,
                                       0)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"edge training step {step}: launches "
                                 f"{counts}, want {want}")
        if ch.scene_planes.packs != packs + 1:
            raise AssertionError(f"edge training step {step} packed "
                                 f"{ch.scene_planes.packs - packs} times")
        losses.append(float(loss))
    for k, p in trainable.items():
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"edge training: {k}'s gradient not finite")
    return (f"terrain {W}x{H} b{BOUNCES} with edge_samples={EDGE_SAMPLES} "
            f"and topology, {EDGE_TRAIN_STEPS} steps: launches a step "
            f"{want}, 1 packing; loss {losses[0]:.6g} -> {losses[-1]:.6g} | "
            f"{card}")


def edge_path(device, terrain, paths, card):
    """Part 2: the estimator on the torus (the recovery's 128² view of a
    10%-perturbed torus) and on terrain at 1080p against the plain path;
    the 1080p training steps with edges."""
    torus, topo_t, center, ext = invert_vertices.recovery_scene(
        paths["torus.obj"], device)
    g = torch.Generator(device=device)
    g.manual_seed(FULL["seed"])
    # the offsets move vertices, not connectivity: the topology holds
    start = topology.apply_vertex_offsets(torus, topo_t, invert_vertices
                                          .smooth_field(g, topo_t.base_verts,
                                                        ext, START_RMS * ext))
    params = rt.RenderParams(width=FULL["size"], height=FULL["size"],
                             bounces=1, skybox=True)
    cam = rt.Camera(origin=tuple(center + ext * np.array([0.85, 0.4, 0.0])),
                    look_at=tuple(center), aspect=1.0, focus_dist=1.0)
    lines = [estimator_check("torus", start, cam, params,
                             mse_cot(torus, start, rt.camera_basis(cam),
                                     params), topo_t, 0)]
    scene, tcam = terrain
    topo = topology.build_topology(scene)
    start_t = dataclasses.replace(
        scene, tri_albedo=scene.tri_albedo * ALBEDO_START,
        sphere_albedo=scene.sphere_albedo * ALBEDO_START)
    tparams = rt.RenderParams(**PARAMS)
    lines.append(estimator_check(
        "terrain", start_t, tcam, tparams,
        mse_cot(scene, start_t, rt.camera_basis(tcam), tparams), topo,
        EDGE_SAMPLES))
    print("phase 11 edge gradients: " + "; ".join(lines) + f" | {card}",
          flush=True)
    print("phase 11 edge training: "
          + edge_train_steps(scene, tcam, topo, card), flush=True)


def recovery(label, scene, topo, center, ext, cfg):
    """``run_vertex_recovery`` at ``cfg`` from a START_RMS smooth field
    (seeded) and START_ALBEDO, its launches and packings counted over the
    run; finite, the loss of the last cycle of views below the first's,
    launches as the loop makes them: per
    view a coverage AOV and per (view, frame) pair a target before the
    loop (bounces + 1 launches each), then per step 2 for the frame, 1 for
    its coverage AOV and 2 side traces x 2, and 2 x 2 of the scatter-add
    (the frame's backward for the offsets, again for the albedo) → (line
    parts, rms, albedo error, losses)."""
    params = rt.RenderParams(width=cfg["size"], height=cfg["size"],
                             bounces=1, skybox=True)
    bases = invert_vertices.ring_cameras(center, ext, cfg["views"])
    g = torch.Generator(device=scene.device)
    g.manual_seed(cfg.get("seed", 1))
    start = invert_vertices.smooth_field(g, topo.base_verts, ext,
                                         START_RMS * ext)
    steps, seg = cfg["steps"], params.bounces + 1
    pairs = math.lcm(cfg["views"], cfg["frame_cycle"])
    key = "closest_hit_tex" if scene.num_textures else "closest_hit"
    before = cfg["views"] + seg * min(steps, pairs)
    n, tex = before + steps * (seg + 1 + 2 * seg), scene.num_textures
    want = launches(**{key: n}, scatter_rows=steps * 2 * seg,
                    hit_record=0 if tex else n,
                    hit_record_vjp=0 if tex else steps * 2 * seg)
    reset_counts()
    packs = ch.scene_planes.packs
    off, alb, losses = invert_vertices.run_vertex_recovery(
        scene, topo, params, bases, steps, start, np.array(START_ALBEDO),
        edge_samples=cfg["edge_samples"], frame_cycle=cfg["frame_cycle"],
        sobolev_lam=cfg["sobolev_lam"],
        smooth_weight=cfg.get("smooth_weight", 0.08),
        smooth_weight_end=cfg.get("smooth_weight", 0.08), ext=ext, log=False)
    torch.cuda.synchronize()
    counts = read_counts()
    packed = ch.scene_planes.packs - packs
    if counts != want:
        raise AssertionError(f"{label} recovery launches {counts} != {want}")
    if packed != steps + 1:
        raise AssertionError(f"{label} recovery packed {packed} times, want "
                             f"one a step and one for the truth")
    if not (np.isfinite(off).all() and np.isfinite(alb).all()
            and np.isfinite(losses).all()):
        raise AssertionError(f"{label} recovery is not finite")
    views = cfg["views"]   # a step's loss is its view's: compare cycles
    if not np.mean(losses[-views:]) < np.mean(losses[:views]):
        raise AssertionError(f"{label} recovery: the loss did not fall over "
                             f"a cycle of the views: {losses}")
    rms = float(np.sqrt(np.mean(np.sum(off ** 2, -1)))) / ext
    alb_err = float(np.abs(alb - invert_vertices.TRUE_ALBEDO).max())
    curve = [round(float(x), 6) for x in losses[::max(1, steps // 10)]]
    text = (f"{label} {scene.num_tris} tris {topo.num_verts} vertices, "
            f"{steps} steps {cfg['size']}x{cfg['size']} x {cfg['views']} "
            f"views, {cfg['edge_samples']} edge samples, lambda "
            f"{cfg['sobolev_lam']}: offset RMS {rms:.5f} of the extent "
            f"(start {START_RMS}), albedo error {alb_err:.4f}, loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g} (every "
            f"{max(1, steps // 10)}th: {curve}); "
            f"{packed / steps:.3f} packings a step, launches {counts} "
            f"({(counts[key] - before) / steps:.0f} {key} and "
            f"{counts['scatter_rows'] / steps:.0f} scatter-add a step)")
    return text, rms, alb_err, losses


def recovery_path(device, paths, card):
    """Parts 3 and 4: the reference CPU test's octasphere recovery, held to
    its bars, and BASELINE config 5 on the torus loaded from its OBJ,
    printed beside the reference's bars."""
    verts, faces = octasphere(OCTA["subdiv"])
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    scene = (rt.SceneBuilder()
             .add_mesh(verts, normals, faces.reshape(-1),
                       albedo=tuple(invert_vertices.TRUE_ALBEDO),
                       smoothness=0.0)
             .build(device=device))
    topo = topology.build_topology(scene)
    scene = topology.apply_vertex_offsets(
        scene, topo, torch.zeros((topo.num_verts, 3), device=device))
    text, rms, alb_err, losses = recovery("octasphere", scene, topo,
                                          np.zeros(3), OCTA["ext"], OCTA)
    if not (rms < OCTA_BARS["rms"] and alb_err < OCTA_BARS["albedo"]
            and losses[-1] < OCTA_BARS["loss_ratio"] * losses[0]):
        raise AssertionError(f"octasphere recovery misses the reference "
                             f"test's bars {OCTA_BARS}: {text}")
    print(f"phase 11 recovery (the reference CPU test's configuration, bars "
          f"{OCTA_BARS}): {text} | {card}", flush=True)
    torus, topo_t, center, ext = invert_vertices.recovery_scene(
        paths["torus.obj"], device)
    text, rms, alb_err, _ = recovery("torus", torus, topo_t, center, ext,
                                     FULL)
    print(f"phase 11 recovery at full width (BASELINE config 5 on the "
          f"loaded torus, {FULL['steps']} of its {FULL_STEPS_REFERENCE} "
          f"steps; the reference's recovered bars RMS < "
          f"{FULL_BARS['rms']}, albedo < {FULL_BARS['albedo']}): {text}; "
          f"recovered "
          f"{rms < FULL_BARS['rms'] and alb_err < FULL_BARS['albedo']} "
          f"(ungated) | {card}", flush=True)


def phase11_recovery(device, terrain, card):
    """Mesh recovery and model loading (module docstring)."""
    paths = write_models()
    loading_path(device, paths, card)
    edge_path(device, terrain, paths, card)
    torch.cuda.empty_cache()
    recovery_path(device, paths, card)
    return paths


# ---------------------------------------------------------------------------
# Phase 12: multi-device rendering and training on torch.distributed, the
# command line, the viewer, the differentiable camera and the metrics.
# ---------------------------------------------------------------------------

RANKS = 2                # the two-rank group: two processes on one card
CHUNKS = 2               # grad_chunks of the two-rank training step
SUBPROCESS_TIMEOUT = 600  # s for each rank and each command line process
CLI_DIR = os.path.join("build", "chip_smoke_cli")
VIEWER_KEYS = ("w", "d", "0", "B", "1", "R", "2", "b", "3", "r", "a")
VIEWER_FRAMES = 16
VIEWER_RESIZE = (1280, 720)
POSE_SIZE, POSE_STEPS = 64, 60       # the reference test's recovery, at 64²
POSE_OFFSET = (0.25, -0.15, 0.2)     # its start offset of the origin
POSE_BAR = 0.25          # its bar: final error < 0.25 x the start error


class GradProbe(torch.optim.SGD):
    """SGD at rate 0 that keeps the gradients each step hands it (in its
    parameters' order), so a training step's gradient can be compared and
    the trainables stay where they are."""

    def __init__(self, leaves):
        super().__init__(leaves, lr=0.0)
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for g in self.param_groups
                      for p in g["params"]]
        return super().step(closure)


def probe_grads(params, start, basis, target, fields=DEFAULT_TRAINABLE,
                **step_kw):
    """One ``make_train_step`` step over ``fields`` from ``start`` with
    ``step_kw`` (mesh, grad_chunks, edge_samples, topology) → ({field:
    gradient}, loss)."""
    init_fn, step_fn = make_train_step(params, GradProbe, **step_kw)
    trainable, opt = init_fn(start, fields)
    _, opt, loss = step_fn(trainable, opt, start, basis, target, 0)
    return dict(zip(fields, opt.grads)), float(loss)


def one_rank_path(device, scenes, card):
    """``render_frame_distributed`` on the one-rank default mesh (NCCL, world
    size 1) against ``render_frame`` on terrain, terrain190k and
    terrain_nee, bit for bit, each driven with the counts at 0 and held to
    one frame's launches; then ``make_train_step(mesh=make_mesh())``'s
    gradient against the same step without a mesh → text."""
    mesh = make_mesh()
    params = rt.RenderParams(**PARAMS)
    seg = BOUNCES + 1
    out = []
    for label, (scene, cam), p, want in (
            ("terrain", scenes["terrain"], params,
             launches(closest_hit=seg, hit_record=seg)),
            ("terrain190k", scenes["terrain190k"], params,
             launches(blocked_hit=seg, hit_record=seg)),
            ("terrain_nee", scenes["terrain_nee"], params.replace(**NEE),
             launches(closest_hit=seg, any_hit=BOUNCES, hit_record=seg))):
        basis = rt.camera_basis(cam)
        want_img = render_frame(scene, basis, p, 0)
        torch.cuda.synchronize()
        reset_counts()
        got = render_frame_distributed(scene, basis, p, 0, mesh)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"one-rank {label}: launches {counts}, "
                                 f"want {want}")
        if not torch.equal(got, want_img):
            raise AssertionError(f"one-rank {label}: the sharded frame is "
                                 f"not render_frame's")
        out.append(f"{label} bit-equal, launches "
                   f"{ {k: v for k, v in counts.items() if v} }")
    scene, cam = scenes["terrain"]
    _, (_, _, start, basis, target, _) = train_setup(scene, cam)
    ref, loss = probe_grads(params, start, basis, target)
    got, loss_m = probe_grads(params, start, basis, target, mesh=mesh)
    worst, leaf, _ = grad_gate("one-rank training step", got, ref)
    return (f"backend {dist.get_backend()}, world {dist.get_world_size()}: "
            + ", ".join(out) + f"; training step gradient vs no mesh: worst "
            f"{worst:.3g} of max |g| ({leaf}; gate {GRAD_PARITY}), loss "
            f"{loss_m:.6g} vs {loss:.6g} | {card}")


def rank_worker(rank, port, work, device):
    """One rank of the two-rank group (a subprocess of this script): gloo
    on ``device`` (NCCL refuses two ranks on one GPU; gloo takes the CUDA
    tensors), the 1080p terrain frame of the whole group into
    ``work/frame<rank>.npy`` and the gradient of the training step on the
    mesh (grad_chunks=CHUNKS, edge_samples=EDGE_SAMPLES, the topology) into
    ``work/grads<rank>.npz``; prints one JSON line of its loss and
    launches."""
    distributed.initialize(f"localhost:{port}", RANKS, rank, device=device,
                           backend="gloo")
    mesh = make_mesh(RANKS)
    scene, cam = terrain_scene(device)
    params = rt.RenderParams(**PARAMS)
    reset_counts()
    img = render_frame_distributed(scene, rt.camera_basis(cam), params, 0,
                                   mesh)
    torch.cuda.synchronize(device)
    counts = read_counts()
    np.save(os.path.join(work, f"frame{rank}.npy"), img.cpu().numpy())
    topo = topology.build_topology(scene)
    _, (_, _, start, basis, target, _) = train_setup(scene, cam)
    grads, loss = probe_grads(params, start, basis, target, mesh=mesh,
                              grad_chunks=CHUNKS, edge_samples=EDGE_SAMPLES,
                              topology=topo)
    np.savez(os.path.join(work, f"grads{rank}.npz"),
             **{k: v.cpu().numpy() for k, v in grads.items()})
    print(json.dumps({"rank": rank, "loss": loss, "launches": counts}),
          flush=True)
    dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_rank(rank, port, work):
    """This script as rank ``rank`` of the two-rank group, its output in
    ``work/rank<rank>.out`` and ``.err`` → the process."""
    with open(os.path.join(work, f"rank{rank}.out"), "w") as out, \
            open(os.path.join(work, f"rank{rank}.err"), "w") as err:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
             "--port", str(port), "--work", work], stdout=out, stderr=err)


def wait_ranks(procs, work):
    """Wait for every rank; the first that fails (or the time limit) ends
    the others → each rank's stdout. Raises with a failed rank's output."""
    deadline = time.perf_counter() + SUBPROCESS_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() > deadline:
                raise AssertionError("the two-rank group ran out of time")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def read(r, ext):
        with open(os.path.join(work, f"rank{r}.{ext}")) as f:
            return f.read()

    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} failed ({p.returncode}):\n"
                                 f"{read(r, 'out')[-3000:]}\n"
                                 f"{read(r, 'err')[-3000:]}")
    return [read(r, "out") for r in range(len(procs))]


def two_rank_path(device, terrain, card):
    """Two ranks of one group on the one card, run as two subprocesses of
    this script: the gathered 1080p terrain frame bit-equal to the
    single-process frame on both ranks, and the training step's gradient on
    the mesh within the gradient gate of the single-process step over the
    same slabs with the same edge samples and topology, and equal on both
    ranks → text."""
    work = os.path.join("build", "chip_smoke_ranks")
    os.makedirs(work, exist_ok=True)
    port = free_port()
    procs = [start_rank(r, port, work) for r in range(RANKS)]
    try:
        # the single-process references while the ranks start
        scene, cam = terrain
        params = rt.RenderParams(**PARAMS)
        with torch.no_grad():
            want = render_frame(scene, rt.camera_basis(cam), params, 0).cpu()
        topo = topology.build_topology(scene)
        _, (_, _, start, basis, target, _) = train_setup(scene, cam)
        step = dict(edge_samples=EDGE_SAMPLES, topology=topo)
        # the mesh walks RANKS x CHUNKS slabs; the same slabs in one
        # process hold the same share tiles (518,400 pixels is no whole
        # number of 512-lane tiles, so CHUNKS slabs would draw otherwise)
        ref, ref_loss = probe_grads(params, start, basis, target,
                                    grad_chunks=RANKS * CHUNKS, **step)
    finally:
        outs = wait_ranks(procs, work)
    lines = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    want_launches = launches(closest_hit=BOUNCES + 1,
                             hit_record=BOUNCES + 1)
    for x in lines:
        if x["launches"] != want_launches:
            raise AssertionError(f"two ranks: rank {x['rank']}'s frame "
                                 f"launched {x['launches']}, want "
                                 f"{want_launches}")
    grads = []
    for r in range(RANKS):
        frame = torch.from_numpy(np.load(os.path.join(work,
                                                      f"frame{r}.npy")))
        if not torch.equal(frame, want):
            raise AssertionError(
                f"two ranks: rank {r}'s frame differs from the single "
                f"process's by {float((frame - want).abs().max())}")
        with np.load(os.path.join(work, f"grads{r}.npz")) as z:
            grads.append({k: torch.from_numpy(z[k]).to(device) for k in z})
    worst, leaf, _ = grad_gate("two-rank training step", grads[0], ref)
    for k in grads[0]:
        if not torch.equal(grads[0][k], grads[1][k]):
            raise AssertionError(f"two ranks: {k}'s gradient differs "
                                 f"between the ranks")
    return (f"{RANKS} ranks (gloo, CUDA tensors, both on one {card}): "
            f"{W}x{H} terrain frame bit-equal to the single process's on "
            f"both ranks, {BOUNCES + 1} B1 launches on each rank's shard; "
            f"training step (grad_chunks={CHUNKS}, edge_samples="
            f"{EDGE_SAMPLES}, topology) gradient vs the single process's "
            f"over the same {RANKS * CHUNKS} slabs (grad_chunks="
            f"{RANKS * CHUNKS}): worst {worst:.3g} of max |g| ({leaf}; gate "
            f"{GRAD_PARITY}), equal on both ranks; loss "
            f"{lines[0]['loss']:.6g} vs {ref_loss:.6g} | {card}")


def run_cli(*argvs):
    """``python -m ray_tracer_tpu_torch argv`` for each argv in turn → the
    last one's stdout; raises where one fails."""
    out = None
    for argv in argvs:
        p = subprocess.run([sys.executable, "-m", "ray_tracer_tpu_torch"]
                           + argv, capture_output=True, text=True,
                           timeout=SUBPROCESS_TIMEOUT)
        if p.returncode != 0:
            raise AssertionError(f"command line {argv[:3]} failed "
                                 f"({p.returncode}):\n{p.stdout[-3000:]}\n"
                                 f"{p.stderr[-3000:]}")
        out = p.stdout
    return out


def cli_image(argv):
    """The image a ``render`` command line makes, computed here through the
    command line's own parser and scene set-up."""
    args = cli.make_parser().parse_args(["render"] + argv)
    scene, cam, params = cli._build(args)
    with torch.no_grad():
        return render_progressive(scene, rt.camera_basis(
            cam.replace(aspect=params.aspect)), params, FRAMES)


def cli_path(paths, card):
    """The command line in subprocesses, all started together (the resume
    after its checkpoint): renders of room and of phase 11's terrain190k
    OBJ (B4) and torus GLB (B1-tex), each PNG decoding to the image this
    process makes from the same flags; 4 frames with --checkpoint, 4 more
    with --resume, equal to the uninterrupted 8; a depth AOV; benchmark,
    invert and info → text."""
    os.makedirs(CLI_DIR, exist_ok=True)
    out = {k: os.path.join(CLI_DIR, k) for k in (
        "room.png", "terrain190k.png", "torus.png", "part.npy",
        "resumed.npy", "depth.png", "ck.npz")}
    full = ["--width", str(W), "--height", str(H), "--bounces", str(BOUNCES),
            "--skybox", "--coherent"]
    renders = {
        "room.png": ["--scene", "room"] + full,
        "terrain190k.png": ["--model", paths["terrain190k.obj"]] + full,
        "torus.png": ["--model", paths["torus.glb"]] + full,
    }
    half = str(FRAMES // 2)
    jobs = {k: (["render", "--frames", str(FRAMES)] + a + ["-o", out[k]],)
            for k, a in renders.items()}
    jobs["checkpoint, resume"] = (
        ["render", "--frames", half, "--checkpoint", out["ck.npz"], "-o",
         out["part.npy"]] + renders["room.png"],
        ["render", "--frames", half, "--resume", out["ck.npz"], "-o",
         out["resumed.npy"]] + renders["room.png"])
    jobs["depth"] = (["render", "--aov", "depth", "-o", out["depth.png"]]
                     + full,)
    jobs["benchmark"] = (["benchmark", "--scene", "room", "--frames",
                          str(FRAMES)] + full,)
    jobs["invert"] = (["invert", "--scene", "metal", "--steps", "20",
                       "--edge-samples", "64"] + full,)
    jobs["info"] = (["info"],)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(run_cli, *a) for k, a in jobs.items()}
        wanted = {k: cli_image(a) for k, a in renders.items()}
        texts = {k: f.result() for k, f in futures.items()}
    for k, img in wanted.items():
        with open(out[k], "rb") as f:
            png = decode_png(f.read())
        if not np.array_equal(png, to_uint8(img)):
            raise AssertionError(f"command line {k} is not the image of "
                                 f"its flags")
    room = wanted["room.png"].cpu().numpy()[::-1]   # as write_npy flips
    if not np.array_equal(np.load(out["resumed.npy"]), room):
        raise AssertionError("command line: --resume after --checkpoint is "
                             "not the uninterrupted render")
    with open(out["depth.png"], "rb") as f:
        if decode_png(f.read()).shape != (H, W, 3):
            raise AssertionError("command line depth AOV has the wrong shape")
    bench = json.loads(texts["benchmark"].strip().splitlines()[-1])
    inv = json.loads(texts["invert"].strip().splitlines()[-1])
    info = json.loads(texts["info"])
    name = torch.cuda.get_device_name(0)
    if name not in info["devices"] or not info["default_device"].startswith(
            "cuda"):
        raise AssertionError(f"command line info: {info}")
    if "recovered" not in inv or not math.isfinite(inv["final_loss"]):
        raise AssertionError(f"command line invert: {inv}")
    return (f"room, terrain190k.obj, torus.glb {W}x{H} {FRAMES} frames: PNGs "
            f"equal to the images of their flags; --checkpoint {half} + "
            f"--resume {half} equal to the uninterrupted {FRAMES}; depth AOV "
            f"PNG {W}x{H}; benchmark's result line at {bench['resolution']} "
            f"on {bench['device']}; invert "
            f"20 steps recovered={inv['recovered']} (max albedo error "
            f"{inv['max_albedo_error']:.4f}); info names {name} | {card}")


def viewer_path(device, card):
    """The viewer's core (no figure) on the card at the main path's size:
    VIEWER_FRAMES frames between VIEWER_KEYS (moves, scene switches 0-3,
    bounce and rays-per-pixel keys) and a resize, the packings of each
    frame counted (one each: the planes live one frame), one sRGB encode
    launch a frame and each frame's bytes equal to the numpy encode of its
    accumulation; the figure on Agg where matplotlib is → (text, the
    encode launches)."""
    scene, cam = rt.builtin_scene("metal", aspect=W / H, device=device)
    core = viewer.ViewerCore(scene, cam, rt.RenderParams(**PARAMS),
                             scene_id=3)
    packs = []

    def frame():
        before = ch.scene_planes.packs, srgb_encode.launches
        out = core.frame()
        packs.append(ch.scene_planes.packs - before[0])
        encodes = srgb_encode.launches - before[1]
        if encodes != 1:
            raise AssertionError(f"viewer frame: {encodes} sRGB encode "
                                 f"launches, want 1")
        if not np.array_equal(out[0], to_uint8(core.renderer.image.cpu())):
            raise AssertionError(f"viewer frame {len(packs)} "
                                 f"({out[0].shape}): bytes off the numpy "
                                 f"encode of its accumulation")
        return out

    for key in VIEWER_KEYS:
        core.key(key)
        frame()
    core.resize(*VIEWER_RESIZE)
    while len(packs) < VIEWER_FRAMES:
        rgb, _ = frame()
    frames = len(packs)
    if rgb.shape != VIEWER_RESIZE[::-1] + (3,):
        raise AssertionError(f"viewer frame {rgb.shape} after the resize")
    if set(packs) != {1}:
        raise AssertionError(f"viewer frames packed {packs} times")
    try:
        import matplotlib
        matplotlib.use("Agg", force=True)
        fig = viewer.Viewer(scene, cam, rt.RenderParams(**PARAMS),
                            scene_id=3)
        fig._on_key(types.SimpleNamespace(key="B"))
        fig.run(max_frames=2)
        figure = (f"the figure on Agg: 2 frames, bounces widget "
                  f"{fig._widgets['bounces'].val} after B")
    except ImportError:
        figure = "matplotlib is not installed here: the figure not run"
    return (f"{frames} frames ({W}x{H}, then {VIEWER_RESIZE[0]}x"
            f"{VIEWER_RESIZE[1]}) after keys {''.join(VIEWER_KEYS)}: "
            f"packings per frame {packs}; one sRGB encode a frame, each "
            f"equal to the numpy encode; {figure} | {card}"), frames


def pose_grads(scene, cam, params, origin, target):
    """(loss, gradients) of a frame from ``camera_basis_tensor`` with
    respect to the origin, the focus distance and the spheres' centres
    (joint camera and scene calibration: the pose's gradient reaches the
    rays through the winner rows of the closest-hit kernel, the centres'
    through their backward, the scatter-add)."""
    leaves = {
        "origin": torch.tensor(origin, dtype=torch.float32,
                               device=scene.device, requires_grad=True),
        "focus_dist": torch.tensor(cam.focus_dist, device=scene.device,
                                   requires_grad=True),
        "sphere_center": scene.sphere_center.detach().clone()
        .requires_grad_(True)}
    basis = rt.camera_basis_tensor(leaves["origin"], cam.look_at, cam.vup,
                                   cam.fov, cam.aspect, leaves["focus_dist"])
    img = render_frame(dataclasses.replace(
        scene, sphere_center=leaves["sphere_center"]), basis, params, 1)
    loss = torch.mean((img - target) ** 2)
    g = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, g))


def recover_pose(scene, cam, params, steps=POSE_STEPS, offset=POSE_OFFSET):
    """The reference test's camera calibration: Adam on the origin under
    optax's cosine_decay_schedule(0.08, steps, alpha=0.02), each step
    against the target re-rendered at its own frame index → (start error,
    final error)."""
    true = torch.tensor(cam.origin, dtype=torch.float32, device=scene.device)
    origin = (true + torch.tensor(offset, device=scene.device)
              ).requires_grad_(True)
    start_err = float(torch.linalg.vector_norm(origin.detach() - true))
    opt = torch.optim.Adam([origin], lr=0.08, betas=(0.9, 0.999), eps=1e-8)

    def render_at(o, frame):
        basis = rt.camera_basis_tensor(o, cam.look_at, cam.vup, cam.fov,
                                       cam.aspect, cam.focus_dist)
        return render_frame(scene, basis, params, frame)

    for i in range(steps):
        with torch.no_grad():
            target = render_at(true, i)
        loss = torch.mean((render_at(origin, i) - target) ** 2)
        (g,) = torch.autograd.grad(loss, [origin])
        cos = 0.5 * (1 + math.cos(math.pi * min(i, steps) / steps))
        opt.param_groups[0]["lr"] = 0.08 * ((1 - 0.02) * cos + 0.02)
        origin.grad = g
        opt.step()
    err = float(torch.linalg.vector_norm(origin.detach() - true))
    return start_err, err


def pose_path(device, card):
    """The gradient of a 1080p metal frame with respect to the pose (origin,
    focus distance) and the spheres' centres through the closest-hit kernel
    and the scatter-add against the plain path on the same tensors; then the reference test's pose recovery
    (metal, POSE_STEPS steps at POSE_SIZE², bounces 1, the sky) on the
    card, held to its bar → text."""
    scene, cam = rt.builtin_scene("metal", aspect=W / H, device=device)
    params = rt.RenderParams(**PARAMS)
    start = np.asarray(cam.origin, np.float32) + np.asarray(POSE_OFFSET,
                                                            np.float32)
    with torch.no_grad():
        target = render_frame(scene, rt.camera_basis(cam), params, 1)
    reset_counts()
    loss_k, g_k = pose_grads(scene, cam, params.replace(backend="cuda"),
                             start, target)
    counts = read_counts()
    want = launches(closest_hit=BOUNCES + 1, scatter_rows=BOUNCES + 1,
                    hit_record=BOUNCES + 1, hit_record_vjp=BOUNCES + 1)
    if counts != want:
        raise AssertionError(f"pose gradient: launches {counts}, want {want}")
    loss_p, g_p = pose_grads(scene, cam, params.replace(backend="torch"),
                             start, target)
    worst, leaf, scales = grad_gate("pose gradient", g_k, g_p)
    small, small_cam = rt.builtin_scene("metal", aspect=1.0, device=device)
    rparams = rt.RenderParams(width=POSE_SIZE, height=POSE_SIZE, bounces=1,
                              skybox=True)
    start_err, err = recover_pose(small, small_cam, rparams)
    if not err < POSE_BAR * start_err:
        raise AssertionError(f"pose recovery: error {err} from {start_err} "
                             f"(bar {POSE_BAR} x the start)")
    return (f"gradient of a {W}x{H} metal frame (b{BOUNCES}) at the origin "
            f"+ {POSE_OFFSET} with respect to the origin, the focus distance "
            f"and the spheres' centres: kernels vs plain worst {worst:.3g} of "
            f"max |g| "
            f"({leaf}; max |g| {scales}), loss {loss_k:.6g} vs {loss_p:.6g}, "
            f"launches {want['closest_hit']} B1 + {want['scatter_rows']} B2; "
            f"recovery ({POSE_STEPS} steps at {POSE_SIZE}x{POSE_SIZE} b1): "
            f"error {start_err:.4f} -> {err:.4f} ({err / start_err:.3f} of "
            f"the start, bar {POSE_BAR}) | {card}")


def metrics_path(terrain, card):
    """A StageTimer stage around a 1080p terrain render reads no less than
    the render's CUDA-event time → text."""
    scene, cam = terrain
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**PARAMS)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    st = StageTimer()
    with st.stage("render"), torch.no_grad():
        start.record()
        render_progressive(scene, basis, params, FRAMES)
        stop.record()
    torch.cuda.synchronize()
    event_ms, stage_ms = start.elapsed_time(stop), st.totals["render"] * 1e3
    if stage_ms < event_ms:
        raise AssertionError(f"StageTimer read {stage_ms} ms for a render "
                             f"of {event_ms} ms on the card")
    return (f"a StageTimer stage reads no less than the CUDA events round "
            f"the same {FRAMES}-frame {W}x{H} render | {card}")


def phase12_parallel_and_shell(device, scenes, paths, card):
    """Multi-device rendering and training, the command line, the viewer,
    the camera pose and the metrics (module docstring) → the viewer's sRGB
    encode launches."""
    print("phase 12 one rank: " + one_rank_path(device, scenes, card),
          flush=True)
    torch.cuda.empty_cache()
    print("phase 12 two ranks: " + two_rank_path(device, scenes["terrain"],
                                                 card), flush=True)
    torch.cuda.empty_cache()
    print("phase 12 command line: " + cli_path(paths, card), flush=True)
    text, encodes = viewer_path(device, card)
    print("phase 12 viewer: " + text, flush=True)
    print("phase 12 camera pose: " + pose_path(device, card), flush=True)
    print("phase 12 metrics: " + metrics_path(scenes["terrain"], card),
          flush=True)
    dist.destroy_process_group()
    return encodes


# ---------------------------------------------------------------------------
# Phase 13: the rigid recovery loop (tools/invert_teapot.py) and the
# repairs of the renderer's safe points and of the plane cache's lifetime.
# ---------------------------------------------------------------------------

# the reference CPU test's run (tests/test_invert.py:41-68) and its bars
CUBE_RUN = dict(size=64, steps=100, start_dir=(1.0, -0.6, 0.4),
                start_albedo=(0.35, 0.6, 0.55))
CUBE_BARS = dict(offset=0.02, albedo=0.05, loss_ratio=0.05)
# the recorded run's settings (artifacts/invert_teapot.json): 192², rpp 2,
# 300 steps from the tool's default start, and the reference's recovered
# bars; its three TPU runs' errors, printed beside the port's
RIGID_RUN = dict(size=192, steps=300,
                 start_dir=tuple(map(float, invert_teapot.START_DIR)),
                 start_albedo=tuple(map(float, invert_teapot.START_ALBEDO)))
RIGID_BARS = dict(offset=0.02, albedo=0.05)
RIGID_REFERENCE = "offset error 0.0004-0.001, albedo error 0.003-0.0047"


def rigid_cube(device):
    """The reference test's cube (tests/test_invert.py:20-38: 12
    triangles with flat normals, padded to 128, no floor) with the true
    albedo, and its camera → (scene, basis, extent)."""
    b = rt.SceneBuilder()
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    faces = [([0, 1, 3, 2], (-1, 0, 0)), ([4, 6, 7, 5], (1, 0, 0)),
             ([0, 4, 5, 1], (0, -1, 0)), ([2, 3, 7, 6], (0, 1, 0)),
             ([0, 2, 6, 4], (0, 0, -1)), ([1, 5, 7, 3], (0, 0, 1))]
    for q, n in faces:
        for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            b.add_mesh(v[list(tri)], np.tile(np.float32(n), (3, 1)),
                       [0, 1, 2], albedo=tuple(invert_teapot.TRUE_ALBEDO),
                       smoothness=0.0)
    lo, hi = b.bounds()
    center, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = rt.Camera(origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
                    look_at=tuple(center), aspect=1.0, focus_dist=1.0)
    return b.build(pad=128, device=device), rt.camera_basis(cam), ext


def rigid_run(label, scene, basis, ext, cfg):
    """``run_recovery`` at ``cfg`` from 0.12·ext·start_dir, its launches
    and packings counted over the run: before the loop one coverage AOV,
    then per step rpp x (bounces + 1) closest-hit launches for each of the
    target, the forward and the six differences, one for the forward's
    coverage AOV, and rpp x (bounces + 1) of the scatter-add (the albedo's
    backward); one packing before the loop and 8 a step (the truth for
    the target, the moved scene for the forward and its AOV, and the six
    moved scenes of the differences) → (text, offset error, albedo error,
    losses)."""
    params = invert_teapot.recovery_params(cfg["size"])
    steps, seg = cfg["steps"], params.rays_per_pixel * (params.bounces + 1)
    key = "closest_hit_tex" if scene.num_textures else "closest_hit"
    n, tex = 1 + steps * (8 * seg + 1), scene.num_textures
    want = launches(**{key: n}, scatter_rows=steps * seg,
                    hit_record=0 if tex else n,
                    hit_record_vjp=0 if tex else steps * seg)
    start = (np.float32(0.12 * ext)
             * np.array(cfg["start_dir"], np.float32)).astype(np.float32)
    reset_counts()
    packs = ch.scene_planes.packs
    off, alb, losses = invert_teapot.run_recovery(
        scene, ext, params, steps, start,
        np.array(cfg["start_albedo"], np.float32), basis, log=False)
    torch.cuda.synchronize()
    counts = read_counts()
    packed = ch.scene_planes.packs - packs
    if counts != want:
        raise AssertionError(f"{label} rigid recovery launches {counts} != "
                             f"{want}")
    if packed != 1 + 8 * steps:
        raise AssertionError(f"{label} rigid recovery packed {packed} times, "
                             f"want 1 + 8 a step")
    if not (np.isfinite(off).all() and np.isfinite(alb).all()
            and np.isfinite(losses).all()):
        raise AssertionError(f"{label} rigid recovery is not finite")
    off_err = float(np.linalg.norm(off - invert_teapot.TRUE_OFFSET)) / ext
    alb_err = float(np.abs(alb - invert_teapot.TRUE_ALBEDO).max())
    curve = [round(float(x), 6) for x in losses[::max(1, steps // 10)]]
    text = (f"{label} {scene.num_tris} tris ({scene.num_textures} textures "
            f"in its stack) {cfg['size']}x{cfg['size']} rpp "
            f"{params.rays_per_pixel} b{params.bounces}, {steps} steps from "
            f"0.12 x ext x {cfg['start_dir']} and albedo "
            f"{cfg['start_albedo']}: offset error {off_err:.5f} of the "
            f"extent, albedo error {alb_err:.4f} ({alb.round(4).tolist()}), "
            f"loss {losses[0]:.6g} -> {losses[-1]:.6g} (every "
            f"{max(1, steps // 10)}th: {curve}); "
            f"{packed} packings (1 + 8 a step), launches {counts} "
            f"({(counts[key] - 1) // steps} {key} and "
            f"{counts['scatter_rows'] // steps} scatter-add a step)")
    return text, off_err, alb_err, losses


def safe_point_repair(scene, cam):
    """C.2 on the card: ``render_progressive(chunk=2, resilient=True)`` and
    ``render_adaptive(resilient=True)`` bit-equal to the default calls at
    phase 3's settings → text."""
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**PARAMS)
    want = render_progressive(scene, basis, params, FRAMES)
    got = render_progressive(scene, basis, params, FRAMES, chunk=2,
                             resilient=True)
    if not torch.equal(got, want):
        raise AssertionError("render_progressive(chunk=2, resilient=True) "
                             "differs from the default call")
    a_want, n_want = renderer.render_adaptive(scene, basis, params, FRAMES,
                                              0.0, chunk=4)
    a_got, n_got = renderer.render_adaptive(scene, basis, params, FRAMES,
                                            0.0, chunk=4, resilient=True)
    if not (torch.equal(a_got, a_want) and n_got == n_want == FRAMES):
        raise AssertionError("render_adaptive(resilient=True) differs from "
                             "the default call")
    return (f"terrain {W}x{H} {FRAMES} frames: render_progressive(chunk=2, "
            f"resilient=True) bit-equal to the default call; "
            f"render_adaptive(target 0, chunk=4, resilient=True) bit-equal, "
            f"{n_got} frames")


def stale_plane_repair(scene, cam):
    """C.1 on the card: a write to terrain's tri_v0 through ``.data``
    between two kernel renders is seen: the second frame differs from the
    first and equals a frame of a fresh copy of the written scene; the
    write is undone after → text."""
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(**PARAMS)
    saved = scene.tri_v0.clone()
    first = render_frame(scene, basis, params, 0)
    try:
        scene.tri_v0.data[:, 1] += 0.25
        second = render_frame(scene, basis, params, 0)
        fresh = render_frame(dataclasses.replace(
            scene, tri_v0=scene.tri_v0.clone()), basis, params, 0)
    finally:
        scene.tri_v0.data.copy_(saved)
    moved = frac_off(second, first)
    if torch.equal(second, first) or not torch.equal(second, fresh):
        raise AssertionError("a .data write to tri_v0 between two renders "
                             "was not seen by the kernels")
    return (f"a .data write raising every tri_v0 by 0.25 between two "
            f"{W}x{H} kernel frames of terrain is seen: {moved:.3f} of the "
            f"pixels moved past {PARITY_TOL}, and the frame equals a fresh "
            f"copy's")


def phase13_rigid_recovery(device, terrain, paths, card):
    """The rigid recovery loop and the renderer's repairs (module
    docstring)."""
    cube, basis, ext = rigid_cube(device)
    text, off_err, alb_err, losses = rigid_run("cube", cube, basis, ext,
                                               CUBE_RUN)
    if not (off_err < CUBE_BARS["offset"] and alb_err < CUBE_BARS["albedo"]
            and losses[-1] < CUBE_BARS["loss_ratio"] * losses[0]):
        raise AssertionError(f"the cube misses the reference test's bars "
                             f"{CUBE_BARS}: {text}")
    print(f"phase 13 rigid recovery (the reference CPU test's configuration, "
          f"bars {CUBE_BARS}): {text} | {card}", flush=True)
    torus, basis, ext = invert_teapot.recovery_setup(paths["torus.obj"],
                                                     device)
    text, off_err, alb_err, _ = rigid_run("torus", torus, basis, ext,
                                          RIGID_RUN)
    recovered = (off_err < RIGID_BARS["offset"]
                 and alb_err < RIGID_BARS["albedo"])
    if not recovered:
        raise AssertionError(f"the torus is not recovered ({RIGID_BARS}): "
                             f"{text}")
    print(f"phase 13 rigid recovery at full width (the recorded run's "
          f"settings on the loaded torus; the reference's recovered bars "
          f"{RIGID_BARS}; its three TPU runs of the teapot reached "
          f"{RIGID_REFERENCE}): {text}; recovered {recovered} | {card}",
          flush=True)
    del torus
    print(f"phase 13 safe points (C.2): {safe_point_repair(*terrain)} | "
          f"{card}", flush=True)
    print(f"phase 13 plane lifetime (C.1): {stale_plane_repair(*terrain)} | "
          f"{card}", flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # phase 12 runs this script as one rank of its two-rank group
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_worker(args.rank, args.port, args.work, torch.device("cuda", 0))
        return
    t_start = time.perf_counter()
    card = phase0_device()
    device = torch.device("cuda", 0)
    secs = {}

    def run(phase, fn, *fn_args):
        """fn(*fn_args), its seconds (to the card's end) kept under phase."""
        t0 = time.perf_counter()
        out = fn(*fn_args)
        torch.cuda.synchronize()
        secs[phase] = round(time.perf_counter() - t0, 1)
        return out

    regs = run("1", phase1_build)
    terrain = terrain_scene(device)
    terrain_nee = terrain_scene(device, with_lights=True)
    terrain_tex = terrain_scene(device, textured=True)
    terrain_nee_tex = terrain_scene(device, with_lights=True, textured=True)
    large = terrain_scene(device, n=LARGE_N)
    large_nee = terrain_scene(device, n=LARGE_N, with_lights=True)
    large_tex = terrain_scene(device, n=LARGE_N, textured=True)
    huge = terrain_scene(device, n=HUGE_N)
    # the kernel phases keep one cache of planes across their calls, as
    # the calls of one render share it: "warm" times a render's launch
    with ch.plane_scope():
        timing = {"closest_hit": run("2", phase2_kernel_vs_plain, device,
                                     terrain)}
        timing["scatter_rows"], timing["scatter_rows_rows"] = run(
            "2b", phase2b_scatter_vs_plain, device, terrain, terrain_tex)
        timing["any_hit"] = run("2c", phase2c_anyhit_vs_plain, device,
                                terrain, terrain_nee)
        timing["blocked_hit"] = run("2d", phase2d_blocked_vs_plain, device,
                                    terrain, large, large_nee, huge)
        del huge
        torch.cuda.empty_cache()
        timing.update(run("2e", phase2e_textured_vs_plain, device, terrain,
                          terrain_tex, large, large_tex, regs,
                          timing["closest_hit"], timing["blocked_hit"]))
        timing["hit_record"], timing["hit_record_vjp"] = run(
            "2f", phase2f_recompute_vs_plain, device, terrain)
    timing["srgb_encode"] = run("2g", phase2g_srgb_vs_numpy, device)
    torch.cuda.empty_cache()
    counts = {}
    main_counts = run("3", phase3_main_path, device, terrain, card)
    counts["closest_hit"] = main_counts["closest_hit"]
    counts["hit_record"] = main_counts["hit_record"]
    run("4", phase4_parity, device, terrain)
    run("4b", phase4b_nee_parity, device, terrain_nee)
    train_counts = run("5", phase5_training, device, terrain, card)
    counts["scatter_rows"] = train_counts["scatter_rows"]
    counts["hit_record_vjp"] = train_counts["hit_record_vjp"]
    torch.cuda.empty_cache()
    run("6", phase6_grad_parity, device, terrain)
    run("6b", phase6b_nee_grad_parity, device, terrain_nee)
    torch.cuda.empty_cache()
    counts["any_hit"] = run("7", phase7_nee_path, device, terrain_nee, card)
    torch.cuda.empty_cache()
    counts["blocked_hit"] = run("8", phase8_large_scene, device, large,
                                large_nee, card)
    del large_nee
    torch.cuda.empty_cache()
    counts.update(run("9", phase9_textured, device, terrain_tex,
                      terrain_nee_tex, large_tex, card))
    del large_tex, terrain_nee_tex
    torch.cuda.empty_cache()
    run("10", phase10_image_extras, device, terrain, terrain_nee,
        terrain_tex, large, card)
    del terrain_tex
    torch.cuda.empty_cache()
    paths = run("11", phase11_recovery, device, terrain, card)
    torch.cuda.empty_cache()
    counts["srgb_encode"] = run(
        "12", phase12_parallel_and_shell, device,
        {"terrain": terrain, "terrain190k": large,
         "terrain_nee": terrain_nee}, paths, card)
    del large, terrain_nee
    torch.cuda.empty_cache()
    run("13", phase13_rigid_recovery, device, terrain, paths, card)
    print(f"seconds per phase: {secs}; whole run "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("max_abs_err", "mismatches", "ms", "plain_ms", "plain_rays",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        **({"variant": "textured=True"} if name in TEXTURED else {}),
        launches=counts[name], **{k: timing[name][k] for k in keys})
        for name, (source, replaces) in KERNELS.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
