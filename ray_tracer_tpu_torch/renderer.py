"""Wavefront path tracer: bounce-synchronous trace loop + progressive frames.

Port of ``ray_tracer_tpu.renderer``. All rays advance one bounce per step
of a Python loop over ``bounces + 1`` segments: one closest-hit query,
then masked elementwise shading. A ray that misses adds the sky once, on
the segment it dies, and stays dead.
With ``nee`` a hit also samples a light and casts one shadow ray
(``occluded``, the any-hit kernel on the card), weighted against BSDF
sampling by the balance heuristic (``mis``) or suppressing the next
segment's BSDF-found emission; ``rr_start`` adds Russian roulette. On
the kernels' backend ``compaction`` sorts each segment's rays first.
Besides frames: primary-ray AOVs (``render_aov``) and variance-guided
adaptive sampling (``render_adaptive``).

Radiance recurrence per segment:
    incoming   += emission * strength * throughput    (on hit)
    throughput *= albedo                               (on hit; dielectric
                                                        forces white)
    incoming   += env(d) * throughput                  (on miss, skybox on)

Progressive accumulation:
    frame >= 1:  image = image * (1 - w) + frame_img * w,  w = 1/(frame + 1)
    else:        image = frame_img

Everything runs on the scene's device; the camera basis is moved there.
Spans (``utils/metrics.span``): ``render.frame`` a frame, ``render.bounce``
a segment, and inside it ``render.intersect`` and ``render.scatter``; the
segment's self time is its shading.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import materials, sampling
from .camera import Camera, CameraBasis, camera_basis, camera_rays
from .envlight import environment_light
from .lights import _unit, build_light_table, glossy_mix_pdf, sample_lights
from .ops.closest_hit import plane_scope
from .ops.intersect import cross, intersect, occluded, resolve_backend
from .scene import Scene
from .utils.bounds import clip, maximum, minimum
from .utils.config import RenderParams
from .utils.metrics import span


def resolved_backend(params: RenderParams, scene: Scene) -> str:
    return resolve_backend(params.backend, scene.device)


def compaction_mode(params: RenderParams, backend: str):
    """The wavefront compaction ``trace`` applies: "morton", "octant" or
    None. As in the reference it runs on the kernels' backend only
    ("cuda", the reference's "pallas"); the "torch" backend ignores the
    knob, as the reference's jnp backend does. True means "morton"."""
    mode = "morton" if params.compaction is True else params.compaction
    return mode if mode and backend == "cuda" else None


# ---------------------------------------------------------------------------
# Wavefront compaction: sort keys. Each segment reorders its rays so the
# kernels' warps get coherent rays and dead lanes collect at the end.
# ---------------------------------------------------------------------------

@torch.no_grad()
def _scene_aabb(scene: Scene):
    """(lo, hi) (3,) over the valid spheres and triangles."""
    inf = float("inf")
    sv = (scene.sphere_valid > 0.5)[:, None]
    tv = (scene.tri_valid > 0.5)[:, None]
    r = scene.sphere_radius[:, None]
    verts = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    lo = torch.cat([torch.where(sv, scene.sphere_center - r, inf)]
                   + [torch.where(tv, v, inf) for v in verts]).amin(0)
    hi = torch.cat([torch.where(sv, scene.sphere_center + r, -inf)]
                   + [torch.where(tv, v, -inf) for v in verts]).amax(0)
    return lo, hi


def _spread8(x):
    """Interleave the low 8 bits of x with two zero bits."""
    x = (x | (x << 8)) & 0x00F00F
    x = (x | (x << 4)) & 0x0C30C3
    return (x | (x << 2)) & 0x249249


def _octant(d):
    """Direction octant in [0, 8): bit k set where d[:, k] > 0."""
    return ((d[:, 0] > 0).long() | ((d[:, 1] > 0).long() << 1)
            | ((d[:, 2] > 0).long() << 2))


def _octant_order(d, alive):
    """Permutation grouping live rays into their 8 direction octants, dead
    rays last, each bucket in its lanes' order: the stable argsort of the
    bucket (as uint8, the narrowest key a radix sort takes), the
    permutation of the reference's counting sort."""
    return torch.argsort(torch.where(alive, _octant(d), 8).to(torch.uint8),
                         stable=True)


def _ray_sort_key(lo, hi, o, d, alive):
    """Sort key (int64 holding the reference's uint32): live rays by the
    24-bit Morton cell of the origin in the scene's box, then direction
    octant; dead rays 0xFFFFFFFF, after every live one."""
    ext = maximum(hi - lo, 1e-12)
    q = clip((o - lo) / ext * 255.0, 0.0, 255.0).to(torch.int64)
    morton = ((_spread8(q[:, 0]) << 2) | (_spread8(q[:, 1]) << 1)
              | _spread8(q[:, 2]))
    return torch.where(alive, (morton << 3) | _octant(d), 0xFFFFFFFF)


def _morton_order(lo, hi, o, d, alive):
    """The stable argsort of ``_ray_sort_key``, the reference's "morton"
    permutation, sorted on int32 keys: live keys fit in 27 bits, so the
    dead lanes' key clipped to 2^31 - 1 still sorts after every live one,
    and the radix sort reads half the bits."""
    key = _ray_sort_key(lo, hi, o, d, alive).clamp(max=2 ** 31 - 1)
    return torch.argsort(key.to(torch.int32), stable=True)


def _mis_bsdf_weight(table, h, o, d, emission_ok, prev_pdf):
    """Balance-heuristic weight p_bsdf / (p_bsdf + p_nee) of emission that
    BSDF sampling found at this segment's hits. p_nee is the solid-angle
    pdf the light sampler would have had for this hit point, from the same
    table row ``sample_lights`` draws from. Lanes whose previous segment
    made no NEE attempt (``emission_ok``), and hits NEE cannot reach (not a
    table light, back-facing, zero power: p_nee = 0) get weight 1."""
    slot = table.slot[h.prim_id.long()]
    row = torch.where((slot >= 0)[:, None],
                      table.packed[slot.clamp(min=0)], 0.0)   # (R, 20)
    p_light, area_l, kind_l = row[:, 0], row[:, 1], row[:, 6]
    d_unit = _unit(d)
    # the emitter's geometric normal, as sample_lights builds it
    n_tri_l = _unit(cross(row[:, 14:17] - row[:, 11:14],
                          row[:, 17:20] - row[:, 11:14]))
    n_sph_l = (h.point - row[:, 7:10]) / maximum(row[:, 10], 1e-12)[:, None]
    ln = torch.where((kind_l > 0.5)[:, None], n_tri_l, n_sph_l)
    cos_l = (-d_unit * ln).sum(-1)
    wi_h = h.point - o
    d2h = (wi_h * wi_h).sum(-1)
    reachable = (cos_l > 1e-6) & (p_light > 0.0)
    p_nee_hit = torch.where(
        reachable, p_light * d2h / maximum(area_l * cos_l, 1e-20), 0.0)
    return torch.where(emission_ok, 1.0,
                       prev_pdf / maximum(prev_pdf + p_nee_hit, 1e-20))


def _next_event(scene, h, d, new_dir, albedo, throughput, attempted, ls,
                params: RenderParams, backend: str):
    """Direct light of one NEE sample per lane → (radiance to add (R, 3),
    BSDF pdf of the scatter direction (R,), or None without ``mis``).

    The light sample is weighted by the effective BRDF albedo · p_lobe at
    its direction (``glossy_mix_pdf``: exact for every smoothness < 1, no
    shading-normal cosine gate) and, with ``mis``, by p_nee / (p_nee +
    p_bsdf). Lanes with p_lobe = 0 contribute nothing whatever the
    occlusion, so they stay out of the shadow query."""
    wi_unit = ls["wi"] / maximum(ls["dist"], 1e-12)[:, None]
    refl = materials.reflect(_unit(d), h.normal)
    pdf_l = glossy_mix_pdf(wi_unit, refl, h.normal,
                           clip(h.smoothness, 0.0, 1.0),
                           params.cosine_sampling)
    nee_lane = attempted & ls["ok"] & (pdf_l > 0.0)
    blocked = occluded(scene, h.point, ls["wi"], t_min=params.t_min,
                       backend=backend, alive=nee_lane)
    direct = (albedo * pdf_l[:, None] * ls["radiance"]
              * ls["inv_pdf_w"][:, None])
    pdf_scatter = None
    if params.mis:
        # inv_pdf_w = 1 / p_nee, so w_l = 1 / (1 + p_bsdf · inv_pdf_w)
        w_l = 1.0 / (1.0 + pdf_l * ls["inv_pdf_w"])
        direct = direct * w_l[:, None]
        pdf_scatter = glossy_mix_pdf(
            _unit(new_dir), refl, h.normal,
            clip(h.smoothness, 0.0, 1.0 - 1e-6), params.cosine_sampling)
    return torch.where((nee_lane & ~blocked)[:, None], direct * throughput,
                       0.0), pdf_scatter


def trace(scene: Scene, o, d, state, params: RenderParams):
    """Trace a wavefront of rays to completion.

    Args:
      scene: Scene.
      o, d: (R, 3) ray origins / (unnormalized) directions.
      state: (R,) RNG state.
      params: RenderParams.

    Returns: (state, radiance (R, 3)).

    RNG stream, as the reference draws it: with ``nee`` every lane draws a
    light sample on every segment, the last one included; with
    ``rr_start > 0`` every lane draws the roulette uniform on every
    segment. The last segment makes no NEE attempt (its direct term would
    stand in for a segment the depth budget never traces), so it casts no
    shadow rays: the any-hit query runs once per segment but the last.

    With compaction (``compaction_mode``) each segment first permutes every
    per-lane tensor, the RNG state and the lanes' original slots included,
    by the sort order of its rays; radiance and state go back to their
    slots at the end. Each lane's result is the same in any order, but the
    coherent-scatter tiles share draws across the permuted lanes. With
    ``remat`` each segment runs under ``torch.utils.checkpoint``: the
    backward recomputes it from its inputs (the RNG is carried in as a
    tensor, so the recompute draws the same samples).
    """
    backend = resolved_backend(params, scene)
    compaction = compaction_mode(params, backend)
    share = _share_tile(params)
    table = build_light_table(scene) if params.nee else None
    aabb = _scene_aabb(scene) if compaction == "morton" else None

    @span("render.bounce")
    def bounce(seg, o, d, throughput, incoming, alive, emission_ok,
               prev_pdf, state, slot):
        if compaction:
            with torch.no_grad():
                if compaction == "morton":
                    order = _morton_order(*aabb, o, d, alive)
                else:
                    order = _octant_order(d, alive)
            (o, d, throughput, incoming, alive, emission_ok, prev_pdf,
             state, slot) = (
                None if x is None else x.index_select(0, order)
                for x in (o, d, throughput, incoming, alive, emission_ok,
                          prev_pdf, state, slot))
        with span("render.intersect"):
            h = intersect(scene, o, d, t_min=params.t_min, backend=backend,
                          alive=alive)
        active_hit = (alive & h.hit)[:, None]
        active_miss = (alive & ~h.hit)[:, None]

        # scatter every lane (branchless); only active-hit lanes keep it
        with span("render.scatter"):
            state, new_dir, is_dielectric = materials.scatter(
                state, d, h.normal, h.smoothness,
                cosine_sampling=params.cosine_sampling, share_tile=share)
        albedo = torch.where(is_dielectric[:, None], 1.0, h.albedo)

        emitted = h.emission * h.emission_strength[:, None]
        if params.nee and params.mis:
            w_b = _mis_bsdf_weight(table, h, o, d, emission_ok, prev_pdf)
            incoming = incoming + torch.where(
                active_hit, emitted * throughput * w_b[:, None], 0.0)
        else:
            count = active_hit
            if params.nee:
                # suppress only emitters the table can sample: light from
                # emitters beyond MAX_LIGHTS still arrives by BSDF sampling
                in_table = table.slot[h.prim_id.long()] >= 0
                count = active_hit & (emission_ok | ~in_table)[:, None]
            incoming = incoming + torch.where(count, emitted * throughput,
                                              0.0)

        if params.nee:
            state, ls = sample_lights(table, scene, state, h.point)
            if seg < params.bounces:
                # lanes whose direct light NEE now owns; an occluded or
                # back-facing sample is a valid zero, and still suppresses
                attempted = (active_hit[:, 0] & ~is_dielectric
                             & (h.smoothness < params.nee_smoothness_cutoff)
                             & table.has_lights)
                direct, pdf_scatter = _next_event(
                    scene, h, d, new_dir, albedo, throughput, attempted, ls,
                    params, backend)
                incoming = incoming + direct
                if params.mis:
                    prev_pdf = torch.where(attempted, pdf_scatter, 0.0)
                emission_ok = ~attempted
        throughput = torch.where(active_hit, throughput * albedo, throughput)
        if params.skybox:
            incoming = incoming + torch.where(
                active_miss, environment_light(d) * throughput, 0.0)

        o = torch.where(active_hit, h.point, o)
        d = torch.where(active_hit, new_dir, d)
        alive = active_hit[:, 0]
        if params.rr_start:
            # Russian roulette: survive with p = max-channel throughput in
            # [0.05, 1]; survivors divide by p, so the estimate is unbiased
            state, u_rr = sampling.uniform(state)
            if seg >= params.rr_start:
                p_surv = clip(throughput.amax(-1), 0.05, 1.0)
                kill = u_rr >= p_surv
                throughput = throughput * torch.where(
                    kill, 1.0, 1.0 / p_surv)[:, None]
                alive = alive & ~kill
        return (o, d, throughput, incoming, alive, emission_ok, prev_pdf,
                state, slot)

    alive = torch.ones(o.shape[:1], dtype=torch.bool, device=o.device)
    carry = (o, d, torch.ones_like(o), torch.zeros_like(o), alive,
             # NEE double-count guard and the BSDF pdf MIS weighs with
             torch.ones_like(alive) if params.nee else None,
             torch.zeros_like(o[:, 0]) if params.nee else None,
             state,
             # each lane's original slot, where compaction permutes lanes
             torch.arange(o.shape[0], device=o.device) if compaction
             else None)
    checkpointed = params.remat and torch.is_grad_enabled()
    for seg in range(params.bounces + 1):
        if checkpointed:
            carry = checkpoint(bounce, seg, *carry, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = bounce(seg, *carry)
    incoming, state, slot = carry[3], carry[7], carry[8]
    if compaction:
        # radiance and RNG state back to the lanes' original slots
        incoming = torch.zeros_like(incoming).index_copy(0, slot, incoming)
        state = torch.zeros_like(state).index_copy(0, slot, state)
    return state, incoming


@plane_scope()
def render_pixels(scene: Scene, basis: CameraBasis, params: RenderParams,
                  frame_index: int, pixel_ids):
    """Render flat pixel ids (y * W + x, y=0 bottom row) → (N, 3).

    With ``qmc`` the AA jitter of sample s of frame f is point
    n = |f| rpp + s (mod 2^32) of the R2 sequence, rotated per pixel by
    two stateless hashes of its id: low-discrepancy across frames, and
    the ray RNG stream does not advance for it."""
    W, H = params.width, params.height
    x = pixel_ids % W
    y = pixel_ids // W
    frame = abs(int(frame_index))
    state = sampling.seed_state(pixel_ids, frame)
    if params.qmc:
        rot_x = sampling.hash_u32(pixel_ids)
        rot_y = sampling.hash_u32(pixel_ids ^ 0x9E3779B9)
    total = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                        device=pixel_ids.device)
    for s in range(params.rays_per_pixel):
        jitter = None
        if params.qmc:
            jitter = sampling.r2_point(frame * params.rays_per_pixel + s,
                                       rot_x, rot_y)
        state, o, d = camera_rays(basis, x, y, (W, H), state, jitter=jitter)
        state, rad = trace(scene, o, d, state, params)
        if params.clamp > 0.0:
            rad = minimum(rad, params.clamp)  # firefly suppression
        total = total + rad
    return total / float(params.rays_per_pixel)


@functools.lru_cache(maxsize=16)
def _blocked_order(W: int, H: int, bw: int = 16, bh: int = 8):
    """(order, inverse): pixel ids permuted so each run of 128 consecutive
    rays is a compact 16×8 pixel block instead of a scanline strip (tight
    ray groups cull better in the closest-hit kernel and share coherent
    scatter draws over compact regions). Host numpy, cached."""
    ys, xs = np.mgrid[0:H, 0:W]
    key = ((ys // bh) * (-(-W // bw)) + (xs // bw)) * (bw * bh) \
        + (ys % bh) * bw + (xs % bw)
    order = np.argsort(key.reshape(-1), kind="stable")
    inverse = np.argsort(order, kind="stable")
    return order, inverse


@functools.lru_cache(maxsize=16)
def _blocked_ids(W: int, H: int, device: torch.device):
    """_blocked_order as int64 tensors on ``device``, cached."""
    order, inverse = _blocked_order(W, H)
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(inverse).to(device))


def _share_tile(params: RenderParams) -> int:
    """Lanes of a coherent-scatter share tile; 0 with coherent scatter
    off."""
    if not params.coherent_scatter:
        return 0
    return params.coherent_tile or materials.DEFAULT_SHARE_TILE


def frame_lanes(scene: Scene, params: RenderParams):
    """How ``render_frame`` lays out a frame's lanes → (pixel ids in the
    order it traces them, the inverse permutation or None where that is
    raster order, the share tile its ``trace`` calls draw with: 0 where
    they share no draws).

    The order is the blocked one whenever the kernel runs or coherent
    scatter is on (the same rule as the reference, so both packages put
    the same pixels in the same share tiles). A call shares draws only
    where its lanes, the frame's or a chunk's with ``chunk_pixels``, are
    whole tiles (``materials.scatter``)."""
    W, H = params.width, params.height
    n = W * H
    if resolved_backend(params, scene) == "cuda" or params.coherent_scatter:
        pixel_ids, inverse = _blocked_ids(W, H, scene.device)
    else:
        pixel_ids = torch.arange(n, dtype=torch.int64, device=scene.device)
        inverse = None
    chunk = params.chunk_pixels
    lanes = chunk if chunk and chunk < n else n
    tile = _share_tile(params)
    return pixel_ids, inverse, tile if tile and lanes % tile == 0 else 0


AOVS = ("depth", "normal", "albedo", "hit")


def _unblock(img_flat, inverse, W: int, H: int):
    """Blocked pixel order → raster order, (H*W, C): the reshape where the
    16x8 blocks tile the frame, the inverse gather otherwise."""
    if W % 16 == 0 and H % 8 == 0:
        C = img_flat.shape[-1]
        return (img_flat.reshape(H // 8, W // 16, 8, 16, C)
                .permute(0, 2, 1, 3, 4).reshape(H * W, C))
    return img_flat[inverse]


@plane_scope()
def render_frame(scene: Scene, basis: CameraBasis, params: RenderParams,
                 frame_index: int):
    """One full frame → (H, W, 3) linear radiance, row 0 = bottom.

    Pixels go out in ``frame_lanes``' order. With
    ``params.chunk_pixels > 0`` the frame is traced in sequential pixel
    chunks."""
    with span("render.frame", request=frame_index):
        basis = basis.to(scene.device)
        W, H = params.width, params.height
        n = H * W
        pixel_ids, inverse, _ = frame_lanes(scene, params)
        chunk = params.chunk_pixels
        if chunk and chunk < n:
            if n % chunk:
                # pad to whole chunks; surplus lanes repeat the last pixel
                pixel_ids = torch.cat([pixel_ids, pixel_ids.new_full(
                    (chunk - n % chunk,), n - 1)])
            img = torch.cat([
                render_pixels(scene, basis, params, frame_index, ids)
                for ids in pixel_ids.split(chunk)])[:n]
        else:
            img = render_pixels(scene, basis, params, frame_index, pixel_ids)
        if inverse is not None:
            img = _unblock(img, inverse, W, H)   # back to raster order
        return img.reshape(H, W, 3)


@plane_scope()
def render_aov(scene: Scene, basis: CameraBasis, params: RenderParams,
               aov: str = "depth"):
    """Primary-ray AOV (arbitrary output variable) image → (H, W, C).

    Rays go through pixel centres, without AA jitter and without the lens
    (AOVs are aliased and free of depth of field by convention), one
    closest-hit query each; the image is differentiable in the scene as a
    frame is (through the kernels' backward on the "cuda" backend).

    aov: "depth"  (H, W, 1) hit distance in units of |d| (0 on a miss),
         "normal" (H, W, 3) outward unit shading normal (0 on a miss),
         "albedo" (H, W, 3) surface albedo, textured where the scene is
                  (0 on a miss),
         "hit"    (H, W, 1) coverage, 1 on a hit, 0 on a miss.
    Pixels go out in the blocked 16x8 order when the kernels run, as in
    ``render_frame``."""
    if aov not in AOVS:
        raise ValueError(f"unknown aov {aov!r}")
    device = scene.device
    basis = basis.to(device)
    W, H = params.width, params.height
    n = H * W
    blocked = resolved_backend(params, scene) == "cuda"
    if blocked:
        pixel_ids, inverse = _blocked_ids(W, H, device)
    else:
        pixel_ids = torch.arange(n, dtype=torch.int64, device=device)
    px = ((pixel_ids % W).to(torch.float32) + 0.5) / float(W)
    py = ((pixel_ids // W).to(torch.float32) + 0.5) / float(H)
    d = (basis.lower_left + px[:, None] * basis.horizontal
         + py[:, None] * basis.vertical - basis.origin)
    o = basis.origin.expand_as(d).contiguous()
    h = intersect(scene, o, d, t_min=params.t_min, backend=params.backend,
                  alive=torch.ones(n, dtype=torch.bool, device=device))
    if aov == "depth":
        img = torch.where(h.hit, h.t, 0.0)[:, None]
    elif aov == "normal":
        img = torch.where(h.hit[:, None], h.normal, 0.0)
    elif aov == "albedo":
        img = torch.where(h.hit[:, None], h.albedo, 0.0)
    else:
        img = h.hit.to(torch.float32)[:, None]
    if blocked:
        img = _unblock(img, inverse, W, H)
    return img.reshape(H, W, -1)


def accumulate(prev, frame_img, frame_index: int):
    """Progressive blend: w = 1/(frame + 1) in float32."""
    if frame_index < 1:
        return frame_img
    one = torch.tensor(1.0, dtype=torch.float32, device=frame_img.device)
    w = one / (float(frame_index) + one)
    return prev * (1.0 - w) + frame_img * w


def _chunks(frames: int, chunk: int):
    """(first, count) of each run of at most ``chunk`` of ``frames``
    frames."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    return [(k, min(chunk, frames - k)) for k in range(0, frames, chunk)]


def _safe_point(*xs):
    """Each tensor copied to the host and back (``resilient``'s host-side
    safe point): the values are unchanged."""
    return tuple(x.cpu().to(x.device) for x in xs)


@plane_scope()
def render_progressive(scene: Scene, basis: CameraBasis, params: RenderParams,
                       frames: int, start_frame: int = 0, image0=None,
                       chunk: int = 8, resilient: bool = False):
    """``frames`` progressive frames from ``start_frame``, accumulated on the
    scene's device → (H, W, 3). Equal to ``render_frame`` + ``accumulate``
    per frame; ``image0`` continues an earlier accumulation.

    Frames go in chunks of ``chunk``, the safe points; the chunking never
    changes the values. ``resilient=True`` copies the accumulated image to
    the host after each chunk. The reference also retries a chunk whose
    launch died on a remote relay's transient error; a local card has no
    relay, so nothing is retried (ROADMAP.md D4)."""
    H, W = params.height, params.width
    img = (torch.zeros((H, W, 3), dtype=torch.float32, device=scene.device)
           if image0 is None else image0)
    for first, count in _chunks(frames, chunk):
        for k in range(first, first + count):
            f = start_frame + k
            img = accumulate(img, render_frame(scene, basis, params, f), f)
        if resilient:
            img, = _safe_point(img)
    return img


def _render_moments_chunk(scene: Scene, basis: CameraBasis,
                          params: RenderParams, frames: int,
                          start_frame: int, sums):
    """Per-pixel first and second moments (sum of img, sum of img * img)
    over ``frames`` frames from ``start_frame``, added to ``sums``."""
    s, s2 = sums
    for k in range(frames):
        img = render_frame(scene, basis, params, start_frame + k)
        s, s2 = s + img, s2 + img * img
    return s, s2


def _adaptive_stats(s, s2, n: int, target_rel_std: float):
    """(mean image, fraction of pixels not yet converged (0-d tensor)): a
    pixel has converged where the standard error of its mean, relative to
    its brightest channel (floored at 5e-2, so dark pixels converge by the
    absolute floor), is at most ``target_rel_std`` in every channel."""
    nf = float(n)
    mean = s / nf
    var = maximum(s2 / nf - mean * mean, 0.0)
    rel = torch.sqrt(var / max(nf - 1.0, 1.0)) / maximum(
        mean.amax(-1, keepdim=True), 5e-2)
    return mean, (rel.amax(-1) > target_rel_std).to(torch.float32).mean()


@torch.no_grad()
@plane_scope()
def render_adaptive(scene: Scene, basis: CameraBasis, params: RenderParams,
                    max_frames: int, target_rel_std: float = 0.02,
                    chunk: int = 16, converged_fraction: float = 0.99,
                    resilient: bool = False):
    """Variance-guided progressive rendering: frames in chunks of
    ``chunk``, per-pixel moments kept on the scene's device, stopping once
    at least ``converged_fraction`` of the pixels have a relative standard
    error of the mean below ``target_rel_std`` (``_adaptive_stats``), or
    at ``max_frames``. One scalar leaves the device per chunk. Not
    differentiable (the stopping rule reads a value), as in the
    reference. ``resilient=True`` copies both moment images to the host
    after each chunk, a safe point that does not change the values; as in
    ``render_progressive`` nothing is retried (ROADMAP.md D4).

    Returns (mean image (H, W, 3), frames rendered)."""
    H, W = params.height, params.width
    s = torch.zeros((H, W, 3), dtype=torch.float32, device=scene.device)
    s2 = torch.zeros_like(s)
    for first, k in _chunks(max_frames, chunk):
        s, s2 = _render_moments_chunk(scene, basis, params, k, first,
                                      (s, s2))
        if resilient:
            s, s2 = _safe_point(s, s2)
        n = first + k
        mean, frac_noisy = _adaptive_stats(s, s2, n, target_rel_std)
        if float(frac_noisy) <= 1.0 - converged_fraction:
            break
    return mean, n


class Renderer:
    """Progressive renderer with the reference's frame-counter semantics.

    >>> r = Renderer(scene, camera, RenderParams(width=256, height=256))
    >>> for _ in range(16): r.step()
    >>> img = r.image   # (H, W, 3) linear, accumulated
    """

    def __init__(self, scene: Scene, camera: Camera, params: RenderParams):
        self.scene = scene
        self.camera = camera.replace(aspect=params.aspect)
        self.params = params
        self.frames = -1
        self._image: Optional[torch.Tensor] = None
        self._basis = camera_basis(self.camera)

    def clear_accumulation(self):
        """frames = -1: the next step overwrites the image."""
        self.frames = -1

    def set_camera(self, camera: Camera):
        self.camera = camera.replace(aspect=self.params.aspect)
        self._basis = camera_basis(self.camera)
        self.clear_accumulation()

    def set_scene(self, scene: Scene):
        self.scene = scene
        self.clear_accumulation()

    def set_params(self, params: RenderParams):
        self.params = params
        # a resolution change also changes the aspect in the basis
        self.camera = self.camera.replace(aspect=params.aspect)
        self._basis = camera_basis(self.camera)
        self._image = None
        self.clear_accumulation()

    def step(self) -> torch.Tensor:
        """Render one frame and blend it in; returns the accumulated image."""
        if self.params.accumulate:
            self.frames += 1
        frame_img = render_frame(self.scene, self._basis, self.params,
                                 self.frames)
        if self._image is None or self.frames < 1:
            self._image = frame_img
        else:
            self._image = accumulate(self._image, frame_img, self.frames)
        return self._image

    @property
    def image(self) -> torch.Tensor:
        if self._image is None:
            self.step()
        return self._image


def render(scene: Scene, camera: Camera, params: RenderParams,
           frames: int = 1) -> torch.Tensor:
    """Render ``frames`` progressive frames → accumulated (H, W, 3)."""
    r = Renderer(scene, camera, params)
    for _ in range(max(1, frames)):
        img = r.step()
    return img
