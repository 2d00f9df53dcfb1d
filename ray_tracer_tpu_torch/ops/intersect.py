"""Closest-hit intersection: plain PyTorch oracle + backend dispatch.

Port of ``ray_tracer_tpu.ops.intersect``. Two stages:

  1. closest-hit search → per-ray ``(t, prim_id)``: the brute-force oracle
     ``nearest_hit`` ("torch" backend) or the hand-written CUDA kernel
     (``closest_hit.nearest_hit_attrs``, "cuda" backend), which also copies
     out the winner's merged-table row; when the scene's gradient is
     wanted that copy is ``_WinnerRows``, whose backward is the
     scatter-add kernel (``scatter_rows.scatter_rows_soa``);
  2. ``hit_attributes_from_rows``: recomputes t, point, normal and material
     of the winner from its merged-table row, in elementwise tensor code,
     differentiably in the rays and the rows.

Primitive ids: spheres are ``[0, SP)``, triangles ``[SP, SP + TP)``
(padded counts); ``t = +inf`` is a miss.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene import TENSOR_FIELDS, Scene

TRI_DET_EPS = 1e-6  # back-face / parallel cutoff
INF = float("inf")
# rays x primitives pairs per oracle chunk: bounds the oracle's (R, P, 3)
# temporaries to ~200 MB each, whatever the frame size
_PAIR_BUDGET = 1 << 24


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray hit record."""

    t: torch.Tensor                  # (R,)
    hit: torch.Tensor                # (R,) bool
    prim_id: torch.Tensor            # (R,) int winner id (0 on kernel misses)
    point: torch.Tensor              # (R, 3)
    normal: torch.Tensor             # (R, 3) unit, outward, never flipped
    albedo: torch.Tensor             # (R, 3)
    emission: torch.Tensor           # (R, 3)
    emission_strength: torch.Tensor  # (R,)
    smoothness: torch.Tensor         # (R,)


def resolve_backend(backend: str, device: torch.device) -> str:
    """"auto" → "cuda" for a scene on a CUDA device, else "torch". "cuda"
    on any other device raises: nothing falls back silently."""
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs the scene on a CUDA device; "
                         f"it is on {device}")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def cross(a, b):
    """Cross product over the last axis, (a1 b2 - a2 b1, ...), the same
    association as the reference's ``jnp.cross``."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


# ---------------------------------------------------------------------------
# Stage 1: closest-hit search (oracle backend)
# ---------------------------------------------------------------------------

def sphere_ts(scene: Scene, o, d, t_min):
    """All ray-sphere hit distances, +inf on miss → (R, S). Near root only,
    plus the t_min epsilon."""
    oc = o[:, None, :] - scene.sphere_center[None, :, :]        # (R, S, 3)
    a = (d * d).sum(-1)[:, None]                                 # (R, 1)
    b = 2.0 * (oc * d[:, None, :]).sum(-1)                       # (R, S)
    c = (oc * oc).sum(-1) - (scene.sphere_radius ** 2)[None, :]
    disc = b * b - 4.0 * a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    valid = (disc >= 0.0) & (t >= t_min) & (scene.sphere_valid[None, :] > 0.5)
    return torch.where(valid, t, INF)


def triangle_ts(scene: Scene, o, d, t_min):
    """All ray-triangle hit distances, +inf on miss → (R, T).
    Möller–Trumbore, det >= 1e-6 (back faces culled), u, v, w >= 0."""
    e1 = scene.tri_v1 - scene.tri_v0                             # (T, 3)
    e2 = scene.tri_v2 - scene.tri_v0
    n = cross(e1, e2)
    ao = o[:, None, :] - scene.tri_v0[None, :, :]                # (R, T, 3)
    dao = cross(ao, d[:, None, :].expand_as(ao))                 # (R, T, 3)
    det = -(d[:, None, :] * n[None, :, :]).sum(-1)               # (R, T)
    inv = 1.0 / det
    t = (ao * n[None, :, :]).sum(-1) * inv
    u = (e2[None, :, :] * dao).sum(-1) * inv
    v = -(e1[None, :, :] * dao).sum(-1) * inv
    w = 1.0 - u - v
    valid = ((det >= TRI_DET_EPS) & (t >= t_min)
             & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
             & (scene.tri_valid[None, :] > 0.5))
    return torch.where(valid, t, INF)


def nearest_hit(scene: Scene, o, d, t_min):
    """Oracle closest hit → (t (R,), prim_id (R,) int32). Brute force over
    every primitive; argmin, so the lowest id wins a tie. Runs in ray chunks
    of at most ``_PAIR_BUDGET`` pairs (rays are independent, so chunking
    does not change the result)."""
    o, d = o.detach(), d.detach()
    P = scene.padded_spheres + scene.padded_tris
    step = max(1, _PAIR_BUDGET // P)
    ts, ids = [], []
    for s in range(0, o.shape[0], step):
        oc, dc = o[s:s + step], d[s:s + step]
        all_t = torch.cat([sphere_ts(scene, oc, dc, t_min),
                           triangle_ts(scene, oc, dc, t_min)], dim=1)
        idx = torch.argmin(all_t, dim=1)
        ts.append(torch.gather(all_t, 1, idx[:, None])[:, 0])
        ids.append(idx.to(torch.int32))
    if not ts:
        return o.new_zeros((0,)), torch.zeros((0,), dtype=torch.int32,
                                              device=o.device)
    return torch.cat(ts), torch.cat(ids)


# ---------------------------------------------------------------------------
# Stage 2: winner recompute from merged-table rows
# ---------------------------------------------------------------------------

def merged_width(textured: bool) -> int:
    """Width of the merged primitive-attribute table."""
    return 40 if textured else 26


def attr_width(scene: Scene) -> int:
    return merged_width(scene.num_textures > 0)


def _pack_attrs(scene: Scene):
    """(S+T, 26|40) merged primitive-attribute table indexed by prim_id.

    Sphere columns: 0:3 center, 3 radius², 4:7 albedo, 7:10 emission,
    10 strength, 11 smoothness (rest zero).
    Triangle columns: 0:3 v0, 3:6 e1, 6:9 e2, 9:18 n0/n1/n2, 18:21 albedo,
    21:24 emission, 24 strength, 25 smoothness; textured scenes append
    26:32 uv0/uv1/uv2, 32:38 tan/bitan, 38 tex id, 39 ntex id.
    The closest-hit kernel's plane arrays hold the very same values, so its
    extracted rows equal ``_pack_attrs(scene)[id]`` exactly.
    """
    width = attr_width(scene)
    sp = torch.cat([
        scene.sphere_center, (scene.sphere_radius ** 2)[:, None],
        scene.sphere_albedo, scene.sphere_emission,
        scene.sphere_emission_strength[:, None],
        scene.sphere_smoothness[:, None],
    ], dim=1)
    sp = torch.nn.functional.pad(sp, (0, width - sp.shape[1]))
    cols = [
        scene.tri_v0, scene.tri_v1 - scene.tri_v0,
        scene.tri_v2 - scene.tri_v0,
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
        scene.tri_albedo, scene.tri_emission,
        scene.tri_emission_strength[:, None],
        scene.tri_smoothness[:, None],
    ]
    if scene.num_textures:
        cols += [scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
                 scene.tri_tan, scene.tri_bitan,
                 scene.tri_tex[:, None].to(torch.float32),
                 scene.tri_ntex[:, None].to(torch.float32)]
    tp = torch.cat(cols, dim=1)
    tp = torch.nn.functional.pad(tp, (0, width - tp.shape[1]))
    return torch.cat([sp, tp], dim=0)


def _norm3(x, y, z, eps=1e-24):
    """Safe normalize on (R,) components; the squared norm is summed as
    (x*x + y*y) + z*z, like the reference."""
    sq = (x * x + y * y) + z * z
    ok = sq > eps
    inv = torch.rsqrt(torch.where(ok, sq, 1.0))
    return (torch.where(ok, x * inv, x), torch.where(ok, y * inv, y),
            torch.where(ok, z * inv, z))


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def hit_attributes_from_rows(scene: Scene, rows, o, d, prim_id, miss, t_min):
    """Winner recompute from merged-table rows (26, R): the winners'
    ``_pack_attrs`` rows, columns first. Both the sphere and the triangle
    recompute run on every lane and ``prim_id`` selects; the double
    ``where`` guards keep every lane NaN-free. Miss lanes get t = 0 and
    are masked downstream through ``Hit.hit``."""
    if scene.num_textures:
        raise NotImplementedError("textures are not ported yet "
                                  "(texture.sample_bilinear)")
    S = scene.padded_spheres
    is_tri = prim_id >= S
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    # --- sphere recompute ---------------------------------------------------
    cx, cy, cz = rows[0], rows[1], rows[2]
    r2 = rows[3]                        # radius squared
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = (dx * dx + dy * dy) + dz * dz
    b = 2.0 * ((ocx * dx + ocy * dy) + ocz * dz)
    cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r2
    disc = b * b - 4.0 * a * cc
    disc_ok = disc > 0.0
    safe_disc = torch.where(disc_ok, disc, 1.0)
    t_sphere = (-b - torch.where(disc_ok, torch.sqrt(safe_disc), 0.0)) / (2.0 * a)
    psx = ox + dx * t_sphere
    psy = oy + dy * t_sphere
    psz = oz + dz * t_sphere
    nsx, nsy, nsz = _norm3(psx - cx, psy - cy, psz - cz)

    # --- triangle recompute -------------------------------------------------
    v0x, v0y, v0z = rows[0], rows[1], rows[2]
    e1x, e1y, e1z = rows[3], rows[4], rows[5]
    e2x, e2y, e2z = rows[6], rows[7], rows[8]
    ngx, ngy, ngz = _cross3(e1x, e1y, e1z, e2x, e2y, e2z)
    aox, aoy, aoz = ox - v0x, oy - v0y, oz - v0z
    dax, day, daz = _cross3(aox, aoy, aoz, dx, dy, dz)
    det = -((dx * ngx + dy * ngy) + dz * ngz)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    t_tri = ((aox * ngx + aoy * ngy) + aoz * ngz) * inv
    u = ((e2x * dax + e2y * day) + e2z * daz) * inv
    v = -((e1x * dax + e1y * day) + e1z * daz) * inv
    w = 1.0 - u - v
    nbx = rows[9] * w + rows[12] * u + rows[15] * v
    nby = rows[10] * w + rows[13] * u + rows[16] * v
    nbz = rows[11] * w + rows[14] * u + rows[17] * v
    ntx, nty, ntz = _norm3(nbx, nby, nbz)

    # --- select -------------------------------------------------------------
    t = torch.where(miss, 0.0, torch.where(is_tri, t_tri, t_sphere))
    normal = torch.stack([torch.where(is_tri, ntx, nsx),
                          torch.where(is_tri, nty, nsy),
                          torch.where(is_tri, ntz, nsz)], dim=-1)
    point = o + d * t[:, None]
    albedo = torch.stack([torch.where(is_tri, rows[18], rows[4]),
                          torch.where(is_tri, rows[19], rows[5]),
                          torch.where(is_tri, rows[20], rows[6])], dim=-1)
    emission = torch.stack([torch.where(is_tri, rows[21], rows[7]),
                            torch.where(is_tri, rows[22], rows[8]),
                            torch.where(is_tri, rows[23], rows[9])], dim=-1)
    emission_strength = torch.where(is_tri, rows[24], rows[10])
    smoothness = torch.where(is_tri, rows[25], rows[11])
    return Hit(t=t, hit=~miss, prim_id=prim_id.detach(), point=point,
               normal=normal, albedo=albedo, emission=emission,
               emission_strength=emission_strength, smoothness=smoothness)


def hit_attributes(scene: Scene, o, d, prim_id, miss, t_min):
    """Gather the winners' merged-table rows (one gather per ray) and
    recompute the hit from them."""
    hi = scene.padded_spheres + scene.padded_tris - 1
    rows = _pack_attrs(scene)[prim_id.long().clamp(0, hi)].T
    return hit_attributes_from_rows(scene, rows, o, d, prim_id, miss, t_min)


# ---------------------------------------------------------------------------
# Fused forward path: in-kernel winner-row extraction
# ---------------------------------------------------------------------------

def _nearest_rows(scene, o, d, t_min, alive):
    """The closest-hit kernel on detached rays → (rows, prim_id, miss)."""
    from .closest_hit import nearest_hit_attrs
    best_t, prim_id, rows = nearest_hit_attrs(scene, o.detach(), d.detach(),
                                              t_min, alive=alive)
    return rows, prim_id, torch.isinf(best_t)


class _WinnerRows(torch.autograd.Function):
    """The winner-row extraction as a differentiable op of the merged table
    (the reference's ``_winner_rows_c`` custom VJP).

    Forward: the closest-hit kernel (detached rays and scene) copies out
    each winner's row, which equals ``table[prim_id]`` on hit lanes and is
    zero on misses. Backward: the transpose of that gather, one scatter-add
    of the row cotangents into the table (``scatter_rows_soa``), with miss
    lanes zeroed and routed to the dropped id ``n_rows``. Autograd then
    carries the table's cotangent through ``_pack_attrs`` to the scene
    leaves. The rays get no gradient here: theirs flows through
    ``hit_attributes_from_rows``."""

    @staticmethod
    def forward(ctx, table, scene, o, d, t_min, alive):
        rows, prim_id, miss = _nearest_rows(scene, o, d, t_min, alive)
        ctx.mark_non_differentiable(prim_id, miss)
        ctx.save_for_backward(prim_id, miss)
        ctx.n_rows = table.shape[0]
        return rows, prim_id, miss

    @staticmethod
    def backward(ctx, g_rows, _g_id, _g_miss):
        from .scatter_rows import scatter_rows_soa
        prim_id, miss = ctx.saved_tensors
        g_soa = torch.where(miss[None], 0.0, g_rows).contiguous()
        ids = torch.where(miss, ctx.n_rows, prim_id)
        g_table = scatter_rows_soa(ids, g_soa, ctx.n_rows)
        return g_table, None, None, None, None, None


def _winner_rows(scene, o, d, t_min, alive):
    """Closest hit with the winners' merged-table rows copied out by the
    closest-hit kernel → (rows (26, R), prim_id, miss). The rows equal
    ``_pack_attrs(scene)[prim_id].T`` on hit lanes and are zero on misses.

    When autograd needs the scene's gradient, the extraction runs as
    ``_WinnerRows`` on ``_pack_attrs(scene)``, whose backward is the
    scatter-add kernel; otherwise the kernel is called directly, with no
    table and no graph."""
    if torch.is_grad_enabled() and any(
            getattr(scene, k).requires_grad for k in TENSOR_FIELDS):
        return _WinnerRows.apply(_pack_attrs(scene), scene, o, d, t_min,
                                 alive)
    return _nearest_rows(scene, o, d, t_min, alive)


def fused_intersect(scene, o, d, t_min, alive):
    """Closest hit with in-kernel row extraction, then the same recompute
    as the oracle path (``hit_attributes_from_rows``)."""
    rows, prim_id, miss = _winner_rows(scene, o, d, t_min, alive)
    return hit_attributes_from_rows(scene, rows, o, d, prim_id, miss, t_min)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def intersect(scene: Scene, o, d, t_min=1e-4, backend: str = "torch",
              alive=None) -> Hit:
    """Closest-hit query → Hit. ``backend``: "torch" | "cuda" | "auto".

    ``alive`` ((R,) bool, optional) marks live wavefront lanes: the kernel
    reports dead lanes as misses and skips their work; the oracle computes
    every lane (dead lanes are masked downstream either way).
    """
    backend = resolve_backend(backend, scene.device)
    if backend == "cuda":
        return fused_intersect(scene, o, d, t_min, alive)
    best_t, prim_id = nearest_hit(scene, o, d, t_min)
    return hit_attributes(scene, o, d, prim_id, torch.isinf(best_t), t_min)
