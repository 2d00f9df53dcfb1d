"""The plain path tracer that the benchmark holds the port to.

Plain PyTorch and NumPy, on whatever device its inputs are on, in float32
or, for the control, in bfloat16 (``dtype``). It imports nothing of the
port. Its arithmetic is a frozen copy of the port's plain path (the PCG
sampler, the thin-lens camera, the branchless materials, the sky,
Möller–Trumbore and the winner recompute), so that on the same inputs the
two agree to rounding. It works out again everything the port derives
from the scene: the triangle order (recursive median split), the padding
and so the primitive ids, the camera basis and the blocked pixel order.

Its closest-hit search is its own: every triangle of every 64-triangle
cluster whose box a ray enters, found through boxes of 16 clusters and of
single clusters (each box padded, so the culling never drops a hit), and
the lowest primitive id on a tie, as the port's oracle's ``argmin`` picks.

Covered: ``bounces``, ``rays_per_pixel``, ``skybox``, ``t_min``,
``coherent_scatter`` and ``coherent_tile``, ``cosine_sampling``, spheres
and untextured triangles. Anything else in the render settings (NEE,
textures, QMC, roulette, clamp, an aperture) raises: a configuration that
needs it needs another reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PAD = 128            # padding unit of the primitive arrays
CLUSTER = 64         # triangles per box of the search
SUPER = 16           # clusters per box of the first level
TRI_DET_EPS = 1e-6
SHARE_TILE = 512     # the coherent-scatter tile when coherent_tile is 0
IOR_GLASS = 1.5

MASK32 = 0xFFFFFFFF
_LCG_MUL = 747796405
_LCG_ADD = 2891336453
_MIX_MUL = 277803737
_FRAME_STRIDE = 71939
_U32_MAX_F = 4294967295.0
TWO_PI = float(np.float32(2.0 * np.pi))

SKY_HORIZON = (1.0, 1.0, 1.0)
SKY_ZENITH = (0.0788092, 0.36480793, 0.7264151)
GROUND_COLOR = (0.35, 0.3, 0.35)
SUN_INTENSITY = 0.1
SUN_FOCUS = 500.0
SUN_DIR = (0.1, 1.0, 0.1)

SUPPORTED = {"bounces", "rays_per_pixel", "skybox", "t_min",
             "coherent_scatter", "coherent_tile", "cosine_sampling",
             "backend", "accumulate"}


def check_settings(render: dict) -> None:
    """Raise where the render settings ask for something this reference
    does not trace."""
    extra = {k for k, v in render.items() if k not in SUPPORTED and v}
    if extra:
        raise NotImplementedError(
            f"the plain path tracer does not cover {sorted(extra)}")


# ---------------------------------------------------------------------------
# Scene: the harness's arrays, sorted and padded as the port builds them
# ---------------------------------------------------------------------------

def median_split_order(centroids: np.ndarray, leaf: int = CLUSTER):
    """Recursive widest-axis median split of the centroids; every run of
    ``leaf`` in the result is a tight cluster."""
    c = np.asarray(centroids, np.float64)
    n = c.shape[0]
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if idx.shape[0] <= leaf:
            out[pos:pos + idx.shape[0]] = idx
            pos += idx.shape[0]
            continue
        ext = c[idx].max(0) - c[idx].min(0)
        ax = int(np.argmax(ext))
        m = int(round((idx.shape[0] / 2) / leaf)) * leaf
        m = min(max(m, leaf), idx.shape[0] - 1)
        part = np.argpartition(c[idx, ax], m)
        stack.append(idx[part[m:]])
        stack.append(idx[part[:m]])
    return out


def _padded(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def build_scene(arrays: dict, device, dtype=torch.float32) -> dict:
    """The scene as this reference holds it: padded structure-of-arrays
    tensors in ``dtype``, triangles in median-split order (ids: spheres
    ``[0, SP)``, triangles ``[SP, SP + TP)``), and the culling boxes.

    ``arrays``: ``verts``, ``normals`` (N, 3), ``idx`` (3T,), the mesh's
    ``albedo`` (3,) and ``smoothness``, and ``spheres``, a list of
    (centre, radius, albedo, smoothness)."""
    verts = np.asarray(arrays["verts"], np.float32)
    normals = np.asarray(arrays["normals"], np.float32)
    tri = np.asarray(arrays["idx"], np.int64).reshape(-1, 3)
    v = [verts[tri[:, k]] for k in range(3)]
    n = [normals[tri[:, k]] for k in range(3)]
    order = median_split_order((v[0] + v[1] + v[2]) / 3.0)
    v = [x[order] for x in v]
    n = [x[order] for x in n]
    T = tri.shape[0]
    TP = max(PAD, -(-T // PAD) * PAD)
    spheres = arrays["spheres"]
    S = len(spheres)
    SP = max(PAD, -(-max(S, 1) // PAD) * PAD)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    sc = np.zeros((SP, 3), np.float32)
    sr, ss, sv = (np.zeros(SP, np.float32) for _ in range(3))
    sa = np.zeros((SP, 3), np.float32)
    for i, (c, r, a, sm) in enumerate(spheres):
        sc[i], sr[i], sa[i], ss[i], sv[i] = c, r, a, min(sm, 1.0), 1.0
    alb = np.tile(np.asarray(arrays["albedo"], np.float32), (T, 1))
    smooth = np.full(T, min(float(arrays["smoothness"]), 1.0), np.float32)
    scene = dict(
        sph_c=t(sc), sph_r=t(sr), sph_alb=t(sa), sph_sm=t(ss),
        sph_em=t(np.zeros((SP, 3), np.float32)),
        sph_es=t(np.zeros(SP, np.float32)),
        v0=t(_padded(v[0], TP)), v1=t(_padded(v[1], TP)),
        v2=t(_padded(v[2], TP)), n0=t(_padded(n[0], TP)),
        n1=t(_padded(n[1], TP)), n2=t(_padded(n[2], TP)),
        tri_alb=t(_padded(alb, TP)), tri_sm=t(_padded(smooth, TP)),
        tri_em=t(np.zeros((TP, 3), np.float32)),
        tri_es=t(np.zeros(TP, np.float32)),
        SP=SP, TP=TP, T=T, S=S, dtype=dtype,
        sph_ids=torch.arange(S, device=device))
    # culling boxes over the real triangles, padded so rounding never culls
    # a hit: float32 whatever the scene's dtype
    corners = np.stack(v, 1)                                  # (T, 3, 3)
    n_clu = -(-T // CLUSTER)
    lo = np.full((n_clu, 3), np.inf, np.float32)
    hi = np.full((n_clu, 3), -np.inf, np.float32)
    cid = np.arange(T) // CLUSTER
    np.minimum.at(lo, cid, corners.min(1))
    np.maximum.at(hi, cid, corners.max(1))
    pad = 1e-3 * float(np.max(hi.max(0) - lo.min(0))) + 1e-6
    lo, hi = lo - pad, hi + pad
    n_sup = -(-n_clu // SUPER)
    slo = np.full((n_sup, 3), np.inf, np.float32)
    shi = np.full((n_sup, 3), -np.inf, np.float32)
    np.minimum.at(slo, np.arange(n_clu) // SUPER, lo)
    np.maximum.at(shi, np.arange(n_clu) // SUPER, hi)
    f32 = dict(device=device, dtype=torch.float32)
    scene.update(clu_lo=torch.from_numpy(lo).to(**f32),
                 clu_hi=torch.from_numpy(hi).to(**f32),
                 sup_lo=torch.from_numpy(slo).to(**f32),
                 sup_hi=torch.from_numpy(shi).to(**f32))
    return scene


def with_leaves(scene: dict, leaves: dict) -> dict:
    """The scene with some tensors replaced (trainable leaves)."""
    out = dict(scene)
    out.update(leaves)
    return out


# ---------------------------------------------------------------------------
# Sampling (PCG words on int64 tensors holding uint32 values)
# ---------------------------------------------------------------------------

def seed_state(pixel_index, frame_index: int):
    frame = int(frame_index) & MASK32
    return (pixel_index.to(torch.int64) + frame * _FRAME_STRIDE) & MASK32


def next_u32(state):
    state = (state * _LCG_MUL + _LCG_ADD) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * _MIX_MUL) & MASK32
    return state, (word >> 22) ^ word


def uniform(state, dtype):
    state, bits = next_u32(state)
    return state, bits.to(dtype) / _U32_MAX_F


def normal(state, dtype):
    state, u1 = uniform(state, dtype)
    state, u2 = uniform(state, dtype)
    theta = TWO_PI * u1
    rho = torch.sqrt(-2.0 * torch.log(torch.clamp(u2, min=1e-10)))
    return state, rho * torch.cos(theta)


def unit_sphere(state, dtype):
    state, x = normal(state, dtype)
    state, y = normal(state, dtype)
    state, z = normal(state, dtype)
    v = torch.stack([x, y, z], dim=-1)
    n = torch.sqrt((x * x + y * y) + z * z)[:, None]
    return state, v / torch.clamp(n, min=1e-12)


def unit_disk(state, dtype):
    state, u1 = uniform(state, dtype)
    state, u2 = uniform(state, dtype)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return state, torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


# ---------------------------------------------------------------------------
# Elementwise helpers (torch.maximum against a 0-d bound, as the port)
# ---------------------------------------------------------------------------

def maximum(x, lo):
    return torch.maximum(x, torch.tensor(float(lo), dtype=x.dtype,
                                         device=x.device))


def minimum(x, hi):
    return torch.minimum(x, torch.tensor(float(hi), dtype=x.dtype,
                                         device=x.device))


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _unit(v):
    return v / maximum(torch.sqrt(_dot(v, v)), 1e-12)


def _norm3(x, y, z, eps=1e-24):
    sq = (x * x + y * y) + z * z
    ok = sq > eps
    inv = torch.rsqrt(torch.where(ok, sq, 1.0))
    return (torch.where(ok, x * inv, x), torch.where(ok, y * inv, y),
            torch.where(ok, z * inv, z))


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

def camera_basis(origin, look_at, fov, aspect, vup=(0.0, 1.0, 0.0),
                 focus_dist=1.0, aperture=0.0):
    """The ray-generation basis in float32 numpy: origin, lower-left
    corner, horizontal and vertical spans. An aperture raises."""
    if aperture:
        raise NotImplementedError("the plain path tracer has no lens")
    origin = np.asarray(origin, np.float32)
    look_at = np.asarray(look_at, np.float32)
    vup = np.asarray(vup, np.float32)

    def unit(v):
        return v / np.maximum(np.linalg.norm(v), 1e-12)

    height = 2.0 * math.tan(math.radians(fov) / 2.0)
    width = aspect * height
    w = unit(origin - look_at)
    u = unit(np.cross(vup, w))
    v = np.cross(w, u)
    horizontal = (focus_dist * width * u).astype(np.float32)
    vertical = (focus_dist * height * v).astype(np.float32)
    lower_left = (origin - horizontal / 2.0 - vertical / 2.0
                  - focus_dist * w).astype(np.float32)
    return dict(origin=origin, lower_left=lower_left, horizontal=horizontal,
                vertical=vertical)


def camera_rays(basis, pix_x, pix_y, W, H, state, dtype):
    """One primary ray per lane: two AA draws, then the lens's two draws
    (a pinhole: the lens sample moves nothing)."""
    dev = pix_x.device

    def b(k):
        return torch.from_numpy(basis[k]).to(dev, dtype)

    state, ax = uniform(state, dtype)
    state, ay = uniform(state, dtype)
    px = (pix_x.to(dtype) + ax) / float(W)
    py = (pix_y.to(dtype) + ay) / float(H)
    state, _ = unit_disk(state, dtype)
    origin = b("origin")
    o = origin.expand(pix_x.shape[0], 3)
    dirs = (b("lower_left") + px[:, None] * b("horizontal")
            + py[:, None] * b("vertical") - o)
    return state, o.contiguous(), dirs


# ---------------------------------------------------------------------------
# Sky
# ---------------------------------------------------------------------------

def _smoothstep(e0, e1, x):
    t = clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def environment_light(dirs):
    dt, dev = dirs.dtype, dirs.device
    horizon, zenith, ground = (torch.tensor(c, dtype=dt, device=dev)
                               for c in (SKY_HORIZON, SKY_ZENITH,
                                         GROUND_COLOR))
    y = dirs[:, 1]
    s = _smoothstep(0.0, 0.4, y)
    s_ok = s > 0.0
    sky_t = torch.where(s_ok, torch.pow(torch.where(s_ok, s, 1.0), 0.35),
                        0.0)[:, None]
    ground_to_sky = _smoothstep(-0.01, 0.0, y)[:, None]
    sky = horizon * (1.0 - sky_t) + zenith * sky_t
    sun_cos = ((dirs[:, 0] * SUN_DIR[0] + dirs[:, 1] * SUN_DIR[1])
               + dirs[:, 2] * SUN_DIR[2])
    sun = torch.pow(maximum(sun_cos, 0.0), SUN_FOCUS) * SUN_INTENSITY
    return (ground * (1.0 - ground_to_sky) + sky * ground_to_sky
            + sun[:, None] * (ground_to_sky >= 1.0).to(dt))


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

def _reflect(d, n):
    return d - 2.0 * _dot(d, n) * n


def _refract(unit_d, n, ratio):
    cos_theta = minimum(_dot(-unit_d, n), 1.0)
    r_perp = ratio * (unit_d + cos_theta * n)
    r_par = -torch.sqrt(maximum(torch.abs(1.0 - _dot(r_perp, r_perp)),
                                1e-12)) * n
    return r_perp + r_par


def _schlick(cosine, ratio):
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)


def scatter(state, d, normal_vec, smoothness, share_tile, cosine_sampling,
            dtype):
    """Scattered direction of every lane → (state, dir, is_dielectric).
    With ``share_tile`` each run of that many lanes shares one sphere
    draw for the diffuse lobe, drawn from its first lane's state."""
    unit_d = _unit(d)
    is_dielectric = smoothness < 0.0
    sharing = bool(share_tile) and state.shape[0] % share_tile == 0
    if sharing:
        _, sph_t = unit_sphere(state[::share_tile] ^ 0x9E3779B1, dtype)
        sph = sph_t.repeat_interleave(share_tile, dim=0)
        state, _ = next_u32(state)
    if cosine_sampling:
        if not sharing:
            state, sph = unit_sphere(state, dtype)
        v = normal_vec + sph
        n2 = _dot(v, v)
        diffuse_dir = torch.where(
            n2 > 1e-12, v / torch.sqrt(maximum(n2, 1e-12)), normal_vec)
    elif sharing:
        diffuse_dir = sph * torch.where(_dot(sph, normal_vec) >= 0.0,
                                        1.0, -1.0).to(dtype)
    else:
        state, sph = unit_sphere(state, dtype)
        diffuse_dir = sph * torch.where(_dot(sph, normal_vec) >= 0.0,
                                        1.0, -1.0).to(dtype)
    specular_dir = _reflect(unit_d, normal_vec)
    s = clip(smoothness, 0.0, 1.0)[:, None]
    glossy_dir = diffuse_dir * (1.0 - s) + specular_dir * s

    front_face = _dot(d, normal_vec)[:, 0] <= 0.0
    ratio = torch.where(front_face, 1.0 / IOR_GLASS,
                        IOR_GLASS).to(dtype)
    cos_theta = minimum(_dot(-unit_d, normal_vec)[:, 0], 1.0)
    sin_theta = torch.sqrt(maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    state, u = uniform(state, dtype)
    use_reflect = cannot_refract | (_schlick(cos_theta, ratio) > u)
    dielectric_dir = torch.where(use_reflect[:, None],
                                 _reflect(unit_d, normal_vec),
                                 _refract(unit_d, normal_vec,
                                          ratio[:, None]))
    new_dir = torch.where(is_dielectric[:, None], dielectric_dir, glossy_dir)
    return state, new_dir, is_dielectric


# ---------------------------------------------------------------------------
# Closest hit: culled brute force
# ---------------------------------------------------------------------------

def _enters(o, d_inv, lo, hi, t_min):
    """(rays, boxes) bool: the ray's segment [t_min, inf) meets the box.
    NaN-free: zero direction components were replaced by 1e-30."""
    t1 = (lo[None] - o[:, None]) * d_inv[:, None]
    t2 = (hi[None] - o[:, None]) * d_inv[:, None]
    tnear = torch.minimum(t1, t2).amax(-1)
    tfar = torch.maximum(t1, t2).amin(-1)
    return (tnear <= tfar) & (tfar >= t_min)


def _sphere_ts(S, o, d, t_min):
    ids = S["sph_ids"]
    c, r = S["sph_c"][ids], S["sph_r"][ids]
    oc = o[:, None, :] - c[None]
    a = (d * d).sum(-1)[:, None]
    b = 2.0 * (oc * d[:, None, :]).sum(-1)
    cc = (oc * oc).sum(-1) - (r ** 2)[None, :]
    disc = b * b - 4.0 * a * cc
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    return torch.where((disc >= 0.0) & (t >= t_min), t, math.inf)


def _tri_ts(o, d, v0, e1, e2, n, t_min):
    """Möller–Trumbore of each ray against its row of candidates, the
    port's association: o, d (P, 3), v0/e1/e2/n (P, K, 3) → t (P, K)."""
    ao = o[:, None, :] - v0
    dao = cross(ao, d[:, None, :].expand_as(ao))
    det = -(d[:, None, :] * n).sum(-1)
    inv = 1.0 / det
    t = (ao * n).sum(-1) * inv
    u = (e2 * dao).sum(-1) * inv
    v = -(e1 * dao).sum(-1) * inv
    w = 1.0 - u - v
    ok = ((det >= TRI_DET_EPS) & (t >= t_min) & (u >= 0.0) & (v >= 0.0)
          & (w >= 0.0))
    return torch.where(ok, t, math.inf)


@torch.no_grad()
def closest_hit(S, o, d, t_min, ray_chunk=65536, pair_chunk=262144):
    """(t (R,), id (R,) int64): the nearest primitive of each ray, +inf
    and id 0 on a miss, the lowest id on a tie."""
    o, d = o.detach(), d.detach()
    R, dev = o.shape[0], o.device
    inf = torch.tensor(math.inf, dtype=o.dtype, device=dev)
    best_t = inf.expand(R).clone()
    best_id = torch.zeros(R, dtype=torch.int64, device=dev)
    if S["S"]:
        for s in range(0, R, ray_chunk):
            ts = _sphere_ts(S, o[s:s + ray_chunk], d[s:s + ray_chunk], t_min)
            k = torch.argmin(ts, dim=1)
            best_t[s:s + ray_chunk] = ts.gather(1, k[:, None])[:, 0]
            best_id[s:s + ray_chunk] = S["sph_ids"][k]
    if not S["T"]:
        return best_t, best_id
    v0 = S["v0"].detach()
    e1, e2 = S["v1"].detach() - v0, S["v2"].detach() - v0
    nrm = cross(e1, e2)
    T, SP = S["T"], S["SP"]
    n_clu = S["clu_lo"].shape[0]
    tri_t = inf.expand(R).clone()
    tri_id = torch.full((R,), SP + S["TP"], dtype=torch.int64, device=dev)
    o32, d32 = o.float(), d.float()
    d_inv = 1.0 / torch.where(d32 == 0.0, 1e-30, d32)
    k_sup = torch.arange(SUPER, device=dev)
    k_clu = torch.arange(CLUSTER, device=dev)
    for s in range(0, R, ray_chunk):
        oc, ic = o32[s:s + ray_chunk], d_inv[s:s + ray_chunk]
        r1, s1 = _enters(oc, ic, S["sup_lo"], S["sup_hi"],
                         t_min).nonzero(as_tuple=True)
        clu = (s1[:, None] * SUPER + k_sup).reshape(-1)
        r2 = r1[:, None].expand(-1, SUPER).reshape(-1)
        real = clu < n_clu
        r2, clu = r2[real], clu[real]
        sel = _box_pairs(oc, ic, r2, clu, S, t_min)
        r2, clu = r2[sel], clu[sel]
        for p in range(0, r2.shape[0], pair_chunk):
            rr, cc = r2[p:p + pair_chunk], clu[p:p + pair_chunk]
            tid = cc[:, None] * CLUSTER + k_clu                    # (P, 64)
            valid = tid < T
            tid = tid.clamp(max=T - 1)
            ray = rr + s
            t = _tri_ts(o[ray], d[ray], v0[tid], e1[tid], e2[tid], nrm[tid],
                        t_min)
            t = torch.where(valid, t, inf)
            k = torch.argmin(t, dim=1)
            tp = t.gather(1, k[:, None])[:, 0]
            ip = tid.gather(1, k[:, None])[:, 0] + SP
            tri_t.scatter_reduce_(0, ray, tp, "amin")
            tie = tp == tri_t[ray]
            tri_id.scatter_reduce_(0, ray[tie], ip[tie], "amin")
    take = tri_t < best_t                 # a sphere wins a tie (lower id)
    return (torch.where(take, tri_t, best_t),
            torch.where(take, tri_id, best_id))


def _box_pairs(oc, ic, r, clu, S, t_min):
    """Which (ray, cluster) pairs enter the cluster's box."""
    lo, hi = S["clu_lo"][clu], S["clu_hi"][clu]
    o, di = oc[r], ic[r]
    t1 = (lo - o) * di
    t2 = (hi - o) * di
    tnear = torch.minimum(t1, t2).amax(-1)
    tfar = torch.maximum(t1, t2).amin(-1)
    return (tnear <= tfar) & (tfar >= t_min)


# ---------------------------------------------------------------------------
# Hit record: the winner recomputed, differentiably in rays and scene
# ---------------------------------------------------------------------------

def hit_record(S, o, d, prim_id, miss):
    """Point, normal and material of each winner, recomputed from its
    primitive as the port's winner recompute does (sphere and triangle on
    every lane, ``prim_id`` selects; zero attributes on a miss)."""
    SP = S["SP"]
    is_tri = prim_id >= SP
    sid = prim_id.clamp(max=SP - 1)
    tid = (prim_id - SP).clamp(min=0, max=S["TP"] - 1)
    on_sph, on_tri = ~miss & ~is_tri, ~miss & is_tri

    def g(name, idx):
        """The winners' values of one field; zero on lanes whose winner
        is not of this kind, so the branch not taken computes on zeros."""
        x = S[name].index_select(0, idx)
        on = on_tri if name[0] in "vnt" else on_sph
        return torch.where(on[:, None] if x.dim() == 2 else on, x, 0.0)

    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    c = g("sph_c", sid)
    cx, cy, cz = c.unbind(-1)
    r2 = torch.where(on_sph, S["sph_r"].index_select(0, sid) ** 2, 0.0)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = (dx * dx + dy * dy) + dz * dz
    b = 2.0 * ((ocx * dx + ocy * dy) + ocz * dz)
    cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r2
    disc = b * b - 4.0 * a * cc
    disc_ok = disc > 0.0
    t_sph = (-b - torch.where(disc_ok, torch.sqrt(
        torch.where(disc_ok, disc, 1.0)), 0.0)) / (2.0 * a)
    nsx, nsy, nsz = _norm3(ox + dx * t_sph - cx, oy + dy * t_sph - cy,
                           oz + dz * t_sph - cz)

    v0 = g("v0", tid)
    e1 = g("v1", tid) - v0
    e2 = g("v2", tid) - v0
    v0x, v0y, v0z = v0.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    ngx, ngy, ngz = (e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                     e1x * e2y - e1y * e2x)
    aox, aoy, aoz = ox - v0x, oy - v0y, oz - v0z
    dax, day, daz = (aoy * dz - aoz * dy, aoz * dx - aox * dz,
                     aox * dy - aoy * dx)
    det = -((dx * ngx + dy * ngy) + dz * ngz)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    t_tri = ((aox * ngx + aoy * ngy) + aoz * ngz) * inv
    u = ((e2x * dax + e2y * day) + e2z * daz) * inv
    v = -((e1x * dax + e1y * day) + e1z * daz) * inv
    w = 1.0 - u - v
    n0, n1, n2 = g("n0", tid), g("n1", tid), g("n2", tid)
    nb = [n0[:, k] * w + n1[:, k] * u + n2[:, k] * v for k in range(3)]
    ntx, nty, ntz = _norm3(*nb)

    t = torch.where(miss, 0.0, torch.where(is_tri, t_tri, t_sph))
    normal_vec = torch.stack([torch.where(is_tri, ntx, nsx),
                              torch.where(is_tri, nty, nsy),
                              torch.where(is_tri, ntz, nsz)], dim=-1)
    sel = is_tri[:, None]
    return dict(
        point=o + d * t[:, None], normal=normal_vec,
        albedo=torch.where(sel, g("tri_alb", tid), g("sph_alb", sid)),
        emission=torch.where(sel, g("tri_em", tid), g("sph_em", sid)),
        strength=torch.where(is_tri, g("tri_es", tid), g("sph_es", sid)),
        smoothness=torch.where(is_tri, g("tri_sm", tid), g("sph_sm", sid)))


# ---------------------------------------------------------------------------
# Trace, pixels, frames
# ---------------------------------------------------------------------------

def trace(S, o, d, state, render: dict):
    """Radiance of a wavefront → (state, (R, 3))."""
    dtype = S["dtype"]
    t_min = render.get("t_min", 1e-4)
    share = ((render.get("coherent_tile") or SHARE_TILE)
             if render.get("coherent_scatter") else 0)
    throughput = torch.ones_like(o)
    incoming = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for _ in range(render["bounces"] + 1):
        live = alive.nonzero()[:, 0]
        t_live, id_live = closest_hit(S, o[live], d[live], t_min)
        best_t = torch.full_like(o[:, 0], math.inf).index_copy(
            0, live, t_live.to(dtype))
        prim = torch.zeros_like(alive, dtype=torch.int64).index_copy(
            0, live, id_live)
        miss = torch.isinf(best_t)
        h = hit_record(S, o, d, prim, miss)
        active_hit = (alive & ~miss)[:, None]
        active_miss = (alive & miss)[:, None]
        state, new_dir, is_dielectric = scatter(
            state, d, h["normal"], h["smoothness"], share,
            render.get("cosine_sampling", False), dtype)
        albedo = torch.where(is_dielectric[:, None], 1.0, h["albedo"])
        emitted = h["emission"] * h["strength"][:, None]
        incoming = incoming + torch.where(active_hit, emitted * throughput,
                                          0.0)
        throughput = torch.where(active_hit, throughput * albedo, throughput)
        if render.get("skybox"):
            incoming = incoming + torch.where(
                active_miss, environment_light(d) * throughput, 0.0)
        o = torch.where(active_hit, h["point"], o)
        d = torch.where(active_hit, new_dir, d)
        alive = active_hit[:, 0]
    return state, incoming


def blocked_order(W: int, H: int, bw: int = 16, bh: int = 8) -> np.ndarray:
    """Pixel ids (y * W + x, y = 0 the bottom row) in the order the port
    traces them: 16×8 blocks of 128 consecutive lanes."""
    ys, xs = np.mgrid[0:H, 0:W]
    key = ((ys // bh) * (-(-W // bw)) + (xs // bw)) * (bw * bh) \
        + (ys % bh) * bw + (xs % bw)
    return np.argsort(key.reshape(-1), kind="stable")


def tile_pixels(W: int, H: int, tiles, tile: int = SHARE_TILE):
    """The pixel ids of whole share tiles (lanes ``[k tile, (k+1) tile)``
    of the blocked order), tile after tile."""
    order = blocked_order(W, H)
    return np.concatenate([order[k * tile:(k + 1) * tile] for k in tiles])


def render_lanes(S, basis, render: dict, W: int, H: int, pixel_ids,
                 frames):
    """Radiance of each frame at the given pixels → (len(frames), N, 3).
    The frames go out as one wavefront, frame after frame, so whole share
    tiles stay whole. Only the pinhole camera and rpp averaging of the
    port's ``render_pixels``."""
    check_settings(render)
    dtype = S["dtype"]
    dev = S["v0"].device
    ids = torch.as_tensor(np.asarray(pixel_ids), dtype=torch.int64,
                          device=dev)
    n = ids.shape[0]
    all_ids = ids.repeat(len(frames))
    x, y = all_ids % W, all_ids // W
    state = torch.cat([seed_state(ids, f) for f in frames])
    rpp = render.get("rays_per_pixel", 1)
    total = torch.zeros((all_ids.shape[0], 3), dtype=dtype, device=dev)
    for _ in range(rpp):
        state, o, d = camera_rays(basis, x, y, W, H, state, dtype)
        state, rad = trace(S, o, d, state, render)
        total = total + rad
    return (total / float(rpp)).reshape(len(frames), n, 3)


def accumulate(prev, frame_img, frame_index: int):
    """The progressive blend, w = 1 / (frame + 1)."""
    if frame_index < 1:
        return frame_img
    one = torch.tensor(1.0, dtype=frame_img.dtype, device=frame_img.device)
    w = one / (float(frame_index) + one)
    return prev * (1.0 - w) + frame_img * w


def accumulated(per_frame, frames, image0=None):
    """``accumulate`` over the frames in order, from ``image0`` (zeros
    where None)."""
    img = torch.zeros_like(per_frame[0]) if image0 is None else image0
    for k, f in enumerate(frames):
        img = accumulate(img, per_frame[k], f)
    return img
