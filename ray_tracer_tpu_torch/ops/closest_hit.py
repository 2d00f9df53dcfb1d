"""Closest-hit kernel (CUDA C++, ``csrc/closest_hit.cu``) with its packers,
its plain PyTorch version and its wrapper.

Port of the resident closest-hit kernel of
``ray_tracer_tpu/ops/pallas_intersect.py`` (``_make_kernel`` through
``nearest_hit_attrs_pallas`` / ``nearest_hit_pallas``). Same inputs and
outputs: rays (R, 3) + liveness → t (R,) f32 (+inf on miss), prim id (R,)
int32 (0 on miss) and, with ``want_attrs``, the winner's merged-table row
(26, R) f32, (40, R) on a textured scene (zero on miss), equal to
``_pack_attrs(scene)[id].T``.

  * ``nearest_hit_attrs`` — the wrapper: launches the kernel for CUDA
    tensors; the plain version runs only for tensors on the CPU. Anything
    the kernel does not take raises. ``nearest_hit_attrs.launches`` counts
    kernel launches.
  * ``nearest_hit_attrs_reference`` — the plain version: brute force over
    every sphere and triangle with the kernel's arithmetic and tie rule,
    no culling, in ray chunks.
  * ``scene_planes`` — the kernels' packed inputs of a scene, cached per
    device for one top-level call (``plane_scope``) while the scene's
    tensors are unchanged; ``scene_planes.packs`` counts the packings.

The plane arrays share the reference's layouts: spheres (SP, 16)
``[c(3) | r² | valid | albedo(3) | emission(3) | es | smooth | pad(3)]``,
triangles (TP, 32) ``[a(3) | e1(3) | e2(3) | n(3) | n0 n1 n2 (9) |
albedo(3) | emission(3) | es | smooth | pad(3)]``, on a textured scene
(TP, 48) with ``[uv0 uv1 uv2 (6) | tan(3) | bitan(3) | tex | ntex |
pad(2)]`` appended, cluster boxes (C, 8)
``[lo(3) | hi(3) | pad(2)]`` over runs of 64 triangles and super boxes
over runs of 8 clusters. The kernel reads the triangles' geometry from a
plane of its own, (TP, 12) ``[a | e1 | e2 | n]``: 48-byte rows, so that a
cluster is one contiguous 3,072-byte run for its asynchronous copies; the
32- or 48-column plane is where it copies the winner's attributes
from.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..scene import Scene
from ..utils import build
from ..utils.metrics import span
from .intersect import _pack_attrs, attr_width, cross, merged_width

CLUSTER = 64           # triangles per culling cluster (the kernel's kCluster)
SUPER = 8              # clusters per super box (the kernel's kSuper)
GEO_COLS = 12          # geometry plane columns: a, e1, e2, n
TRI_DET_EPS = 1e-6
# ray chunk of the plain version: keeps its (rays, primitives) temporaries
# near 256 MB each on a 16k-triangle scene
REFERENCE_CHUNK = 4096
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "rtt_closest_hit": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _P, _I,
                        _P, ctypes.c_float, _I, _I, _P, _P, _P, _P],
    "rtt_closest_hit_shared_bytes": [_I, _I],
    "rtt_closest_hit_blocks_per_sm": [_I, _I, _I, _I]}


# ---------------------------------------------------------------------------
# Packers (shared by the kernel and the plain version)
# ---------------------------------------------------------------------------

def _pack_tris(scene: Scene, textured: bool = False):
    """(TP, 32) triangle planes; with ``textured`` (TP, 48), columns 32:48
    ``[uv0 uv1 uv2 | tan | bitan | tex | ntex | pad(2)]`` with the ids as
    f32 (the reference's ``_pack_tris(..., textured=True)``). n = e1 × e2
    is the unnormalized geometric normal, computed with separately rounded
    products (no fused multiply-add), as every other float operation
    here."""
    a = scene.tri_v0
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    pad = torch.zeros_like(a)
    cols = [
        a, e1, e2, cross(e1, e2),
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
        scene.tri_albedo, scene.tri_emission,
        scene.tri_emission_strength[:, None],
        scene.tri_smoothness[:, None], pad,
    ]
    if textured:
        cols += [scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
                 scene.tri_tan, scene.tri_bitan,
                 scene.tri_tex[:, None].to(torch.float32),
                 scene.tri_ntex[:, None].to(torch.float32), pad[:, :2]]
    return torch.cat(cols, dim=1).contiguous()


def tri_cols(textured: bool) -> int:
    """Columns of the triangle planes."""
    return 48 if textured else 32


def _pack_spheres(scene: Scene):
    """(SP, 16) sphere planes."""
    pad = torch.zeros_like(scene.sphere_center)
    return torch.cat([
        scene.sphere_center,
        (scene.sphere_radius ** 2)[:, None],
        scene.sphere_valid[:, None],
        scene.sphere_albedo,
        scene.sphere_emission,
        scene.sphere_emission_strength[:, None],
        scene.sphere_smoothness[:, None],
        pad,
    ], dim=1).contiguous()


def _attr_copy_maps(textured: bool = False):
    """(merged-table column, plane column) copy maps for the winner-row
    extraction. The planes carry columns the merged table omits: the sphere
    ``valid`` flag (plane column 4) and the triangle geometric normal
    (plane columns 9:12); the textured columns 26:40 come from plane
    columns 32:46."""
    sph = list(zip(range(12), (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12)))
    tri = [(r, r) for r in range(9)] + [(r, r + 3) for r in range(9, 26)]
    if textured:
        tri += [(r, r + 6) for r in range(26, 38)] + [(38, 44), (39, 45)]
    return sph, tri


@functools.lru_cache(maxsize=None)
def _copy_map_tensor(device: torch.device, textured: bool = False
                     ) -> torch.Tensor:
    """(2, 26) int32, (2, 40) with ``textured``: plane column of each
    merged-table column, row 0 for spheres, row 1 for triangles, -1 where
    the table holds zero."""
    W = merged_width(textured)
    table = [[-1] * W, [-1] * W]
    for k, pairs in enumerate(_attr_copy_maps(textured)):
        for row, col in pairs:
            table[k][row] = col
    return torch.tensor(table, dtype=torch.int32, device=device)


def _cluster_aabbs(scene: Scene, csize: int = CLUSTER):
    """(C, 8) bounds of each run of ``csize`` triangles. Invalid (padding)
    triangles contribute ±inf, so an all-padding cluster's box passes every
    slab test: the kernel stops at the real-cluster count instead."""
    TP = scene.padded_tris
    C = TP // csize
    valid = (scene.tri_valid > 0.5)[:, None, None]
    vs = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    inf = float("inf")
    lo = torch.where(valid, vs, inf).reshape(C, csize * 3, 3).amin(1)
    hi = torch.where(valid, vs, -inf).reshape(C, csize * 3, 3).amax(1)
    return torch.cat([lo, hi, lo.new_zeros((C, 2))], dim=1).contiguous()


def _pack_geo(tri):
    """(TP, 12) geometry plane ``[a | e1 | e2 | n]``: the first 12 columns
    of the triangle planes ``tri``, contiguous."""
    return tri[:, :GEO_COLS].contiguous()


def _group_aabbs(boxes, size: int):
    """(ceil(n / size), 8) box of each run of ``size`` rows of the (n, 8)
    box plane ``boxes``: the min of their lows and the max of their highs.
    Rows of padding (lo = +inf, hi = -inf) drop out, and a last run that is
    short spans the rows it has."""
    n = boxes.shape[0]
    groups = -(-n // size)
    pad = groups * size - n
    inf = float("inf")
    lo = torch.cat([boxes[:, 0:3], boxes.new_full((pad, 3), inf)])
    hi = torch.cat([boxes[:, 3:6], boxes.new_full((pad, 3), -inf)])
    return torch.cat([lo.view(groups, size, 3).amin(1),
                      hi.view(groups, size, 3).amax(1),
                      boxes.new_zeros((groups, 2))], dim=1).contiguous()


def _super_aabbs(clu, ss: int = SUPER):
    """(ceil(C / ss), 8) super boxes over runs of ``ss`` rows of the real
    cluster boxes ``clu`` (C, 8): the reference's ``_super_aabbs`` over
    ``_pad_clusters_for_supers``, without its padding rows (the kernels
    stop at the real super count)."""
    return _group_aabbs(clu, ss)


# the scene tensors the packers read: the cache's key
_PLANE_FIELDS = (
    "sphere_center", "sphere_radius", "sphere_valid", "sphere_albedo",
    "sphere_emission", "sphere_emission_strength", "sphere_smoothness",
    "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
    "tri_albedo", "tri_emission", "tri_emission_strength", "tri_smoothness",
    "tri_valid")
# ... and those the textured planes read besides
_TEXTURED_PLANE_FIELDS = _PLANE_FIELDS + (
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_tan", "tri_bitan", "tri_tex",
    "tri_ntex")


class ScenePlanes:
    """The kernels' packed inputs of one scene: ``sph`` (SP, 16), ``geo``
    (TP, 12), ``tri`` (TP, 32; 48 on a textured scene), ``clu`` (TP / 64,
    8), ``sup`` (real supers, 8) and, through ``block_boxes``, the
    streaming kernel's block boxes. Kernel inputs only: none requires
    grad."""

    def __init__(self, scene: Scene):
        with torch.no_grad():  # the planes are kernel input, not graph nodes
            self.sph = _pack_spheres(scene)
            self.tri = _pack_tris(scene, scene.num_textures > 0)
            self.geo = _pack_geo(self.tri)
            self.clu = _cluster_aabbs(scene)
            self.n_clusters = -(-scene.num_tris // CLUSTER)
            self.sup = _super_aabbs(self.clu[:self.n_clusters])
        self._blk = {}

    def block_boxes(self, block_clusters: int):
        """(real blocks, 8) boxes over runs of ``block_clusters`` real
        clusters (the reference's block boxes,
        pallas_intersect.py:1549-1556), made once per block size."""
        if block_clusters not in self._blk:
            with torch.no_grad():
                self._blk[block_clusters] = _group_aabbs(
                    self.clu[:self.n_clusters], block_clusters)
        return self._blk[block_clusters]


_plane_cache = {}   # device -> (key, the keyed tensors, ScenePlanes)
_scope_depth = 0    # plane_scope()s entered and not yet left


@contextlib.contextmanager
def plane_scope():
    """The plane cache's lifetime: one top-level call. Every public entry
    point (a render, an AOV, a training step, the boundary gradients, a
    recovery step, the sharded and the viewer's frame) runs inside one;
    nested scopes share one cache, and leaving the outermost scope drops
    every entry. Also a decorator."""
    global _scope_depth
    _scope_depth += 1
    try:
        yield
    finally:
        _scope_depth -= 1
        if not _scope_depth:
            _plane_cache.clear()


def scene_planes(scene: Scene) -> ScenePlanes:
    """The packed planes of ``scene``. Inside a ``plane_scope()`` they come
    from the cache while the scene's tensors are the same storage at the
    same version (an in-place update that autograd sees, such as an
    optimizer's step, bumps ``_version`` and packs anew); outside one every
    query packs. One entry per device. The entry keeps the keyed tensors
    alive, so their addresses cannot be handed to other tensors while it
    stands, and keeps that scene's planes (128 + 48 bytes a triangle,
    192 + 48 textured) on the device until the outermost scope is left.

    The contract: the planes live as long as one top-level call, as the
    reference packs inside each jitted call. A write to a scene tensor
    between two calls is seen by any route (``.data``, ``set_``, a raw
    pointer); within one call a scene changes through new tensors or
    in-place operations that autograd sees."""
    fields = _TEXTURED_PLANE_FIELDS if scene.num_textures else _PLANE_FIELDS
    leaves = [getattr(scene, k) for k in fields]
    key = (scene.num_tris,) + tuple(
        (x.data_ptr(), x._version, x.shape) for x in leaves)
    entry = _plane_cache.get(scene.device)
    if entry is None or entry[0] != key:
        # detached aliases share storage and version with the leaves
        with span("planes.pack"):
            entry = (key, [x.detach() for x in leaves], ScenePlanes(scene))
        if _scope_depth:
            _plane_cache[scene.device] = entry
        scene_planes.packs += 1
    return entry[2]


scene_planes.packs = 0


def clear_plane_cache():
    """Forget every cached scene and free its planes: the next query packs
    anew. Never needed for correctness (the cache lives one top-level
    call); a measurement calls it to time a cold query inside a scope."""
    _plane_cache.clear()


# ---------------------------------------------------------------------------
# Pair tests (the kernel's arithmetic, association for association)
# ---------------------------------------------------------------------------

def _sphere_pairs(c, r2, o, d, a_quad, t_min):
    """Near-root sphere quadratic on broadcast (x, y, z) triples."""
    ocx, ocy, ocz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
    b = 2.0 * ((ocx * d[0] + ocy * d[1]) + ocz * d[2])
    cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r2
    disc = b * b - 4.0 * a_quad * cc
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a_quad)
    return t, (disc >= 0.0) & (t >= t_min)


def _mt_pairs(a, e1, e2, n, o, d, t_min):
    """Möller–Trumbore cross/determinant form on broadcast (x, y, z)
    triples: det >= 1e-6, u >= 0, v >= 0, u + v <= 1, t >= t_min."""
    aox, aoy, aoz = o[0] - a[0], o[1] - a[1], o[2] - a[2]
    det = -((d[0] * n[0] + d[1] * n[1]) + d[2] * n[2])
    t_num = (aox * n[0] + aoy * n[1]) + aoz * n[2]
    daox = aoy * d[2] - aoz * d[1]                      # ao × d
    daoy = aoz * d[0] - aox * d[2]
    daoz = aox * d[1] - aoy * d[0]
    u_num = (e2[0] * daox + e2[1] * daoy) + e2[2] * daoz
    v_num = -((e1[0] * daox + e1[1] * daoy) + e1[2] * daoz)
    inv = 1.0 / det
    t = t_num * inv
    u = u_num * inv
    v = v_num * inv
    valid = ((det >= TRI_DET_EPS) & (t >= t_min)
             & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return t, valid


def _cols(planes, lo, hi):
    """Plane columns lo..hi-1 as a tuple of (1, P) rows."""
    return tuple(planes[None, :, k] for k in range(lo, hi))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

@torch.no_grad()
def nearest_hit_attrs_reference(scene: Scene, o, d, t_min=1e-4, alive=None,
                                want_attrs=True, chunk=REFERENCE_CHUNK):
    """Closest hit by brute force → (t, prim_id, rows) or (t, prim_id).

    The kernel's pair arithmetic and tie rule (lowest id wins), without
    its culling: rays in chunks of ``chunk``, every primitive each. Like
    the kernel it records no autograd graph: the rows carry no gradient
    (``ops/intersect._WinnerRows`` gives them their backward)."""
    R = o.shape[0]
    o, d = o.detach(), d.detach()
    if alive is None:
        alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    sph, tri = _pack_spheres(scene), _pack_tris(scene)
    sc, (r2,), sv = _cols(sph, 0, 3), _cols(sph, 3, 4), sph[None, :, 4]
    ta, te1, te2, tn = (_cols(tri, 0, 3), _cols(tri, 3, 6), _cols(tri, 6, 9),
                        _cols(tri, 9, 12))
    ts, ids = [], []
    for s in range(0, R, chunk):
        oc = tuple(o[s:s + chunk, k:k + 1] for k in range(3))   # (r, 1)
        dc = tuple(d[s:s + chunk, k:k + 1] for k in range(3))
        live = alive[s:s + chunk, None]
        a_quad = (dc[0] * dc[0] + dc[1] * dc[1]) + dc[2] * dc[2]
        t_s, ok_s = _sphere_pairs(sc, r2, oc, dc, a_quad, t_min)
        t_s = torch.where(ok_s & (sv > 0.5) & live, t_s, float("inf"))
        t_t, ok_t = _mt_pairs(ta, te1, te2, tn, oc, dc, t_min)
        t_t = torch.where(ok_t & live, t_t, float("inf"))
        all_t = torch.cat([t_s, t_t], dim=1)
        del t_s, t_t, ok_s, ok_t
        idx = torch.argmin(all_t, dim=1)                 # first = lowest id
        best = torch.gather(all_t, 1, idx[:, None])[:, 0]
        ts.append(best)
        ids.append(torch.where(torch.isinf(best), 0, idx).to(torch.int32))
    return _plain_result(scene, o, ts, ids, want_attrs)


def _plain_result(scene: Scene, o, ts, ids, want_attrs):
    """A plain version's per-chunk bests and winner ids → (t, prim_id,
    rows) or (t, prim_id), the kernels' outputs: id 0 on a miss, and the
    rows ``_pack_attrs(scene)[prim_id].T``, zero on a miss."""
    best_t = torch.cat(ts) if ts else o.new_zeros((0,))
    prim_id = (torch.cat(ids) if ids
               else torch.zeros((0,), dtype=torch.int32, device=o.device))
    if not want_attrs:
        return best_t, prim_id
    rows = _pack_attrs(scene)[prim_id.long()]
    rows = torch.where(torch.isinf(best_t)[:, None], 0.0, rows)
    return best_t, prim_id, rows.T.contiguous()


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check_inputs(scene: Scene, o, d, alive):
    dev = o.device
    for name, x in (("o", o), ("d", d)):
        if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
            raise ValueError(f"{name} must be (R, 3) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, o on {dev}")
    if d.shape[0] != o.shape[0]:
        raise ValueError("o and d must hold the same number of rays")
    if alive is not None and (alive.shape != (o.shape[0],)
                              or alive.dtype != torch.bool
                              or alive.device != dev):
        raise ValueError("alive must be an (R,) bool tensor beside the rays")
    if scene.device != dev:
        raise ValueError(f"scene is on {scene.device}, rays on {dev}")
    if scene.padded_tris % CLUSTER:
        raise ValueError(f"padded triangle count {scene.padded_tris} is not "
                         f"a multiple of the {CLUSTER}-triangle cluster")
    if max(o.shape[0] * attr_width(scene), scene.padded_tris * tri_cols(
            scene.num_textures > 0)) >= 2 ** 31:
        raise ValueError("too many rays or triangles for 32-bit indexing")


# bytes of shared memory a thread block can take on the card (227 KB)
MAX_SHARED_BYTES = 232_448


def _check_shared(kernel: str, shared: int, n_clusters: int):
    """Raise where a kernel that keeps a scene's boxes in shared memory
    (the closest-hit and any-hit kernels) would need ``shared`` bytes, more
    than a thread block can take."""
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"the {kernel} kernel keeps a scene's boxes in shared memory: "
            f"{n_clusters} clusters need {shared} bytes of the card's "
            f"{MAX_SHARED_BYTES}; the streaming kernel "
            f"(blocked_hit.nearest_hit_blocked, which "
            f"intersect.occluded_kernels takes for shadow rays past the "
            f"crossover) takes such scenes")


def _ray_args(o, d, alive):
    """The kernels' ray arguments: o, d and alive detached and contiguous
    (the kernels read them as the renderer holds them: no copy), and their
    three device pointers, alive's None where every lane is live. The
    caller holds the returned tensors over the launch."""
    o, d = o.detach().contiguous(), d.detach().contiguous()
    alive = None if alive is None else alive.contiguous()
    return (o, d, alive), (o.data_ptr(), d.data_ptr(),
                           None if alive is None else alive.data_ptr())


def _hit_outputs(scene, R, dev, want_attrs):
    """Uninitialised (t, prim_id, rows) outputs, rows (attr_width, R) or
    None without ``want_attrs``."""
    return (torch.empty((R,), dtype=torch.float32, device=dev),
            torch.empty((R,), dtype=torch.int32, device=dev),
            torch.empty((attr_width(scene), R), dtype=torch.float32,
                        device=dev) if want_attrs else None)


def nearest_hit_attrs(scene: Scene, o, d, t_min=1e-4, alive=None,
                      want_attrs=True):
    """Closest hit of each ray → (t (R,), prim_id (R,) int32, rows (26, R),
    (40, R) on a textured scene) with ``want_attrs``, else (t, prim_id).

    CUDA tensors launch the kernel (built at first use): its textured
    variant where a textured scene's rows are wanted, counted in
    ``nearest_hit_attrs.tex_launches``, else its untextured variants,
    counted in ``nearest_hit_attrs.launches``. CPU tensors take
    the plain version; any other device, input the kernel does not take,
    or a scene whose boxes do not fit into the kernel's shared memory
    raises. Nothing falls back silently. The scene's packed planes come
    from ``scene_planes``, cached for the enclosing ``plane_scope``."""
    if o.device.type == "cpu":
        return nearest_hit_attrs_reference(scene, o, d, t_min, alive,
                                           want_attrs)
    if o.device.type != "cuda":
        raise ValueError(f"no closest-hit kernel for device {o.device}")
    _check_inputs(scene, o, d, alive)
    R, dev = o.shape[0], o.device
    t_out, id_out, rows = _hit_outputs(scene, R, dev, want_attrs)
    if R == 0:
        return (t_out, id_out, rows) if want_attrs else (t_out, id_out)
    lib = build.library("closest_hit", SIGNATURES)
    planes = scene_planes(scene)
    textured = want_attrs and scene.num_textures > 0
    n_clusters, n_supers = planes.n_clusters, planes.sup.shape[0]
    _check_shared("closest-hit",
                  lib.rtt_closest_hit_shared_bytes(n_clusters, n_supers),
                  n_clusters)
    (o, d, alive), ray_ptrs = _ray_args(o, d, alive)
    build.launch(
        lib, "rtt_closest_hit", "closest-hit", dev, *ray_ptrs, R,
        planes.sph.data_ptr(), scene.padded_spheres, scene.num_spheres,
        planes.geo.data_ptr(), planes.tri.data_ptr(), planes.clu.data_ptr(),
        n_clusters, planes.sup.data_ptr(), n_supers,
        _copy_map_tensor(dev, textured).data_ptr(), float(t_min),
        int(want_attrs), int(textured), t_out.data_ptr(), id_out.data_ptr(),
        rows.data_ptr() if want_attrs else None)
    if textured:
        nearest_hit_attrs.tex_launches += 1
    else:
        nearest_hit_attrs.launches += 1
    return (t_out, id_out, rows) if want_attrs else (t_out, id_out)


nearest_hit_attrs.launches = 0
nearest_hit_attrs.tex_launches = 0
