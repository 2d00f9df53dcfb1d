"""Any-hit (shadow-ray) kernel (CUDA C++, ``csrc/anyhit.cu``) with its
plain PyTorch version and its wrapper.

Port of the any-hit kernel of ``ray_tracer_tpu/ops/pallas_intersect.py``
(``_make_anyhit_kernel`` through ``anyhit_pallas``). Same inputs and
output: rays (R, 3) + liveness → (R,) bool, True where some sphere or
triangle is hit with t in ``[t_min, t_max)``, t in units of |d| (so d
spans the shadow segment). Dead lanes are False. The tests are the
closest-hit kernel's (``closest_hit._sphere_pairs``, ``_mt_pairs``) plus
``t < t_max``, and the cluster culling is its slab test with ``t_max`` in
place of the running best. The kernel runs on the closest-hit kernels'
traversal core (supers, shared-memory boxes, warp tiles), which keeps the
scene's boxes in shared memory as the closest-hit kernel does.

  * ``anyhit`` — the wrapper: launches the kernel for CUDA tensors; the
    plain version runs only for tensors on the CPU. Anything the kernel
    does not take, or a scene whose boxes do not fit into its shared
    memory, raises. ``anyhit.launches`` counts kernel launches.
  * ``anyhit_reference`` — the plain version: every sphere, then every
    triangle of the real clusters that the ray's segment enters, in ray
    chunks under ``ops/intersect._PAIR_BUDGET``.

Blocking is an OR over primitives, so the order in which the kernel visits
them and where it stops do not change the answer: kernel and plain version
agree on every lane.
"""

from __future__ import annotations

import ctypes

import torch

from ..scene import Scene
from ..utils import build
from . import intersect
from .closest_hit import (CLUSTER, _check_inputs, _check_shared,
                          _cluster_aabbs, _cols, _mt_pairs, _pack_spheres,
                          _pack_tris, _ray_args, _sphere_pairs, scene_planes)

# end of the shadow segment, in units of |d|: stops short of the light's
# own surface (the reference's occluded)
SHADOW_T_MAX = 1.0 - 1e-3
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "rtt_anyhit": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _F, _F, _P,
                   _P],
    "rtt_anyhit_shared_bytes": [_I, _I],
    "rtt_anyhit_blocks_per_sm": [_I, _I]}


def _slab_pairs(lo, hi, o, invd, t_min):
    """Cluster-box slab test on broadcast (x, y, z) triples → (tn, tf),
    the kernel's min/max nesting (the reference's ``_slab_test``)."""
    t1 = [(lo[k] - o[k]) * invd[k] for k in range(3)]
    t2 = [(hi[k] - o[k]) * invd[k] for k in range(3)]
    near = [torch.minimum(a, b) for a, b in zip(t1, t2)]
    far = [torch.maximum(a, b) for a, b in zip(t1, t2)]
    tn = torch.maximum(torch.maximum(near[0], near[1]),
                       torch.clamp(near[2], min=t_min))
    tf = torch.minimum(torch.minimum(far[0], far[1]), far[2])
    return tn, tf


@torch.no_grad()
def anyhit_reference(scene: Scene, o, d, t_min=1e-4, t_max=SHADOW_T_MAX,
                     alive=None):
    """Shadow query by brute force over spheres and culled clusters →
    (R,) bool. The kernel's pair arithmetic, slab test and cluster count;
    rays in chunks of at most ``_PAIR_BUDGET`` ray-primitive pairs."""
    R = o.shape[0]
    o, d = o.detach(), d.detach()
    if alive is None:
        alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    sph, tri = _pack_spheres(scene), _pack_tris(scene)
    n_clusters = -(-scene.num_tris // CLUSTER)
    tri = tri[:n_clusters * CLUSTER]
    clu = _cluster_aabbs(scene)[:n_clusters]
    sc, (r2,), sv = _cols(sph, 0, 3), _cols(sph, 3, 4), sph[None, :, 4]
    ta, te1, te2, tn_ = (_cols(tri, 0, 3), _cols(tri, 3, 6), _cols(tri, 6, 9),
                         _cols(tri, 9, 12))
    lo, hi = _cols(clu, 0, 3), _cols(clu, 3, 6)
    step = max(1, intersect._PAIR_BUDGET
               // (scene.padded_spheres + n_clusters * CLUSTER))
    out = []
    for s in range(0, R, step):
        oc = tuple(o[s:s + step, k:k + 1] for k in range(3))   # (r, 1)
        dc = tuple(d[s:s + step, k:k + 1] for k in range(3))
        a_quad = (dc[0] * dc[0] + dc[1] * dc[1]) + dc[2] * dc[2]
        t_s, ok_s = _sphere_pairs(sc, r2, oc, dc, a_quad, t_min)
        blocked = (ok_s & (t_s < t_max) & (sv > 0.5)).any(1)
        if n_clusters:
            invd = tuple(1.0 / torch.where(x == 0.0, 1e-30, x) for x in dc)
            tn, tf = _slab_pairs(lo, hi, oc, invd, t_min)
            enter = ((tf >= tn) & (tn < t_max)).repeat_interleave(CLUSTER, 1)
            t_t, ok_t = _mt_pairs(ta, te1, te2, tn_, oc, dc, t_min)
            blocked |= (ok_t & (t_t < t_max) & enter).any(1)
        out.append(blocked & alive[s:s + step])
    return (torch.cat(out) if out
            else torch.zeros((0,), dtype=torch.bool, device=o.device))


def anyhit(scene: Scene, o, d, t_min=1e-4, t_max=SHADOW_T_MAX, alive=None):
    """True where some primitive is hit with t in ``[t_min, t_max)`` along
    o + t·d → (R,) bool; dead lanes False.

    CUDA tensors launch the kernel (built at first use); CPU tensors take
    the plain version; any other device, input the kernel does not take,
    or a scene whose boxes do not fit into the kernel's shared memory
    raises. Nothing falls back silently. The scene's packed planes come
    from ``closest_hit.scene_planes``, cached for the enclosing
    ``plane_scope``."""
    if o.device.type == "cpu":
        return anyhit_reference(scene, o, d, t_min, t_max, alive)
    if o.device.type != "cuda":
        raise ValueError(f"no any-hit kernel for device {o.device}")
    _check_inputs(scene, o, d, alive)
    R, dev = o.shape[0], o.device
    out = torch.empty((R,), dtype=torch.bool, device=dev)
    if R == 0:
        return out
    lib = build.library("anyhit", SIGNATURES)
    planes = scene_planes(scene)   # packed once per call (closest_hit.py)
    n_clusters, n_supers = planes.n_clusters, planes.sup.shape[0]
    _check_shared("any-hit", lib.rtt_anyhit_shared_bytes(n_clusters, n_supers),
                  n_clusters)
    (o, d, alive), ray_ptrs = _ray_args(o, d, alive)
    build.launch(lib, "rtt_anyhit", "any-hit", dev, *ray_ptrs, R,
                 planes.sph.data_ptr(), scene.num_spheres,
                 planes.geo.data_ptr(), planes.clu.data_ptr(), n_clusters,
                 planes.sup.data_ptr(), n_supers, float(t_min), float(t_max),
                 out.data_ptr())
    anyhit.launches += 1
    return out


anyhit.launches = 0
