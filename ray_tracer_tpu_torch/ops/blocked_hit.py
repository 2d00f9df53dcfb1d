"""Streaming closest-hit kernel for large scenes (CUDA C++,
``csrc/blocked_hit.cu``) with its plain PyTorch version, its wrapper and
the rule that picks it.

Port of the streaming (tri-blocked) closest-hit kernel of
``ray_tracer_tpu/ops/pallas_intersect.py`` (``_make_blocked_kernel``,
``_block_lists`` and ``_nearest_hit_blocked_call``). It computes what the
closest-hit kernel (``closest_hit.py``) computes, with the same inputs,
outputs and tie rule (the lowest id wins), over a four-level hierarchy:
blocks of ``BLOCK`` triangles, supers of 8 clusters, 64-triangle clusters,
triangles. The packed planes come from ``closest_hit.scene_planes``.

  * ``uses_blocked`` — the reference's default crossover: scenes past it
    take this kernel, the others the closest-hit kernel.
  * ``nearest_hit_blocked`` — the wrapper: launches the kernel for CUDA
    tensors; the plain version runs only for tensors on the CPU. Anything
    the kernel does not take raises. ``nearest_hit_blocked.launches``
    counts the untextured variants' launches, ``.ids_launches`` those
    without rows, ``.tex_launches`` the textured variant's (a textured
    scene's rows).
  * ``nearest_hit_blocked_reference`` — the plain version: every sphere,
    then the triangles block by block in ascending order, no culling.
"""

from __future__ import annotations

import ctypes

import torch

from ..scene import Scene
from ..utils import build
from .closest_hit import (CLUSTER, REFERENCE_CHUNK, _check_inputs, _cols,
                          _copy_map_tensor, _hit_outputs, _mt_pairs,
                          _pack_spheres, _pack_tris, _plain_result, _ray_args,
                          _sphere_pairs, scene_planes)

BLOCK = 8192       # triangles per block (the reference's KConfig.tri_block)
# The reference's crossover (pallas_intersect.py:131-136, 1954-1962): its
# resident kernel keeps the triangle planes in VMEM at 128 lanes x 4 bytes a
# row within a 12 MB budget, so scenes of more than 24,576 padded triangles
# stream. The port keeps the same scenes on the same kind of kernel.
VMEM_TRI_BUDGET = 12 << 20
LANE_ROW_BYTES = 128 * 4
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "rtt_blocked_hit": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P,
                        _I, _I, _P, ctypes.c_float, _I, _I, _P, _P, _P, _P],
    "rtt_blocked_hit_shared_bytes": [],
    "rtt_blocked_hit_blocks_per_sm": [_I, _I]}


def uses_blocked(scene: Scene) -> bool:
    """Whether ``scene`` takes the streaming kernel (past the crossover)."""
    return scene.padded_tris * LANE_ROW_BYTES > VMEM_TRI_BUDGET


def block_layout(scene: Scene, block: int = BLOCK):
    """(clusters per block, real clusters, real blocks) of ``scene`` in
    blocks of ``block`` triangles; raises unless ``block`` is a positive
    multiple of the cluster."""
    if block < CLUSTER or block % CLUSTER:
        raise ValueError(f"block {block} is not a positive multiple of the "
                         f"{CLUSTER}-triangle cluster")
    n_clusters = -(-scene.num_tris // CLUSTER)
    return block // CLUSTER, n_clusters, -(-n_clusters // (block // CLUSTER))


@torch.no_grad()
def nearest_hit_blocked_reference(scene: Scene, o, d, t_min=1e-4, alive=None,
                                  want_attrs=True, block=BLOCK,
                                  chunk=REFERENCE_CHUNK):
    """Closest hit by brute force, block by block → (t, prim_id, rows) or
    (t, prim_id).

    The kernel's pair arithmetic without its culling: rays in chunks of
    ``chunk``; the spheres, then each run of ``block`` triangles in
    ascending order, folded into the running best where it is strictly
    closer, so the lowest id wins a tie. The result equals the closest-hit
    plain version's bit for bit; ``block`` only bounds the temporaries to
    (chunk, block)."""
    block_layout(scene, block)
    R = o.shape[0]
    o, d = o.detach(), d.detach()
    if alive is None:
        alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    sph, tri = _pack_spheres(scene), _pack_tris(scene)
    SP, TP = scene.padded_spheres, scene.padded_tris
    sc, (r2,), sv = _cols(sph, 0, 3), _cols(sph, 3, 4), sph[None, :, 4]
    ts, ids = [], []
    for s in range(0, R, chunk):
        oc = tuple(o[s:s + chunk, k:k + 1] for k in range(3))   # (r, 1)
        dc = tuple(d[s:s + chunk, k:k + 1] for k in range(3))
        live = alive[s:s + chunk, None]
        a_quad = (dc[0] * dc[0] + dc[1] * dc[1]) + dc[2] * dc[2]
        t_s, ok_s = _sphere_pairs(sc, r2, oc, dc, a_quad, t_min)
        t_s = torch.where(ok_s & (sv > 0.5) & live, t_s, float("inf"))
        idx = torch.argmin(t_s, dim=1)                   # first = lowest id
        best = torch.gather(t_s, 1, idx[:, None])[:, 0]
        for b0 in range(0, TP, block):
            q = tri[b0:b0 + block]
            t_t, ok_t = _mt_pairs(_cols(q, 0, 3), _cols(q, 3, 6),
                                  _cols(q, 6, 9), _cols(q, 9, 12), oc, dc,
                                  t_min)
            t_t = torch.where(ok_t & live, t_t, float("inf"))
            j = torch.argmin(t_t, dim=1)
            t_b = torch.gather(t_t, 1, j[:, None])[:, 0]
            closer = t_b < best               # ties keep the lower id
            best = torch.where(closer, t_b, best)
            idx = torch.where(closer, SP + b0 + j, idx)
        ts.append(best)
        ids.append(torch.where(torch.isinf(best), 0, idx).to(torch.int32))
    return _plain_result(scene, o, ts, ids, want_attrs)


def nearest_hit_blocked(scene: Scene, o, d, t_min=1e-4, alive=None,
                        want_attrs=True, block=BLOCK):
    """Closest hit of each ray through the block hierarchy → (t (R,),
    prim_id (R,) int32, rows (26, R), (40, R) on a textured scene) with
    ``want_attrs``, else (t, prim_id): the closest-hit kernel's outputs.

    CUDA tensors launch the kernel (built at first use), for any number
    of blocks; CPU tensors take the plain version; any other device or
    input the kernel does not take raises. Nothing falls back silently.
    The scene's packed planes come from ``closest_hit.scene_planes``,
    cached for the enclosing ``plane_scope``."""
    if o.device.type == "cpu":
        return nearest_hit_blocked_reference(scene, o, d, t_min, alive,
                                             want_attrs, block)
    if o.device.type != "cuda":
        raise ValueError(f"no streaming closest-hit kernel for device "
                         f"{o.device}")
    _check_inputs(scene, o, d, alive)
    block_clusters, n_clusters, n_blocks = block_layout(scene, block)
    R, dev = o.shape[0], o.device
    t_out, id_out, rows = _hit_outputs(scene, R, dev, want_attrs)
    if R == 0:
        return (t_out, id_out, rows) if want_attrs else (t_out, id_out)
    lib = build.library("blocked_hit", SIGNATURES)
    planes = scene_planes(scene)
    textured = want_attrs and scene.num_textures > 0
    (o, d, alive), ray_ptrs = _ray_args(o, d, alive)
    build.launch(
        lib, "rtt_blocked_hit", "streaming closest-hit", dev, *ray_ptrs, R,
        planes.sph.data_ptr(), scene.padded_spheres, scene.num_spheres,
        planes.geo.data_ptr(), planes.tri.data_ptr(), planes.clu.data_ptr(),
        n_clusters, planes.sup.data_ptr(),
        planes.block_boxes(block_clusters).data_ptr(), n_blocks,
        block_clusters, _copy_map_tensor(dev, textured).data_ptr(),
        float(t_min), int(want_attrs), int(textured), t_out.data_ptr(),
        id_out.data_ptr(), rows.data_ptr() if want_attrs else None)
    if textured:
        nearest_hit_blocked.tex_launches += 1
    else:
        nearest_hit_blocked.launches += 1
        nearest_hit_blocked.ids_launches += not want_attrs
    return (t_out, id_out, rows) if want_attrs else (t_out, id_out)


nearest_hit_blocked.launches = 0
nearest_hit_blocked.ids_launches = 0
nearest_hit_blocked.tex_launches = 0
