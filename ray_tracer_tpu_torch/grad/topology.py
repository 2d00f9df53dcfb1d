"""Mesh connectivity for geometry gradients (host-side build).

Port of ``ray_tracer_tpu.grad.topology``. The scene stores pre-gathered
triangles (tri_v0/v1/v2), with no vertex indexing left. Geometry recovery
needs it back, twice over:

  * a per-vertex offset field must move every (triangle, corner) slot of
    a physical vertex together, and pull the slot cotangents back onto
    unique vertices;
  * the edge-sampled boundary estimator (``grad/edges.py``) must sample
    each physical edge once (the uniform-over-slots sampler counts an
    interior edge twice, once per adjacent triangle) and needs face
    adjacency to classify silhouettes.

``build_topology`` rebuilds connectivity by exact-bitwise position dedup
(loaders emit single-indexed vertices, so every shared corner is the same
f32 triple). It runs in numpy on the host and gives the reference's
arrays element for element; the result is a frozen dataclass of tensors
on the scene's device. The consumers are differentiable torch: every
``.at[].add`` of the reference is an ``index_add``, and every bound goes
through ``utils/bounds.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.intersect import cross
from ..scene import Scene
from ..utils.bounds import maximum


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Connectivity of a scene's valid triangles.

    Vertices: ``num_verts`` unique positions; ``tri2vert[t, k]`` maps the
    k-th corner of triangle t to its unique vertex id (padding triangles
    map to the all-zero vertex and are masked by ``tri_valid``).

    Edges: one entry per physical undirected edge. ``edge_tri``/``edge_k``
    name a representative (triangle, corner) slot: the edge runs corner k
    → corner (k+1)%3 of that triangle; ``edge_tri2`` is the other adjacent
    triangle (-1 on boundary edges). ``edge_crease`` is 1.0 where shading
    normals differ across the edge. Index tensors are int64.
    """

    tri2vert: torch.Tensor      # (T, 3)
    base_verts: torch.Tensor    # (V, 3) f32 unique positions at build time
    edge_tri: torch.Tensor      # (E,)
    edge_k: torch.Tensor        # (E,)
    edge_tri2: torch.Tensor     # (E,) -1 = boundary
    edge_crease: torch.Tensor   # (E,) f32 {0, 1}
    edge_va: torch.Tensor       # (E,) unique vertex id of corner k
    edge_vb: torch.Tensor       # (E,) unique vertex id of corner k+1

    @property
    def num_verts(self) -> int:
        return self.base_verts.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_tri.shape[0]


def _edges(tri2vert: np.ndarray, valid: np.ndarray):
    """The reference's dict walk over (triangle, corner) slots, vectorised:
    → (keys' first slots in first-occurrence order, second slots or -1).
    Each undirected edge (a, b), a != b, of a valid triangle is one entry;
    entries appear in the order of their first slot t * 3 + k, and an
    entry's instances in slot order, as the reference's ``setdefault``
    lists them."""
    T = tri2vert.shape[0]
    a = tri2vert.reshape(-1).astype(np.int64)
    b = tri2vert[:, [1, 2, 0]].reshape(-1).astype(np.int64)
    slot = np.arange(T * 3, dtype=np.int64)
    keep = np.repeat(valid, 3) & (a != b)
    a, b, slot = a[keep], b[keep], slot[keep]
    if not slot.size:
        return slot, slot
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo * (int(tri2vert.max(initial=0)) + 1) + hi
    # stable sort by key keeps each key's slots in slot order
    order = np.argsort(key, kind="stable")
    key_s, slot_s = key[order], slot[order]
    start = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    count = np.diff(np.r_[start, key_s.shape[0]])
    first = slot_s[start]
    second = np.where(count >= 2, slot_s[np.minimum(start + 1,
                                                    key_s.shape[0] - 1)], -1)
    by_first = np.argsort(first, kind="stable")
    return first[by_first], second[by_first]


def build_topology(scene: Scene, crease_cos: float = 0.999) -> MeshTopology:
    """Host-side connectivity build over the scene's valid triangles, on
    the scene's device.

    crease_cos: an edge is flagged crease when the shading normals the two
    adjacent triangles assign to a shared endpoint disagree beyond this
    cosine, i.e. the mesh is intentionally faceted there.
    """
    v = [x.detach().cpu().numpy().astype(np.float32)
         for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    n = [x.detach().cpu().numpy().astype(np.float32)
         for x in (scene.tri_n0, scene.tri_n1, scene.tri_n2)]
    valid = scene.tri_valid.detach().cpu().numpy() > 0.5
    T = v[0].shape[0]

    corners = np.stack(v, axis=1).reshape(T * 3, 3)
    # exact-bitwise dedup: view rows as void records
    rec = np.ascontiguousarray(corners).view(
        np.dtype((np.void, corners.dtype.itemsize * 3))).reshape(-1)
    _, first_idx, inv = np.unique(rec, return_index=True,
                                  return_inverse=True)
    base_verts = corners[first_idx]
    tri2vert = inv.reshape(T, 3).astype(np.int64)

    normals = np.stack(n, axis=1)                          # (T, 3, 3)
    nrm = normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)

    first, second = _edges(tri2vert, valid)
    t0, k0 = first // 3, first % 3
    e_va = tri2vert[t0, k0]
    e_vb = tri2vert[t0, (k0 + 1) % 3]
    shared = second >= 0
    t1 = np.where(shared, second // 3, 0)
    crease = np.zeros(first.shape[0], np.float32)
    for vid in (np.minimum(e_va, e_vb), np.maximum(e_va, e_vb)):
        # the corner of each adjacent triangle at this shared endpoint
        # (the first matching corner, as the reference's np.where(...)[0][0])
        s0 = np.argmax(tri2vert[t0] == vid[:, None], axis=1)
        s1 = np.argmax(tri2vert[t1] == vid[:, None], axis=1)
        dot = np.sum(nrm[t0, s0] * nrm[t1, s1], axis=-1, dtype=np.float32)
        crease[shared & (dot < crease_cos)] = 1.0

    dev = scene.device

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    return MeshTopology(
        tri2vert=t(tri2vert), base_verts=t(base_verts, torch.float32),
        edge_tri=t(t0), edge_k=t(k0), edge_tri2=t(np.where(shared, t1, -1)),
        edge_crease=t(crease, torch.float32), edge_va=t(e_va),
        edge_vb=t(e_vb))


# ---------------------------------------------------------------------------
# Differentiable vertex-field plumbing
# ---------------------------------------------------------------------------

def apply_vertex_offsets(scene: Scene, topo: MeshTopology, offsets,
                         recompute_normals: bool = True) -> Scene:
    """Scene with ``offsets`` ((V, 3)) added to every slot of each unique
    vertex; differentiable with respect to offsets. With
    ``recompute_normals``, shading normals are rebuilt area-weighted from
    the deformed positions (also differentiable), so interior shading
    gradients see geometry. The result holds new tensors and never writes
    into ``scene``'s, so the kernels' plane cache packs it anew."""
    m = scene.tri_valid[:, None]
    v0 = scene.tri_v0 + offsets[topo.tri2vert[:, 0]] * m
    v1 = scene.tri_v1 + offsets[topo.tri2vert[:, 1]] * m
    v2 = scene.tri_v2 + offsets[topo.tri2vert[:, 2]] * m
    kw = dict(tri_v0=v0, tri_v1=v1, tri_v2=v2)
    if recompute_normals:
        n0, n1, n2 = smooth_normals(topo, v0, v1, v2, scene.tri_valid)
        kw.update(tri_n0=n0, tri_n1=n1, tri_n2=n2)
    return dataclasses.replace(scene, **kw)


def smooth_normals(topo: MeshTopology, v0, v1, v2, tri_valid):
    """Area-weighted smooth vertex normals from (possibly deformed)
    positions, scattered onto unique vertices and gathered back to the
    (T, 3) corner slots. The norm is ``vector_norm``, whose gradient at a
    zero vector (the padding vertex) is 0 where ``jnp.linalg.norm``'s is
    NaN."""
    fn = cross(v1 - v0, v2 - v0) * tri_valid[:, None]      # (T, 3)
    acc = fn.new_zeros((topo.num_verts, 3))
    for k in range(3):
        acc = acc.index_add(0, topo.tri2vert[:, k], fn)
    acc = acc / maximum(torch.linalg.vector_norm(acc, dim=-1, keepdim=True),
                        1e-12)
    return (acc[topo.tri2vert[:, 0]], acc[topo.tri2vert[:, 1]],
            acc[topo.tri2vert[:, 2]])


def pull_back_vertex_grads(topo: MeshTopology, tri_grads: dict,
                           tri_valid) -> torch.Tensor:
    """Transpose of apply_vertex_offsets' gather: accumulate tri-slot
    cotangents (keys tri_v0/tri_v1/tri_v2) onto unique vertices → (V, 3)."""
    g = tri_valid.new_zeros((topo.num_verts, 3))
    m = tri_valid[:, None]
    for k, key in enumerate(("tri_v0", "tri_v1", "tri_v2")):
        g = g.index_add(0, topo.tri2vert[:, k], tri_grads[key] * m)
    return g


def laplacian_apply(topo: MeshTopology, x) -> torch.Tensor:
    """Combinatorial graph Laplacian over physical edges, per component:
    (L x)_i = Σ_{j∈N(i)} (x_i − x_j). Matrix-free (two scatter-adds)."""
    d = x[topo.edge_va] - x[topo.edge_vb]
    out = torch.zeros_like(x).index_add(0, topo.edge_va, d)
    return out.index_add(0, topo.edge_vb, -d)


def _vdot(a, b):
    return torch.sum(a * b)


def sobolev_precondition(topo: MeshTopology, g, lam, iters: int = 20):
    """Diffuse a vertex gradient through (I + λL)⁻¹ by matrix-free CG
    ("Large Steps in Inverse Rendering of Geometry", Nicolet et al. 2021):
    rough components are damped by ~1/(1+λ·spectrum) while low-frequency
    modes keep their magnitude. λ (a float or a 0-d tensor) is
    dimensionless; 0 returns ``g`` itself.

    The loop is ``jax.scipy.sparse.linalg.cg``'s as the reference calls it:
    x0 = g, no preconditioner, tol 1e-5, atol 0, at most ``iters``
    iterations while ‖r‖² > tol²·‖b‖². It runs all ``iters`` iterations and
    freezes the state once the rule stops it, so that the host never
    waits on the device; the iterates are the same."""
    if not bool(lam):
        return g
    lam = torch.as_tensor(lam, dtype=g.dtype, device=g.device)

    def mv(p):
        return p + lam * laplacian_apply(topo, p)

    atol2 = 1e-5 ** 2 * _vdot(g, g)     # max(tol² ‖b‖², atol²), atol 0
    x = g
    r = g - mv(x)
    p = r
    gamma = _vdot(r, r)
    for _ in range(iters):
        go = gamma > atol2
        ap = mv(p)
        alpha = gamma / _vdot(p, ap)
        x_ = x + alpha * p
        r_ = r - alpha * ap
        gamma_ = _vdot(r_, r_)
        p_ = r_ + (gamma_ / gamma) * p
        x = torch.where(go, x_, x)
        r = torch.where(go, r_, r)
        p = torch.where(go, p_, p)
        gamma = torch.where(go, gamma_, gamma)
    return x


def dirichlet_energy(topo: MeshTopology, offsets) -> torch.Tensor:
    """Graph-Laplacian smoothness prior on a vertex field: mean squared
    field difference across physical edges, ‖δ_i − δ_j‖², normalized by
    the base edge length ‖x_i − x_j‖², so the energy is dimensionless and
    a given weight transfers across mesh resolutions."""
    d = offsets[topo.edge_va] - offsets[topo.edge_vb]
    e = topo.base_verts[topo.edge_va] - topo.base_verts[topo.edge_vb]
    e2 = maximum(torch.sum(e * e, dim=-1), 1e-20)
    return torch.mean(torch.sum(d * d, dim=-1) / e2)
