"""Scene representation: padded structure-of-arrays tensors + builders.

Port of ``ray_tracer_tpu.scene``. The scene is a frozen dataclass of
padded torch tensors with the same fields, padding and static counts as
the reference's pytree:

  * triangles are pre-gathered (v0/v1/v2, n0/n1/n2 as (T, 3)) with the mesh
    translation baked in at build time;
  * materials are stored per primitive;
  * arrays are padded to a multiple of ``pad`` rows, with validity masks.

``SceneBuilder.build`` runs the reference's host-side numpy code unchanged
(median-split or Morton triangle ordering, tangent frames), so triangle ids
match the reference one for one. ``scene_from_numpy`` carries a reference
scene across as numpy leaves. The builders put the scene on the card
(``device="cuda"``) unless the caller asks for another device, as a CPU
caller does with ``device="cpu"``; without a card they raise. The scene's
device is wherever its tensors live; ``Scene.to`` moves it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .camera import Camera
from .texture import prepare_texture

PAD = 128  # padding unit of the primitive arrays

# tensor fields in declaration order; the rest are static ints
TENSOR_FIELDS = (
    "sphere_center", "sphere_radius", "sphere_albedo", "sphere_emission",
    "sphere_emission_strength", "sphere_smoothness", "sphere_valid",
    "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
    "tri_albedo", "tri_emission", "tri_emission_strength", "tri_smoothness",
    "tri_valid", "tri_uv0", "tri_uv1", "tri_uv2", "tri_tan", "tri_bitan",
    "tri_tex", "tri_ntex", "textures",
)
STATIC_FIELDS = ("num_spheres", "num_tris", "num_textures", "num_normal_maps")


@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-side scene. All tensors f32 except tri_tex/tri_ntex (int32)."""

    sphere_center: torch.Tensor             # (S, 3)
    sphere_radius: torch.Tensor             # (S,)
    sphere_albedo: torch.Tensor             # (S, 3)
    sphere_emission: torch.Tensor           # (S, 3)
    sphere_emission_strength: torch.Tensor  # (S,)
    sphere_smoothness: torch.Tensor         # (S,)
    sphere_valid: torch.Tensor              # (S,) {0, 1}

    tri_v0: torch.Tensor                    # (T, 3)
    tri_v1: torch.Tensor                    # (T, 3)
    tri_v2: torch.Tensor                    # (T, 3)
    tri_n0: torch.Tensor                    # (T, 3) raw vertex normals
    tri_n1: torch.Tensor                    # (T, 3)
    tri_n2: torch.Tensor                    # (T, 3)
    tri_albedo: torch.Tensor                # (T, 3)
    tri_emission: torch.Tensor              # (T, 3)
    tri_emission_strength: torch.Tensor     # (T,)
    tri_smoothness: torch.Tensor            # (T,)
    tri_valid: torch.Tensor                 # (T,) {0, 1}

    tri_uv0: torch.Tensor                   # (T, 2)
    tri_uv1: torch.Tensor                   # (T, 2)
    tri_uv2: torch.Tensor                   # (T, 2)
    tri_tan: torch.Tensor                   # (T, 3)
    tri_bitan: torch.Tensor                 # (T, 3)
    tri_tex: torch.Tensor                   # (T,) int32, -1 = untextured
    tri_ntex: torch.Tensor                  # (T,) int32
    textures: torch.Tensor                  # (K, R, R, 3)

    num_spheres: int = 0
    num_tris: int = 0
    num_textures: int = 0
    num_normal_maps: int = 0

    @property
    def padded_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def padded_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sphere_center.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in TENSOR_FIELDS})

    def detach(self) -> "Scene":
        """The scene without autograd: detached aliases of the same
        storage (and version), so the kernels' plane cache knows them."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).detach() for k in TENSOR_FIELDS})


def scene_from_numpy(fields: Dict[str, object], device="cuda") -> Scene:
    """Scene from numpy leaves, e.g. a reference scene's
    ``{k: np.asarray(v) for k, v in dataclasses.asdict(jax_scene).items()}``.
    Tensor fields keep their values and dtypes; static counts become ints."""
    kw = {k: torch.from_numpy(np.array(fields[k])).to(device)
          for k in TENSOR_FIELDS}
    kw.update({k: int(fields[k]) for k in STATIC_FIELDS})
    return Scene(**kw)


@dataclasses.dataclass
class SceneBuilder:
    """Host-side scene assembly (numpy), built into a ``Scene``."""

    spheres: List[Tuple] = dataclasses.field(default_factory=list)
    tris: List[Dict] = dataclasses.field(default_factory=list)
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    texture_resolution: int = 512

    def add_texture(self, image, srgb: bool = True) -> int:
        """Register a texture image (resized to ``texture_resolution``
        square, ``texture.prepare_texture``) → its id for
        ``add_mesh(tex=..., normal_tex=...)``. Diffuse maps pass
        ``srgb=True`` (decoded to linear), normal maps ``srgb=False``."""
        self.textures.append(
            prepare_texture(image, self.texture_resolution, srgb))
        return len(self.textures) - 1

    def add_sphere(self, center, radius, albedo, emission=(0.0, 0.0, 0.0),
                   emission_strength=0.0, smoothness=0.0) -> "SceneBuilder":
        # smoothness >= 1 clamps to 1; the dielectric sentinel -1 passes
        smoothness = smoothness if smoothness < 1.0 else 1.0
        self.spheres.append((tuple(center), float(radius), tuple(albedo),
                             tuple(emission), float(emission_strength),
                             float(smoothness)))
        return self

    def add_mesh(self, vertices, normals, indices, pos=(0.0, 0.0, 0.0),
                 albedo=(0.2, 0.2, 1.0), emission=(0.0, 0.0, 0.0),
                 emission_strength=0.0, smoothness=0.5, uvs=None,
                 tex: int = -1, normal_tex: int = -1) -> "SceneBuilder":
        """Append a triangle mesh, baking the ``pos`` translation into its
        vertices. ``uvs`` ((N, 2), v down) with ``tex`` / ``normal_tex``
        ids from ``add_texture`` enable textured shading, the albedo acting
        as a tint; without ``uvs`` the ids are dropped."""
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.uint32).reshape(-1)
        if indices.size % 3 != 0:
            raise ValueError("indices length must be a multiple of 3")
        if uvs is None:
            uvs = np.zeros((vertices.shape[0], 2), np.float32)
            tex = normal_tex = -1
        else:
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        pos = np.asarray(pos, np.float32)
        smoothness = smoothness if smoothness < 1.0 else 1.0

        tri = indices.reshape(-1, 3).astype(np.int64)
        self.tris.append({
            "v0": vertices[tri[:, 0]] + pos,
            "v1": vertices[tri[:, 1]] + pos,
            "v2": vertices[tri[:, 2]] + pos,
            "n0": normals[tri[:, 0]],
            "n1": normals[tri[:, 1]],
            "n2": normals[tri[:, 2]],
            "uv0": uvs[tri[:, 0]],
            "uv1": uvs[tri[:, 1]],
            "uv2": uvs[tri[:, 2]],
            "albedo": np.asarray(albedo, np.float32),
            "emission": np.asarray(emission, np.float32),
            "emission_strength": float(emission_strength),
            "smoothness": float(smoothness),
            "tex": int(tex),
            "ntex": int(normal_tex),
        })
        return self

    @property
    def num_tris(self) -> int:
        return sum(r["v0"].shape[0] for r in self.tris)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side AABB (min, max) over all primitives."""
        pts = []
        for c, r, *_ in self.spheres:
            c = np.asarray(c, np.float32)
            pts.append(c - r)
            pts.append(c + r)
        for rec in self.tris:
            for k in ("v0", "v1", "v2"):
                if rec[k].size:
                    pts.append(rec[k].min(0))
                    pts.append(rec[k].max(0))
        if not pts:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        pts = np.stack(pts)
        return pts.min(0), pts.max(0)

    def build(self, pad: int = PAD, sort_tris: bool = True,
              device="cuda") -> Scene:
        """Build the Scene on ``device``.

        ``sort_tris`` reorders triangles so that consecutive 64-triangle
        clusters are spatially tight, which is what the closest-hit
        kernel's cluster culling needs: by recursive median split, or by
        Morton code when ``RTT_TRI_ORDER=morton`` (the reference reads the
        same variable, so triangle ids agree). Pure renaming of primitive
        ids: images are unchanged.
        """
        S = len(self.spheres)
        SP = max(pad, -(-max(S, 1) // pad) * pad)

        def arr(shape, fill=0.0):
            return np.full(shape, fill, np.float32)

        sc, sr = arr((SP, 3)), arr((SP,))
        sa, se = arr((SP, 3)), arr((SP, 3))
        ses, ss, sv = arr((SP,)), arr((SP,)), arr((SP,))
        for i, (c, r, a, e, es, sm) in enumerate(self.spheres):
            sc[i], sr[i], sa[i], se[i], ses[i], ss[i], sv[i] = \
                c, r, a, e, es, sm, 1.0

        def cat(key, width):
            if not self.tris:
                return np.zeros((0, width), np.float32)
            return np.concatenate([np.asarray(r[key], np.float32)
                                   .reshape(-1, width) for r in self.tris])

        v0, v1, v2 = cat("v0", 3), cat("v1", 3), cat("v2", 3)
        n0, n1, n2 = cat("n0", 3), cat("n1", 3), cat("n2", 3)
        uv0, uv1, uv2 = cat("uv0", 2), cat("uv1", 2), cat("uv2", 2)
        T = v0.shape[0]

        def tiled(key):
            if not self.tris:
                return np.zeros((0, 3), np.float32)
            return np.concatenate([np.tile(r[key], (r["v0"].shape[0], 1))
                                   for r in self.tris])

        albedo, emission = tiled("albedo"), tiled("emission")

        def scalar_cat(key, dtype=np.float32):
            if not self.tris:
                return np.zeros((0,), dtype)
            return np.concatenate([
                np.full((r["v0"].shape[0],), r[key], dtype)
                for r in self.tris])

        estr = scalar_cat("emission_strength")
        smooth = scalar_cat("smoothness")
        texid = scalar_cat("tex", np.int32)
        ntexid = scalar_cat("ntex", np.int32)

        if sort_tris and T > 1:
            mode = os.environ.get("RTT_TRI_ORDER", "median")
            cen = (v0 + v1 + v2) / 3.0
            order = (_morton_order(cen) if mode == "morton"
                     else _median_split_order(cen))
            v0, v1, v2 = v0[order], v1[order], v2[order]
            n0, n1, n2 = n0[order], n1[order], n2[order]
            uv0, uv1, uv2 = uv0[order], uv1[order], uv2[order]
            albedo, emission = albedo[order], emission[order]
            estr, smooth = estr[order], smooth[order]
            texid, ntexid = texid[order], ntexid[order]

        TP = max(pad, -(-max(T, 1) // pad) * pad)

        def padded(a, width=None):
            shape = (TP,) if width is None else (TP, width)
            out = np.zeros(shape, a.dtype)
            out[:T] = a
            return out

        tvld = np.zeros((TP,), np.float32)
        tvld[:T] = 1.0
        v0p, v1p, v2p = padded(v0, 3), padded(v1, 3), padded(v2, 3)
        uv0p, uv1p, uv2p = padded(uv0, 2), padded(uv1, 2), padded(uv2, 2)

        # per-triangle tangent frame from UVs (for normal mapping):
        #   [T B] = [e1 e2] · inv([[du1, du2], [dv1, dv2]])
        e1 = v1p - v0p
        e2 = v2p - v0p
        duv1 = uv1p - uv0p
        duv2 = uv2p - uv0p
        det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det),
                     0.0)
        tan = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
        bitan = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * r[:, None]

        texid_p = np.full((TP,), -1, np.int32)
        texid_p[:T] = texid
        ntexid_p = np.full((TP,), -1, np.int32)
        ntexid_p[:T] = ntexid
        if self.textures:
            tex_stack = np.stack(self.textures).astype(np.float32)
        else:
            tex_stack = np.zeros((1, 1, 1, 3), np.float32)

        return scene_from_numpy(dict(
            sphere_center=sc, sphere_radius=sr, sphere_albedo=sa,
            sphere_emission=se, sphere_emission_strength=ses,
            sphere_smoothness=ss, sphere_valid=sv,
            tri_v0=v0p, tri_v1=v1p, tri_v2=v2p,
            tri_n0=padded(n0, 3), tri_n1=padded(n1, 3), tri_n2=padded(n2, 3),
            tri_albedo=padded(albedo, 3), tri_emission=padded(emission, 3),
            tri_emission_strength=padded(estr),
            tri_smoothness=padded(smooth), tri_valid=tvld,
            tri_uv0=uv0p, tri_uv1=uv1p, tri_uv2=uv2p,
            tri_tan=tan.astype(np.float32),
            tri_bitan=bitan.astype(np.float32),
            tri_tex=texid_p, tri_ntex=ntexid_p, textures=tex_stack,
            num_spheres=S, num_tris=T, num_textures=len(self.textures),
            num_normal_maps=int((ntexid_p >= 0).sum()),
        ), device)


def _median_split_order(centroids: np.ndarray, leaf: int = 64) -> np.ndarray:
    """Recursive widest-axis median-split ordering of triangle centroids.

    Consecutive ``leaf``-sized chunks of the result are spatially tight
    clusters. Splits land on multiples of ``leaf`` nearest the median, so
    every chunk but the last holds exactly ``leaf`` triangles (the
    closest-hit kernel's cluster size)."""
    c = np.asarray(centroids, np.float64)
    n = c.shape[0]
    out = np.empty(n, np.int64)
    pos = 0
    # explicit stack, left-first DFS = final in-order layout
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
        # push right first so the left half pops (and lands) first
        stack.append(idx[part[m:]])
        stack.append(idx[part[:m]])
    return out


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Stable argsort of triangle centroids by 30-bit Morton code (10 bits
    per axis over the centroids' AABB)."""
    centroids = np.asarray(centroids, np.float64)
    lo, hi = centroids.min(0), centroids.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))
    return np.argsort(code, kind="stable")


# ---------------------------------------------------------------------------
# Built-in scenes. Each returns (Scene, Camera); the caller supplies aspect.
# ---------------------------------------------------------------------------

WHITE = (1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0)


def scene_balls(aspect: float = 1.0, pad: int = PAD,
                device="cuda") -> Tuple[Scene, Camera]:
    """Default scene, id 0."""
    cam = Camera(origin=(3.089, 1.53, -3.0), look_at=(-2.0, -1.0, 2.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.0, focus_dist=0.1)
    b = SceneBuilder()
    b.add_sphere((-3.64, -0.42, 0.8028), 0.75, WHITE, BLACK, 0.0, 0.7)
    b.add_sphere((-2.54, -0.72, 0.5), 0.6, (1.0, 0.0, 0.0), BLACK, 0.0, 0.5)
    b.add_sphere((-1.27, -0.72, 1.0), 0.5, (0.0, 1.0, 0.0), WHITE, 0.0, 0.2)
    b.add_sphere((-0.5, -0.9, 1.55), 0.35, (0.0, 0.0, 1.0), WHITE, 0.0, 0.0)
    # floor
    b.add_sphere((-3.46, -15.88, 2.76), 15.0, (0.5, 0.0, 0.8), WHITE, 0.0, 0.0)
    # light object
    b.add_sphere((-7.44, -0.72, 20.0), 15.0, (0.1, 0.1, 0.1), WHITE, 2.0, 0.0)
    return b.build(pad, device=device), cam


def scene_random_balls(aspect: float = 1.0, seed: int = 0, pad: int = PAD,
                       device="cuda") -> Tuple[Scene, Camera]:
    """Random-balls scene, id 1, laid out from ``seed`` with numpy."""
    cam = Camera(origin=(10.5, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.1, focus_dist=10.0)
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), BLACK, 0.0, 0.0)
    for a in range(-11, 11):
        for c in range(-11, 11):
            mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random())
            if np.linalg.norm(np.array(center)
                              - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if mat < 0.8:
                albedo = tuple(rng.random(3))
                b.add_sphere(center, 0.2, albedo, BLACK, 0.0, 0.0)
            elif mat < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                fuzz = rng.uniform(0.0, 0.5)
                b.add_sphere(center, 0.2, albedo, BLACK, 0.0, fuzz)
            else:
                b.add_sphere(center, 0.2, WHITE, BLACK, 0.0, -1.0)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, WHITE, BLACK, 0.0, -1.0)
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), BLACK, 0.0, 0.0)
    b.add_sphere((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), BLACK, 0.0, 0.9)
    return b.build(pad, device=device), cam


# Room geometry: 8 cube corners (+/-3) and a 2x2 light quad at y=1; the odd
# non-unit normals are the reference's.
_ROOM_VERTS = np.array([
    [3, -3, -3], [3, -3, 3], [-3, -3, 3], [-3, -3, -3],
    [3, 3, -3], [3, 3, 3], [-3, 3, 3], [-3, 3, -3],
    [1, 1, -1], [1, 1, 1], [-1, 1, 1], [-1, 1, -1],
], np.float32)
_ROOM_NORMALS = np.array([
    [2, -3, -3], [4, -3, 0], [3, -4, 2], [3, -4, 2],
    [3, -4, 2], [3, -4, 2], [3, -4, 2], [3, -4, 2],
    [3, -4, 2], [3, -4, 2], [3, -4, 2], [3, -4, 2],
], np.float32)
_ROOM_INDICES = np.array([
    3, 2, 1, 3, 1, 0,
    7, 0, 4, 7, 3, 0,
    7, 6, 2, 7, 2, 3,
    2, 6, 5, 2, 5, 1,
    1, 5, 4, 1, 4, 0,
    5, 6, 7, 5, 7, 4,
    9, 10, 11, 9, 11, 8,
], np.uint32)
_ROOM_WALL_COLORS = [
    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
    (0.5, 0.5, 0.0), (0.0, 0.5, 0.5), (1.0, 1.0, 1.0),
]


def scene_room(aspect: float = 1.0, pad: int = PAD,
               device="cuda") -> Tuple[Scene, Camera]:
    """Cube room with an emissive ceiling quad, id 2."""
    cam = Camera(origin=(-7.0, 0.0, 0.0), look_at=(1.0, 0.0, 0.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.0, focus_dist=0.1)
    b = SceneBuilder()
    b.add_sphere((4.0, 0.0, 1.7), 1.2, WHITE, BLACK, 0.0, 1.0)
    b.add_sphere((4.0, 0.0, -1.7), 1.2, WHITE, BLACK, 0.0, 0.5)
    for wall in range(6):
        b.add_mesh(_ROOM_VERTS, _ROOM_NORMALS,
                   _ROOM_INDICES[wall * 6:(wall + 1) * 6],
                   pos=(3.0, 0.0, 0.0), albedo=_ROOM_WALL_COLORS[wall],
                   emission=WHITE, emission_strength=0.0, smoothness=0.5)
    b.add_mesh(_ROOM_VERTS, _ROOM_NORMALS, _ROOM_INDICES[36:42],
               pos=(3.0, 1.9, 0.0), albedo=WHITE,
               emission=WHITE, emission_strength=10.5, smoothness=0.0)
    return b.build(pad, device=device), cam


def scene_metal(aspect: float = 1.0, pad: int = PAD,
                device="cuda") -> Tuple[Scene, Camera]:
    """Three spheres on a ground sphere, id 3."""
    cam = Camera(origin=(0.0, 0.0, 3.0), look_at=(0.0, 0.0, -1.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.0, focus_dist=0.1)
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0), BLACK, 0.0, 0.0)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3), BLACK, 0.0, 0.0)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, (0.8, 0.8, 0.8), BLACK, 0.0, -1.0)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), BLACK, 0.0, 0.15)
    return b.build(pad, device=device), cam


BUILTIN_SCENES = {
    "balls": scene_balls,
    "random_balls": scene_random_balls,
    "room": scene_room,
    "metal": scene_metal,
}
SCENE_IDS = {0: "balls", 1: "random_balls", 2: "room", 3: "metal"}


def builtin_scene(name_or_id, aspect: float = 1.0, pad: int = PAD,
                  **kw) -> Tuple[Scene, Camera]:
    if isinstance(name_or_id, int):
        name_or_id = SCENE_IDS[name_or_id]
    return BUILTIN_SCENES[name_or_id](aspect=aspect, pad=pad, **kw)
