"""OBJ / glTF / GLB model loaders.

Port of ``ray_tracer_tpu.io.loaders``: the upstream asset pipeline
(src/core/resource.rs) without the tobj/gltf crates, numpy on the host.
Semantics kept:

  * extension dispatch .obj/.gltf/.glb (resource.rs:27-45),
  * OBJ is triangulated with single-index vertex dedup — one vertex per
    unique (position, normal) pair (tobj LoadOptions at resource.rs:60-63),
  * each loaded primitive appends one mesh record placed at
    x = 3 * mesh_index with the hardcoded material color (0.2, 0.2, 1.0),
    specular 0.5 (resource.rs:78-84,163-175,252-264) — overridable here,
  * .gltf walks scenes→nodes→mesh primitives, .glb walks meshes directly,
    node transforms are NOT applied (mirroring resource.rs:137-147,229-232),
  * missing indices → sequential 0..N (resource.rs:156-159).

Deviations (docs/DEVIATIONS.md): D12 — the reference .gltf path scales
positions by the running mesh count (resource.rs:180, SURVEY quirk Q7); we
implement the intent (no scaling). D11 — OBJ files without normals get
computed area-weighted vertex normals instead of crashing.

Images: PNG (8-bit RGB and RGBA) is decoded by the port's own codec
(``io/png.py``), so material textures load without Pillow. Other formats
go through Pillow where it is installed; where it is not, such an image
takes the reference's path for an image that fails to decode: a warning,
and the mesh renders untextured.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .png import SIGNATURE, decode_png

logger = logging.getLogger("ray_tracer_tpu_torch.io")


def _decode_image(raw: bytes) -> np.ndarray:
    """Encoded image bytes → (H, W, 3) uint8: PNG by the port's codec,
    anything else (or a PNG it does not take) by Pillow, which raises
    ImportError where it is not installed."""
    if raw[:8] == SIGNATURE:
        try:
            return decode_png(raw)[..., :3]
        except ValueError:
            pass    # a PNG the codec does not take: Pillow may
    import io as _io

    from PIL import Image
    return np.asarray(Image.open(_io.BytesIO(raw)).convert("RGB"))


@dataclasses.dataclass
class MeshData:
    """One loaded primitive: positions/normals (N, 3) f32, indices (M,) u32,
    optional uvs (N, 2) (v-down convention) and a material dict with keys
    ``kd`` (3,), ``diffuse_image``/``normal_image`` (H, W, 3|4 arrays)."""

    name: str
    positions: np.ndarray
    normals: np.ndarray
    indices: np.ndarray
    uvs: Optional[np.ndarray] = None
    material: Optional[dict] = None

    @property
    def num_triangles(self) -> int:
        return self.indices.size // 3


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def _load_mtl(path: str) -> Dict[str, dict]:
    """Minimal MTL parser: Kd tint + map_Kd / map_Bump image paths
    (the keys the reference's assets use — assets/cube.mtl)."""
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    base = os.path.dirname(path)

    def load_image(fname):
        fp = os.path.join(base, fname)
        if not os.path.exists(fp):
            return None
        with open(fp, "rb") as f:
            raw = f.read()
        try:
            return _decode_image(raw)
        except ImportError:
            logger.warning("no decoder for %s without Pillow; rendering "
                           "untextured", fp)
            return None

    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                tag = parts[0].lower()
                if tag == "newmtl":
                    cur = mats.setdefault(parts[1], {})
                elif cur is None:
                    continue
                elif tag == "kd":
                    cur["kd"] = tuple(float(x) for x in parts[1:4])
                elif tag == "map_kd":
                    cur["diffuse_image"] = load_image(parts[-1])
                elif tag in ("map_bump", "bump", "norm", "map_norm"):
                    cur["normal_image"] = load_image(parts[-1])
    except OSError:
        pass
    return mats


def load_obj(path: str) -> List[MeshData]:
    """Parse a Wavefront OBJ into per-object MeshData (triangulated,
    single-indexed, with UVs + MTL material when present).

    Uses the C++ native parser (native/rtt_native.cpp) when built — text
    parsing dominates host-side load time for large models — and falls back
    to this pure-Python implementation otherwise. Both produce identical
    output (pinned by tests/test_torch_loaders.py)."""
    from ..utils.native import parse_obj as _native_parse
    native = _native_parse(path)
    if native is not None:
        materials: Dict[str, dict] = {}
        mtllib = next((o["mtllib"] for o in native if o["mtllib"]), "")
        if mtllib:
            materials = _load_mtl(os.path.join(os.path.dirname(path), mtllib))
        return [
            MeshData(o["name"] or "default", o["positions"], o["normals"],
                     o["indices"], uvs=o["uvs"],
                     material=materials.get(o["material"]))
            for o in native]

    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    objects: List[Tuple[str, str, list]] = []
    faces: list = []
    name = "default"
    materials: Dict[str, dict] = {}
    cur_mtl = ""

    def flush():
        nonlocal faces, name
        if faces:
            objects.append((name, cur_mtl, faces))
            faces = []

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                # OBJ vt is bottom-left origin; internal convention is
                # v-down (texture.py) -> flip v
                u, v = float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0
                uvs.append((u, 1.0 - v))
            elif tag == "mtllib":
                materials.update(_load_mtl(
                    os.path.join(os.path.dirname(path), parts[1])))
            elif tag == "usemtl":
                cur_mtl = parts[1] if len(parts) > 1 else ""
            elif tag in ("o", "g"):
                flush()
                name = parts[1] if len(parts) > 1 else "unnamed"
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = None
                    if len(fields) >= 2 and fields[1]:
                        t = int(fields[1])
                        ti = t - 1 if t > 0 else len(uvs) + t
                    ni = None
                    if len(fields) >= 3 and fields[2]:
                        n = int(fields[2])
                        ni = n - 1 if n > 0 else len(normals) + n
                    corners.append((vi, ti, ni))
                # skip malformed faces (out-of-range position index) like
                # the native parser instead of crashing at gather time
                if any(c[0] < 0 or c[0] >= len(positions) for c in corners):
                    logger.warning("skipping malformed OBJ face in %s: %s",
                                   path, line)
                    continue
                # fan triangulation (tobj `triangulate: true`)
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])
    flush()

    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm_arr = (np.asarray(normals, np.float32).reshape(-1, 3)
               if normals else np.zeros((0, 3), np.float32))
    uv_arr = (np.asarray(uvs, np.float32).reshape(-1, 2)
              if uvs else np.zeros((0, 2), np.float32))

    out = []
    for obj_name, mtl_name, obj_faces in objects:
        remap: Dict[tuple, int] = {}
        v_out: List[int] = []
        t_out: List[Optional[int]] = []
        n_out: List[Optional[int]] = []
        idx_out: List[int] = []
        for tri in obj_faces:
            for key in tri:
                if key not in remap:
                    remap[key] = len(v_out)
                    v_out.append(key[0])
                    t_out.append(key[1])
                    n_out.append(key[2])
                idx_out.append(remap[key])
        p = pos_arr[np.asarray(v_out, np.int64)]
        if all(n is not None for n in n_out) and nrm_arr.size:
            n = nrm_arr[np.asarray(n_out, np.int64)]
        else:
            n = _smooth_normals(p, np.asarray(idx_out, np.uint32))
        if all(t is not None for t in t_out) and uv_arr.size:
            uv = uv_arr[np.asarray(t_out, np.int64)]
        else:
            uv = None
        out.append(MeshData(obj_name, p, n.astype(np.float32),
                            np.asarray(idx_out, np.uint32), uvs=uv,
                            material=materials.get(mtl_name)))
    return out


def _smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for normal-less OBJ files (D11)."""
    n = np.zeros_like(positions)
    tri = indices.reshape(-1, 3).astype(np.int64)
    v0, v1, v2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # length ∝ 2*area
    for k in range(3):
        np.add.at(n, tri[:, k], fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(lens, 1e-12)


# ---------------------------------------------------------------------------
# glTF 2.0 / GLB
# ---------------------------------------------------------------------------

_COMPONENT = {
    5120: ("b", 1), 5121: ("B", 1), 5122: ("h", 2),
    5123: ("H", 2), 5125: ("I", 4), 5126: ("f", 4),
}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def _read_accessor(gltf: dict, buffers: List[bytes], accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    if "sparse" in acc:
        raise NotImplementedError("sparse accessors not supported")
    fmt, csize = _COMPONENT[acc["componentType"]]
    ncomp = _NCOMP[acc["type"]]
    count = acc["count"]
    bv = gltf["bufferViews"][acc["bufferView"]]
    data = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", csize * ncomp)
    dtype = np.dtype(fmt)
    if stride == csize * ncomp:
        arr = np.frombuffer(data, dtype, count * ncomp, start).copy()
    else:
        arr = np.empty((count, ncomp), dtype)
        for i in range(count):
            off = start + i * stride
            arr[i] = np.frombuffer(data, dtype, ncomp, off)
    return arr.reshape(count, ncomp) if ncomp > 1 else arr.reshape(count)


def _load_gltf_buffers(gltf: dict, base_dir: str, blob: Optional[bytes]) -> List[bytes]:
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if blob is None:
                raise ValueError("GLB buffer without blob")
            buffers.append(blob)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _load_gltf_image(gltf: dict, buffers: List[bytes], base_dir: str,
                     image_idx: int) -> Optional[np.ndarray]:
    """Decode a glTF image (bufferView, data URI, or external file); None,
    with a warning, where it cannot be decoded."""
    img = gltf.get("images", [])[image_idx]
    try:
        if "bufferView" in img:
            bv = gltf["bufferViews"][img["bufferView"]]
            data = buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0)
            return _decode_image(data[start:start + bv["byteLength"]])
        uri = img.get("uri", "")
        if uri.startswith("data:"):
            return _decode_image(base64.b64decode(uri.split(",", 1)[1]))
        with open(os.path.join(base_dir, uri), "rb") as f:
            return _decode_image(f.read())
    except Exception as e:   # the reference's catch-all: render untextured
        logger.warning("failed to decode glTF image %d (%s); "
                       "rendering untextured", image_idx, e)
        return None


def _gltf_material(gltf: dict, buffers: List[bytes], base_dir: str,
                   mat_idx: Optional[int],
                   img_cache: Optional[dict] = None) -> Optional[dict]:
    if mat_idx is None:
        return None
    if img_cache is None:
        img_cache = {}
    mat = gltf.get("materials", [])[mat_idx]
    out: dict = {}
    pbr = mat.get("pbrMetallicRoughness", {})
    if "baseColorFactor" in pbr:
        out["kd"] = tuple(pbr["baseColorFactor"][:3])
    def tex_image(tex_ref):
        tex = gltf.get("textures", [])[tex_ref["index"]]
        if "source" not in tex:
            return None
        # decode each glTF image ONCE per file (keyed by image index);
        # primitives sharing a texture then share the ndarray, and
        # load_model's id()-keyed register cache dedups the device copy
        src = tex["source"]
        if src not in img_cache:
            img_cache[src] = _load_gltf_image(gltf, buffers, base_dir, src)
        return img_cache[src]
    if "baseColorTexture" in pbr:
        out["diffuse_image"] = tex_image(pbr["baseColorTexture"])
    if "normalTexture" in mat:
        out["normal_image"] = tex_image(mat["normalTexture"])
    return out or None


def _primitives_to_meshes(gltf: dict, buffers: List[bytes],
                          mesh_indices: Sequence[int],
                          base_dir: str = "") -> List[MeshData]:
    out = []
    img_cache: dict = {}
    for mi in mesh_indices:
        mesh = gltf["meshes"][mi]
        mesh_name = mesh.get("name", f"mesh{mi}")
        for pi, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"])
                uv = np.asarray(uv, np.float32).reshape(-1, 2)
            else:
                uv = None
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"]).astype(np.uint32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.uint32)
            if nrm is None:
                nrm = _smooth_normals(pos, idx)
            material = _gltf_material(gltf, buffers, base_dir,
                                      prim.get("material"), img_cache)
            out.append(MeshData(f"{mesh_name}/{pi}", pos, nrm, idx,
                                uvs=uv, material=material))
    return out


def load_gltf(path: str) -> List[MeshData]:
    """JSON .gltf with external/data-URI buffers. Walks scenes→nodes like
    the reference (resource.rs:137-147); node transforms ignored."""
    with open(path, "r", encoding="utf-8") as f:
        gltf = json.load(f)
    buffers = _load_gltf_buffers(gltf, os.path.dirname(path), None)
    mesh_indices = []
    for scene in gltf.get("scenes", []):
        for node_idx in scene.get("nodes", []):
            node = gltf["nodes"][node_idx]
            if "mesh" in node:
                mesh_indices.append(node["mesh"])
    return _primitives_to_meshes(gltf, buffers, mesh_indices,
                                 os.path.dirname(path))


def load_glb(path: str) -> List[MeshData]:
    """Binary .glb with embedded blob. Walks all meshes like the reference
    (resource.rs:229-232)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    gltf_json, blob = None, None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8: off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN'
            blob = bytes(chunk)
        # chunks are 4-byte aligned (GLB spec); skip any padding
        off += 8 + clen
        if clen % 4:
            off += 4 - clen % 4
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    buffers = _load_gltf_buffers(gltf_json, os.path.dirname(path), blob)
    return _primitives_to_meshes(gltf_json, buffers,
                                 range(len(gltf_json.get("meshes", []))),
                                 os.path.dirname(path))


# ---------------------------------------------------------------------------
# Dispatch + SceneBuilder integration
# ---------------------------------------------------------------------------

def load_meshes(path: str) -> List[MeshData]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".gltf":
        return load_gltf(path)
    if ext == ".glb":
        return load_glb(path)
    raise ValueError(f"Unsupported model format: {ext}")


def load_model(path: str, builder, *, albedo=(0.2, 0.2, 1.0),
               emission=(0.0, 0.0, 0.0), emission_strength=0.0,
               smoothness=0.5, placement: str = "reference",
               pos=(0.0, 0.0, 0.0), scale: float = 1.0,
               use_textures: bool = True):
    """Load a model file into a SceneBuilder.

    ``placement="reference"`` reproduces resource.rs:78-84: primitive i goes
    to x = 3 * (existing_meshes + i). ``placement="origin"`` puts everything
    at ``pos``. Returns the builder.
    """
    meshes = load_meshes(path)
    base = getattr(builder, "_loaded_mesh_count", 0)
    tex_cache: dict = {}

    def register(img, srgb):
        if img is None:
            return -1
        key = id(img)
        if key not in tex_cache:
            tex_cache[key] = builder.add_texture(img, srgb=srgb)
        return tex_cache[key]

    for i, m in enumerate(meshes):
        if placement == "reference":
            p = (3.0 * (base + i), 0.0, 0.0)
        else:
            p = tuple(pos)
        mat = m.material or {}
        tex = ntex = -1
        mesh_albedo = albedo
        if use_textures and m.uvs is not None:
            tex = register(mat.get("diffuse_image"), srgb=True)
            ntex = register(mat.get("normal_image"), srgb=False)
            if tex >= 0:
                # texture replaces the hardcoded loader color; Kd tints
                mesh_albedo = mat.get("kd", (1.0, 1.0, 1.0))
        builder.add_mesh(m.positions * scale, m.normals, m.indices, pos=p,
                         albedo=mesh_albedo, emission=emission,
                         emission_strength=emission_strength,
                         smoothness=smoothness, uvs=m.uvs, tex=tex,
                         normal_tex=ntex)
    builder._loaded_mesh_count = base + len(meshes)
    return builder
