"""IO: model loaders (OBJ/glTF/GLB), the PNG codec and image writers."""

from .image import linear_to_srgb, to_uint8, write_npy, write_png
from .loaders import (MeshData, load_glb, load_gltf, load_meshes, load_model,
                      load_obj)

__all__ = [
    "linear_to_srgb", "to_uint8", "write_png", "write_npy",
    "MeshData", "load_obj", "load_gltf", "load_glb", "load_meshes",
    "load_model",
]
