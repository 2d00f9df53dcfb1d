"""ctypes bridge to the C++ host components (``native/rtt_native.cpp``).

The port's own bridge (the reference's, ``ray_tracer_tpu.utils.native``,
cannot be imported without jax): the same functions on the same source.
At first use the library is compiled with g++ and the flags of
``native/Makefile`` into ``build/ray_tracer_tpu_torch/``, keyed by the
source (``utils/build.build_host``). Where it cannot be built or loaded
(no compiler), every entry point returns None and the callers run the
pure-Python implementations, which stay the oracle; ``available()`` says
which of the two runs.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import List, Optional

import numpy as np

from . import build

logger = logging.getLogger("ray_tracer_tpu_torch.native")

SOURCE = build.REPO_DIR / "native" / "rtt_native.cpp"

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None (logged) where it
    cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build.build_host(SOURCE)))
    except (OSError, RuntimeError) as e:
        logger.warning("native library unavailable (%s); using the "
                       "pure-Python loaders", e)
        return None
    lib.rtt_obj_load.restype = ctypes.c_void_p
    lib.rtt_obj_load.argtypes = [ctypes.c_char_p]
    lib.rtt_obj_num_objects.restype = ctypes.c_int
    lib.rtt_obj_num_objects.argtypes = [ctypes.c_void_p]
    lib.rtt_obj_counts.restype = None
    lib.rtt_obj_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _I64P, _I64P,
        ctypes.POINTER(ctypes.c_int)]
    lib.rtt_obj_strings.restype = None
    lib.rtt_obj_strings.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int]
    lib.rtt_obj_fill.restype = None
    lib.rtt_obj_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _F32P, _F32P, _F32P,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.rtt_obj_free.restype = None
    lib.rtt_obj_free.argtypes = [ctypes.c_void_p]
    lib.rtt_morton_order.restype = None
    lib.rtt_morton_order.argtypes = [_F32P, ctypes.c_int64, _I64P]
    return lib


def available() -> bool:
    """True where the native library runs, False where the pure-Python
    implementations do."""
    return _lib() is not None


def morton_order(centroids: np.ndarray) -> Optional[np.ndarray]:
    """Stable Morton argsort of (N, 3) centroids (10 bits an axis over
    their box); None if the library is absent."""
    lib = _lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, np.float32).reshape(-1, 3)
    out = np.empty(c.shape[0], np.int64)
    lib.rtt_morton_order(c.ctypes.data_as(_F32P), c.shape[0],
                         out.ctypes.data_as(_I64P))
    return out


def parse_obj(path: str) -> Optional[List[dict]]:
    """Fast OBJ parse → list of dicts (name, material, mtllib, positions,
    normals, uvs or None, indices); None if the library is absent or the
    file cannot be read."""
    lib = _lib()
    if lib is None:
        return None
    h = lib.rtt_obj_load(str(path).encode())
    if not h:
        return None
    try:
        out = []
        for i in range(lib.rtt_obj_num_objects(h)):
            nv, ni, has_uv = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
            lib.rtt_obj_counts(h, i, ctypes.byref(nv), ctypes.byref(ni),
                               ctypes.byref(has_uv))
            name, material, mtllib = (ctypes.create_string_buffer(256)
                                      for _ in range(3))
            lib.rtt_obj_strings(h, i, name, material, mtllib, 256)
            pos = np.empty((nv.value, 3), np.float32)
            nrm = np.empty((nv.value, 3), np.float32)
            uv = np.empty((nv.value, 2), np.float32)
            idx = np.empty(ni.value, np.uint32)
            lib.rtt_obj_fill(h, i, pos.ctypes.data_as(_F32P),
                             nrm.ctypes.data_as(_F32P),
                             uv.ctypes.data_as(_F32P),
                             idx.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_uint32)))
            out.append(dict(
                name=name.value.decode(errors="replace"),
                material=material.value.decode(errors="replace"),
                mtllib=mtllib.value.decode(errors="replace"),
                positions=pos, normals=nrm,
                uvs=uv if has_uv.value else None, indices=idx))
        return out
    finally:
        lib.rtt_obj_free(h)
