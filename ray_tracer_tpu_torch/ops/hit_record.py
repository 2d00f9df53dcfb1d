"""Winner-recompute kernels (CUDA C++, ``csrc/hit_record.cu``) and their
wrappers: each ray's hit record from its winner's untextured merged-table
row, and the record's vector-Jacobian product.

  * ``hit_record(rows, o, d, prim_id, miss, padded_spheres)`` — t, point,
    normal, albedo, emission, emission strength, smoothness and the hit
    flag, bit-equal to ``intersect.hit_attributes_from_rows`` on the card.
  * ``hit_record_vjp(...)`` — the cotangents of the rows, o and d from
    those of the seven float outputs, as autograd computes them through
    ``hit_attributes_from_rows``.

``intersect.fused_intersect`` takes them where ``takes(rows)`` holds
(26-column rows on a CUDA device), through ``intersect._HitRecord`` where
autograd needs the gradient; textured rows and CPU tensors keep the plain
version, which stays the oracle the tests compare against. The wrappers
take CUDA tensors only: anything else raises. Each counts its launches in
``<wrapper>.launches``.

Why CUDA C++ and not Triton: the forward must round every product and sum
as the plain version's elementwise ops do, and Triton contracts
multiply-adds.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

COLS = 26  # untextured merged-table row (intersect.merged_width(False))
_INT32_LIMIT = 2 ** 31
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"rtt_hit_record": [_P] * 5 + [_I, _I] + [_P] * 8 + [_P],
              "rtt_hit_record_vjp": [_P] * 5 + [_I, _I] + [_P] * 10 + [_P]}


def takes(rows) -> bool:
    """Whether the kernels serve these winner rows: untextured (26
    columns) and on a CUDA device."""
    return rows.device.type == "cuda" and rows.shape[0] == COLS


def _inputs(rows, o, d, prim_id, miss):
    """The kernels' inputs checked and contiguous → (rows, o, d, prim_id,
    miss, R). Raises on anything the kernels do not take."""
    if rows.device.type != "cuda":
        raise ValueError(f"no hit-record kernel for device {rows.device}")
    if rows.dim() != 2 or rows.shape[0] != COLS:
        raise ValueError(f"rows must be ({COLS}, R), got {tuple(rows.shape)}")
    R = rows.shape[1]
    for name, x, shape, dtype in (
            ("rows", rows, (COLS, R), torch.float32),
            ("o", o, (R, 3), torch.float32), ("d", d, (R, 3), torch.float32),
            ("prim_id", prim_id, (R,), torch.int32),
            ("miss", miss, (R,), torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != rows.device:
            raise ValueError(f"{name} is on {x.device}, rows on "
                             f"{rows.device}")
    if COLS * R >= _INT32_LIMIT:
        raise ValueError("too many rays for 32-bit indexing")
    return (*(x.detach().contiguous() for x in (rows, o, d, prim_id, miss)),
            R)


def hit_record(rows, o, d, prim_id, miss, padded_spheres: int):
    """The hit record of each lane → (t (R,), point (R, 3), normal (R, 3),
    albedo (R, 3), emission (R, 3), emission_strength (R,), smoothness
    (R,), hit (R,) bool). ``rows`` (26, R) f32 are the winners' merged-table
    rows, ``prim_id`` (R,) int32 their ids (spheres below
    ``padded_spheres``), ``miss`` (R,) bool."""
    rows, o, d, prim_id, miss, R = _inputs(rows, o, d, prim_id, miss)
    dev = rows.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = (empty(R), empty(R, 3), empty(R, 3), empty(R, 3), empty(R, 3),
           empty(R), empty(R), empty(R, dtype=torch.bool))
    if R == 0:
        return out
    build.launch(build.library("hit_record", SIGNATURES), "rtt_hit_record",
                 "hit-record", dev, rows.data_ptr(), o.data_ptr(),
                 d.data_ptr(), prim_id.data_ptr(), miss.data_ptr(), R,
                 int(padded_spheres), *(x.data_ptr() for x in out))
    hit_record.launches += 1
    return out


def hit_record_vjp(rows, o, d, prim_id, miss, padded_spheres: int,
                   cotangents, want):
    """The vector-Jacobian product of ``hit_record`` → (g_rows (26, R),
    g_o (R, 3), g_d (R, 3)), each None where ``want`` (three bools: rows,
    o, d) is False. ``cotangents`` holds the seven float outputs'
    cotangents in ``hit_record``'s order, each a tensor of its output's
    shape or None (zero)."""
    rows, o, d, prim_id, miss, R = _inputs(rows, o, d, prim_id, miss)
    dev = rows.device
    cots = [None if g is None else g.contiguous() for g in cotangents]
    want_rows, want_o, want_d = want
    g_rows = (torch.empty((COLS, R), dtype=torch.float32, device=dev)
              if want_rows else None)
    g_o, g_d = (torch.empty((R, 3), dtype=torch.float32, device=dev)
                if w else None for w in (want_o, want_d))
    if R == 0:
        return g_rows, g_o, g_d

    def ptr(x):
        return None if x is None else x.data_ptr()

    build.launch(build.library("hit_record", SIGNATURES),
                 "rtt_hit_record_vjp", "hit-record VJP", dev, rows.data_ptr(),
                 o.data_ptr(), d.data_ptr(), prim_id.data_ptr(),
                 miss.data_ptr(), R, int(padded_spheres), *map(ptr, cots),
                 ptr(g_rows), ptr(g_o), ptr(g_d))
    hit_record_vjp.launches += 1
    return g_rows, g_o, g_d


hit_record.launches = 0
hit_record_vjp.launches = 0
