"""Scatter-add kernel (CUDA C++, ``csrc/scatter_rows.cu``) with its plain
PyTorch version and its wrappers: the backward of the winner-row extraction.

Port of ``ray_tracer_tpu/ops/pallas_intersect.py``'s one-hot scatters:
``_make_scatter_soa_kernel`` (``scatter_rows_soa_pallas``, cotangents in
SoA orientation (W, R)) and ``_make_scatter_kernel``
(``scatter_rows_pallas``, row-major (R, W)). Both compute
``zeros((n_rows, W)).at[ids].add(g)`` and drop ids outside
``[0, n_rows)``. One CUDA kernel serves both through the strides of g.

  * ``scatter_rows_soa(ids, g_soa, n_rows)`` — the wrapper on the training
    path (once per bounce, from ``ops/intersect._WinnerRows.backward``).
  * ``scatter_rows(ids, g_rows, n_rows)`` — the row-major form, the same
    kernel with the other strides.
  * ``scatter_rows_soa_reference`` / ``scatter_rows_reference`` — the plain
    versions (``index_add_``), used by the tests and for CPU tensors only.

CUDA tensors launch the kernel (built at first use); CPU tensors take the
plain version; anything else, or input the kernel does not take, raises.
Each wrapper counts its launches in ``<wrapper>.launches``.

Why CUDA C++ and not Triton: a scatter-add is a reduction, which Triton
would also express, but the port already has one build route for its
kernels (nvcc into a plain C library loaded with ctypes,
``utils/build.py``), and one route keeps one way to build, bind and test.

No streaming fallback: the reference scatters through XLA for scenes
whose table exceeds the TPU kernel's VMEM budget (``_use_blocked``). This
kernel adds straight into device memory at any table size.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

_INT32_LIMIT = 2 ** 31
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"rtt_scatter_rows": [_P, _P, _I, _I, _LL, _LL, _I, _P, _P, _P]}


def scatter_rows_reference(ids, g_rows, n_rows: int):
    """Plain version, row-major: (n_rows, W) = zeros.index_add_(ids, g_rows)
    over the lanes with 0 <= id < n_rows."""
    keep = (ids >= 0) & (ids < n_rows)
    out = torch.zeros((n_rows, g_rows.shape[1]), dtype=g_rows.dtype,
                      device=g_rows.device)
    return out.index_add_(0, ids[keep].long(), g_rows[keep])


def scatter_rows_soa_reference(ids, g_soa, n_rows: int):
    """Plain version, SoA: ``g_soa`` (W, R)."""
    return scatter_rows_reference(ids, g_soa.T, n_rows)


def _check_inputs(ids, g, n_rows: int, R: int, W: int):
    """What the kernel takes, checked on every device so that the CPU
    tests hold callers to it too."""
    if ids.dim() != 1 or ids.dtype != torch.int32 or ids.shape[0] != R:
        raise ValueError(f"ids must be ({R},) int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if g.dtype != torch.float32:
        raise ValueError(f"cotangents must be float32, got {g.dtype}")
    if ids.device != g.device:
        raise ValueError(f"ids are on {ids.device}, cotangents on {g.device}")
    if not 0 < W <= 65535:
        raise ValueError(f"row width {W} out of range")
    if n_rows < 0 or max(n_rows, R) * W >= _INT32_LIMIT:
        raise ValueError("too many rows or rays for 32-bit indexing")


def _launch(ids, g, n_rows: int, R: int, W: int, col_stride: int,
            ray_stride: int):
    """Launch the kernel on the current stream → (n_rows, W) f32. It sums
    into a float64 table of the same shape (scratch, allocated here) and
    rounds that into the output."""
    if g.device.type != "cuda":
        raise ValueError(f"no scatter-add kernel for device {g.device}")
    if not (g.is_contiguous() and ids.is_contiguous()):
        raise ValueError("the kernel takes contiguous ids and cotangents")
    dev = g.device
    out = torch.empty((n_rows, W), dtype=torch.float32, device=dev)
    if R == 0:
        return out.zero_()
    wide = torch.empty((n_rows, W), dtype=torch.float64, device=dev)
    build.launch(build.library("scatter_rows", SIGNATURES), "rtt_scatter_rows",
                 "scatter-add", dev, ids.data_ptr(), g.data_ptr(), R, W,
                 col_stride, ray_stride, n_rows, wide.data_ptr(),
                 out.data_ptr())
    return out


def _shape(g, name: str):
    if g.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(g.shape)}")
    return g.shape


def scatter_rows_soa(ids, g_soa, n_rows: int):
    """``zeros((n_rows, W)).index_add_(0, ids, g_soa.T)`` with ids outside
    ``[0, n_rows)`` dropped. ``ids`` (R,) int32, ``g_soa`` (W, R) f32."""
    W, R = _shape(g_soa, "g_soa (W, R)")
    _check_inputs(ids, g_soa, n_rows, R, W)
    if g_soa.device.type == "cpu":
        return scatter_rows_soa_reference(ids, g_soa, n_rows)
    out = _launch(ids, g_soa, n_rows, R, W, col_stride=R, ray_stride=1)
    if R:
        scatter_rows_soa.launches += 1
    return out


def scatter_rows(ids, g_rows, n_rows: int):
    """Row-major form: ``g_rows`` (R, W) f32; the same kernel as
    ``scatter_rows_soa`` with the strides swapped."""
    R, W = _shape(g_rows, "g_rows (R, W)")
    _check_inputs(ids, g_rows, n_rows, R, W)
    if g_rows.device.type == "cpu":
        return scatter_rows_reference(ids, g_rows, n_rows)
    out = _launch(ids, g_rows, n_rows, R, W, col_stride=1, ray_stride=W)
    if R:
        scatter_rows.launches += 1
    return out


scatter_rows_soa.launches = 0
scatter_rows.launches = 0
