"""The linear → 8-bit sRGB encode kernel (CUDA C++, ``csrc/srgb_encode.cu``)
and its wrapper.

  * ``srgb_encode(img, flip)`` — a uint8 tensor of ``img``'s shape on its
    device: each value's level, the number of the numpy encode's 255
    ascending thresholds (``io.image.srgb_thresholds``) at or below it
    (NaN: 0), with the rows of the first axis reversed where ``flip``.

``io.image.to_uint8`` takes it for tensors on a CUDA device, and so writes
numpy's bytes; numpy arrays and CPU tensors keep the numpy encode, which
stays the oracle the tests compare against. The wrapper takes CUDA float32
tensors only: anything else raises. It counts its launches in
``srgb_encode.launches``.

Why CUDA C++ and not Triton: it is built and bound as the port's other
kernels are (``utils/build.py``), and a table search a value needs
nothing Triton adds. Why not ``torch.searchsorted`` over the same table:
that takes a flip, the search with an int64 result, a NaN mask and a
cast, five launches where this is one; on an H100 at 800x800x3 it takes
45 us of device time and 0.09 ms of host time a call against the
kernel's 8 us and 0.03 ms (``chip_smoke.py`` phase 2g times both).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

_INT32_LIMIT = 2 ** 31 - 4   # the kernel's int indices run past n by 3
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"rtt_srgb_encode": [_P, _P, _I, _I, _I, _P, _P]}


def srgb_encode(img: torch.Tensor, flip: bool) -> torch.Tensor:
    """The levels of ``img`` (a float32 tensor on a CUDA device, at least
    one axis) as a new uint8 tensor of its shape on its device; the first
    axis reversed where ``flip``."""
    if not isinstance(img, torch.Tensor) or img.device.type != "cuda":
        raise ValueError("the sRGB encode kernel takes a tensor on a CUDA "
                         f"device, got {type(img).__name__} on "
                         f"{getattr(img, 'device', 'the host')}")
    if img.dtype != torch.float32 or img.dim() < 1:
        raise ValueError(f"img must be float32 with at least one axis, got "
                         f"{img.dtype} of shape {tuple(img.shape)}")
    if img.numel() > _INT32_LIMIT:
        raise ValueError("too many values for 32-bit indexing")
    img = img.detach().contiguous()
    out = torch.empty(img.shape, dtype=torch.uint8, device=img.device)
    rows = img.shape[0]
    if out.numel() == 0:
        return out
    from ..io.image import srgb_thresholds   # io.image imports this module
    build.launch(build.library("srgb_encode", SIGNATURES), "rtt_srgb_encode",
                 "sRGB encode", img.device, img.data_ptr(), out.data_ptr(),
                 rows, img.numel() // rows, int(bool(flip)),
                 srgb_thresholds().ctypes.data)
    srgb_encode.launches += 1
    return out


srgb_encode.launches = 0
