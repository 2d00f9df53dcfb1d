"""Image output: linear→sRGB encode and PNG / NPY writers.

Port of ``ray_tracer_tpu.io.image``. The renderer's row 0 is the bottom of
the frame, so the writers flip vertically for display. Images may be
tensors on any device or numpy arrays. A tensor on a CUDA device is encoded
there by the kernel of ``ops/srgb_encode.py``, bit-equal to the numpy
encode, and only its 8-bit image crosses to the host, into page-locked
memory; numpy arrays and CPU tensors take the numpy encode. PNGs are
written by the port's own codec (``io/png.py``), without Pillow.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.srgb_encode import srgb_encode
from ..utils.metrics import span
from .png import encode_png


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float32)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 transfer function."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1 / 2.4) - 0.055)


LEVELS = 255   # the thresholds of 8-bit levels 1..255


def _encode(img: np.ndarray) -> np.ndarray:
    """Linear float32 → 8-bit sRGB levels, value by value."""
    return (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def srgb_thresholds() -> np.ndarray:
    """The encode's 255 level thresholds (read-only float32): entry k - 1
    is the least float32 in [0, 1] that ``_encode`` takes to level k or
    above. Found by bisection over float32 bit patterns, which order
    non-negative floats as their values, with this machine's numpy. The
    encode is monotone, so a value's level is the number of thresholds at
    or below it: the kernel's encode (``csrc/srgb_encode.cuh``)."""
    k = np.arange(1, LEVELS + 1)
    lo = np.zeros(LEVELS, np.int64)            # _encode(lo) < k
    hi = np.full(LEVELS, np.float32(1.0).view(np.int32), np.int64)
    while np.any(hi - lo > 1):                 # _encode(hi) >= k
        mid = (lo + hi) // 2
        up = _encode(mid.astype(np.int32).view(np.float32)) >= k
        lo, hi = np.where(up, lo, mid), np.where(up, mid, hi)
    table = hi.astype(np.int32).view(np.float32)
    if np.any(np.diff(table) < 0):
        raise RuntimeError("numpy's sRGB encode is not monotone here: no "
                           "threshold table encodes as it does")
    table.flags.writeable = False
    return table


def _to_uint8_cuda(img: torch.Tensor, flip: bool) -> np.ndarray:
    """The kernel's encode on the image's device, then its bytes copied
    into page-locked host memory; waits for that copy (and so for the work
    queued before it on the stream), not for the whole device. Each call
    returns a buffer of its own from torch's caching host allocator, so a
    later call never writes into an array already returned."""
    with torch.cuda.device(img.device):
        with span("image.encode"):
            rgb = srgb_encode(img.detach().float(), flip)
        with span("image.to_host"):
            host = torch.empty(rgb.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(rgb, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
    return host.numpy()


def to_uint8(img, flip: bool = True) -> np.ndarray:
    """(H, W, 3) linear float → uint8 sRGB, top row first."""
    if isinstance(img, torch.Tensor) and img.device.type == "cuda":
        return _to_uint8_cuda(img, flip)
    with span("image.to_host"):
        img = _host(img)
    with span("image.encode"):
        if flip:
            img = img[::-1]
        return _encode(img)


def write_png(path: str, img, flip: bool = True) -> None:
    """Write a linear-radiance image as an 8-bit sRGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img, flip=flip)))


def write_npy(path: str, img, flip: bool = True) -> None:
    """Raw linear float32 dump for golden-image comparisons."""
    img = _host(img)
    if flip:
        img = img[::-1]
    np.save(path, img)
