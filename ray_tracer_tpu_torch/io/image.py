"""Image output: linear→sRGB encode and PNG / NPY writers.

Port of ``ray_tracer_tpu.io.image``. The renderer's row 0 is the bottom of
the frame, so the writers flip vertically for display. Images may be
tensors on any device or numpy arrays. PNGs are written by the port's own
codec (``io/png.py``), without Pillow.
"""

from __future__ import annotations

import numpy as np
import torch

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


def to_uint8(img, flip: bool = True) -> np.ndarray:
    """(H, W, 3) linear float → uint8 sRGB, top row first."""
    with span("image.to_host"):
        img = _host(img)
    with span("image.encode"):
        if flip:
            img = img[::-1]
        return (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)


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
