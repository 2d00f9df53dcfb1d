"""Texture sampling: bilinear lookup from a fixed-size texture stack.

Port of ``ray_tracer_tpu.texture``. All of a scene's textures live in one
(K, R, R, 3) f32 stack, resized when the scene is built, so a batch of
lanes samples with one flat gather and no per-texture control flow. The
fetch is differentiable in the texels (autograd's transpose of the gather
is a scatter-add) and in the UVs (through the bilinear weights), so
texture recovery by inverse rendering works as in the reference.

UV convention: u right, v down (image row = v * H).

Resizing: the reference resizes with Pillow's bilinear filter; the port
resizes with ``torch.nn.functional.interpolate`` (bilinear, antialiased,
on the CPU), which gives Pillow's result exactly at equal size (both
copy) and when upsampling, and within 1 of 255 on a fraction of a percent
of the values when downsampling.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """Inverse of the display transfer function: diffuse maps are authored
    in sRGB, shading happens in linear radiance."""
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _resize_uint8(arr: np.ndarray, resolution: int) -> np.ndarray:
    """(H, W, 3) uint8 → (resolution, resolution, 3) uint8: bilinear with
    antialiasing (torch's uint8 path, which follows Pillow's filter); a
    copy at equal size, as Pillow returns."""
    if arr.shape[0] == arr.shape[1] == resolution:
        return arr.copy()
    img = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None]
    out = F.interpolate(img, size=(resolution, resolution), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def prepare_texture(image, resolution: int, srgb: bool) -> np.ndarray:
    """uint8/float (H, W, 3|4) or gray (H, W) image → (resolution,
    resolution, 3) linear f32. Floats are clipped to [0, 1] and truncated
    to uint8 as the reference does; alpha is dropped."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    out = _resize_uint8(arr[..., :3], resolution).astype(np.float32) / 255.0
    return srgb_to_linear(out) if srgb else out


class _QuadRows(torch.autograd.Function):
    """``quad[idx]``: the fetch's one gather. Its backward adds each lane's
    cotangent row into its quad row with the scatter-add kernel's
    row-major form (``ops/scatter_rows.scatter_rows``; its plain version,
    ``index_add_``, for CPU tensors). Autograd's own backward of the gather
    sorts the indices and sums each run of equal ones in one warp, lane
    after lane; the sphere and miss lanes of a wavefront all fetch one
    texel (their UVs are 0), so that run is a million lanes long: 3.3 s a
    1080p texture-recovery step on an H100. The kernel pre-reduces equal
    ids within a warp and skips all-zero columns."""

    @staticmethod
    def forward(ctx, quad, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = quad.shape[0]
        return quad.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        from .ops.scatter_rows import scatter_rows
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, g.contiguous(), ctx.n_rows), None


def sample_bilinear(stack, tex_id, uv):
    """Bilinear texture fetch with repeat wrapping.

    Each texel row of the quad table holds its 2x2 wrap-around
    neighbourhood [c00 | c10 | c01 | c11] (12 floats), a roll and concat
    of the stack, so the four taps are one gather, as in the reference;
    its transpose, in the backward, is one scatter-add (``_QuadRows``).

    Args:
      stack: (K, R, R, 3) f32 texture stack.
      tex_id: (N,) int, -1 = untextured (returns white).
      uv: (N, 2) f32.

    Returns (N, 3).
    """
    K, H, W, _ = stack.shape
    sx = torch.roll(stack, -1, dims=2)           # x+1 neighbour (wrapped)
    sy = torch.roll(stack, -1, dims=1)           # y+1
    sxy = torch.roll(sx, -1, dims=1)             # x+1, y+1
    quad = torch.cat([stack, sx, sy, sxy], -1).reshape(K * H * W, 12)
    tid = torch.clamp(tex_id.long(), 0, K - 1)   # an int id: no gradient

    u = uv[:, 0] - torch.floor(uv[:, 0])         # repeat wrap
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi = torch.remainder(x0.long(), W)
    yi = torch.remainder(y0.long(), H)

    idx = ((tid * H + yi) * W + xi).to(torch.int32)
    rows = _QuadRows.apply(quad, idx)            # (N, 12): the one gather
    c00, c10 = rows[:, 0:3], rows[:, 3:6]
    c01, c11 = rows[:, 6:9], rows[:, 9:12]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where((tex_id >= 0)[:, None], out, 1.0)


def decode_normal_map(rgb):
    """[0, 1] RGB → tangent-space normal in [-1, 1], z-positive."""
    return rgb * 2.0 - 1.0
