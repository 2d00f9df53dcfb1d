"""PNG codec for 8-bit RGB and RGBA images, with zlib and numpy.

The port reads and writes PNG without Pillow: ``decode_png`` takes
non-interlaced 8-bit truecolour images (colour types 2 and 6) with any of
the five row filters (none, sub, up, average, Paeth), and ``encode_png``
writes them with a chosen filter per row. Another PNG (palette, grey,
16-bit, interlaced) raises ``ValueError`` and is left to Pillow by the
callers (``io/loaders.py``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}   # colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def _paeth(a, b, c):
    """The Paeth predictor on int arrays: the one of left, up and
    upper-left nearest to left + up − upper-left (ties in that order)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filters=0, level: int = 6) -> bytes:
    """(H, W, 3|4) uint8 → PNG bytes. ``filters``: one filter type (0-4)
    for every row, or a sequence of one per row."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("encode_png takes (H, W, 3|4) uint8")
    h, w, ch = img.shape
    ftype = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    x = img.astype(np.int64)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), left, up, (left + up) // 2,
                      _paeth(left, up, upleft)])
    rows = (x - preds[ftype, np.arange(h)]) & 0xFF
    raw = np.concatenate([ftype[:, None].astype(np.uint8),
                          rows.reshape(h, w * ch).astype(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3|4) uint8. Raises ValueError for a file that is
    not a non-interlaced 8-bit RGB or RGBA PNG, or is corrupt."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} is not decoded here")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, 1 + w * ch)
    ftype = raw[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError("PNG row filter out of range")
    filt = raw[:, 1:].reshape(h, w, ch).astype(np.int64)
    # reconstruct along anti-diagonals r + x = d: a pixel needs its left,
    # upper and upper-left neighbours, all on the two diagonals before it;
    # row 0 and column 0 of the padded image are the zeros PNG prescribes
    out = np.zeros((h + 1, w + 1, ch), np.int64)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        pred = np.select([ftype[r, None] == k for k in range(1, 5)],
                         [a, b, (a + b) // 2, _paeth(a, b, c)], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)
