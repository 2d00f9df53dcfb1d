"""Image writers."""

from .image import linear_to_srgb, to_uint8, write_npy, write_png

__all__ = ["linear_to_srgb", "to_uint8", "write_npy", "write_png"]
