"""Elementwise bounds with the reference's gradient at a tie.

Where x equals the bound, ``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum``
pass half of the gradient to x; ``torch.clamp`` passes all of it.
``torch.maximum`` and ``torch.minimum`` split it as JAX does, so every
bound on a differentiable value goes through these helpers, written as the
reference writes it: ``jnp.clip(x, lo, hi)`` is ``clip(x, lo, hi)``,
``jnp.maximum(x, lo)`` is ``maximum(x, lo)``. Diffuse (smoothness 0) and
mirror (smoothness 1) materials sit exactly on ``clip``'s bounds, so the
choice shows in the gradients. Forward values are those of ``clamp``.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _scalar(value: float, dtype: torch.dtype, device: torch.device):
    """A 0-dim bound, made once per value, dtype and device."""
    return torch.tensor(value, dtype=dtype, device=device)


def maximum(x, lo: float):
    return torch.maximum(x, _scalar(float(lo), x.dtype, x.device))


def minimum(x, hi: float):
    return torch.minimum(x, _scalar(float(hi), x.dtype, x.device))


def clip(x, lo: float, hi: float):
    return minimum(maximum(x, lo), hi)
