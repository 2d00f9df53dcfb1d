"""Differentiable rendering / inverse rendering."""

from .inverse import (DEFAULT_TRAINABLE, image_mse, make_train_step,
                      merge_scene, split_scene)

__all__ = ["DEFAULT_TRAINABLE", "image_mse", "make_train_step",
           "merge_scene", "split_scene"]
