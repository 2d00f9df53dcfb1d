"""Intersection: the plain PyTorch oracle and the closest-hit kernel."""
