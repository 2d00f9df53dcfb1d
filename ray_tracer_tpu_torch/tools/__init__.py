"""Tools of the port that run as ``python -m ray_tracer_tpu_torch.tools.<name>``."""
