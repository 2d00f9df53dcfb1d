"""The benchmark of the PyTorch/CUDA port (``ray_tracer_tpu_torch``)."""
