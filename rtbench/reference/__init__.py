"""Plain references the benchmark holds the port to. They import nothing
of the port and nothing of JAX."""
