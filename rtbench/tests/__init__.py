"""The benchmark's own tests (``python -m pytest rtbench/tests``)."""
