"""Build bridge for the port's CUDA kernels.

Each kernel source ``ray_tracer_tpu_torch/csrc/<name>.cu`` has a plain C
interface. At first use it is compiled with ``nvcc`` into a shared
library under ``build/ray_tracer_tpu_torch/`` at the repository root,
keyed by a hash of the source and the flags, and loaded with ``ctypes``.
The build uses nothing but the repository's sources and the CUDA toolkit.
``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` without
``--use_fast_math``, so that every kernel computes each float operation
as PyTorch's elementwise operations do (no fused multiply-add, IEEE
division and square root) and matches its plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "ray_tracer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this source and these
    flags exists. The compiler's report (registers, spills) is kept
    beside the library as ``.log``. Raises if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``."""
    return ctypes.CDLL(str(build(name)))
