"""Build bridge for the port's CUDA kernels.

Each kernel source ``ray_tracer_tpu_torch/csrc/<name>.cu`` has a plain C
interface. At first use it is compiled with ``nvcc`` into a shared
library under ``build/ray_tracer_tpu_torch/`` at the repository root,
keyed by a hash of the source, of every header it includes from
``csrc/`` (``#include "..."``, followed recursively) and of the flags, and
loaded with ``ctypes``.
``library`` types a library's entry points and ``launch`` calls one on
the current stream: the one convention by which the ops modules call
their kernels.
The build uses nothing but the repository's sources and the CUDA toolkit.
``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` without
``--use_fast_math``, so that every kernel computes each float operation
as PyTorch's elementwise operations do (no fused multiply-add, IEEE
division and square root) and matches its plain version bit for bit.

The host library of ``native/rtt_native.cpp`` (``utils/native.py``) is
built the same way with ``g++`` and the flags of ``native/Makefile``
(``build_host``), keyed by its source and flags.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "ray_tracer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
REPO_DIR = PKG_DIR.parent
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


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


def sources(name: str) -> list[str]:
    """``<name>.cu`` and every file of ``csrc/`` it includes with quotes,
    directly or through another such header, in a fixed order."""
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in seen:
            seen.add(f)
            todo += [m.decode() for m in
                     _INCLUDE.findall((CSRC_DIR / f).read_bytes())]
    return sorted(seen)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: its name
    carries a hash of the source, its headers and the flags, so editing
    any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources(name):
        h.update(f.encode() + b"\0" + (CSRC_DIR / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(compiler: str, flags, source: Path, out: Path) -> Path:
    """Compile ``source`` into ``out`` unless it exists. The compiler's
    report is kept beside the library as ``.log``. Raises if it fails."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}) building {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this source and these
    flags exists; the report (registers, spills) is kept as ``.log``.
    Raises if nvcc fails."""
    return _compile(find_nvcc(), NVCC_FLAGS, CSRC_DIR / f"{name}.cu",
                    library_path(name))


def host_library_path(source: Path) -> Path:
    """Where the host library built from the C++ file ``source`` lives,
    keyed like ``library_path`` by a hash of the flags and the source."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(source.name.encode() + b"\0" + source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build_host(source: Path) -> Path:
    """Compile the C++ file ``source`` with g++ (``$CXX`` if set) and
    HOST_FLAGS unless a library of this source and these flags exists.
    Raises if the compiler is missing or fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) found")
    return _compile(cxx, HOST_FLAGS, source, host_library_path(source))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``."""
    return ctypes.CDLL(str(build(name)))


_TYPED: dict[str, ctypes.CDLL] = {}   # name -> the library, typed


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library ``name`` (``load``: built at first use) with the
    C signatures ``{symbol: argtypes}`` set, each symbol returning an int
    (an error code, a size or a count), and ``rtt_error_string``, which
    every kernel library exports, bound. Typed once per name."""
    lib = _TYPED.get(name)
    if lib is None:
        lib = load(name)
        for symbol, argtypes in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        _TYPED[name] = lib
    return lib


def launch(lib: ctypes.CDLL, symbol: str, what: str, device, *args):
    """Call the kernel entry ``symbol`` of ``lib`` (from ``library``) with
    ``args`` and, last, the current stream of the CUDA ``device``, with
    that device current. Raises ``RuntimeError("<what> kernel launch
    failed: <the CUDA error string>")`` where it returns an error code."""
    with torch.cuda.device(device):
        err = getattr(lib, symbol)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.rtt_error_string(err).decode())
