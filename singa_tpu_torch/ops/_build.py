"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into
``singa_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source and the flags, then loaded with ``ctypes``.  Nothing is built when
a module is imported, and nothing falls back: without ``nvcc`` the build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``.  Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "singa_tpu_torch/csrc at first use and need the CUDA toolkit")


def _source(name):
    path = os.path.join(CSRC, name + ".cu")
    with open(path, "rb") as fh:
        return path, fh.read()


def library_path(name) -> str:
    """Where the library built from ``csrc/<name>.cu`` goes."""
    _, src = _source(name)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(name) -> str:
    """Compile ``csrc/<name>.cu`` unless a library for this source is
    already built; return the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    src_path, _ = _source(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src_path]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) for "
                           f"{src_path}:\n{res.stderr[-8000:]}")
    os.replace(tmp, out)
    return out


def load(name) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
