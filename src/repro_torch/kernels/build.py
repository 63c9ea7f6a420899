"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain ``extern "C"`` interface; no PyTorch
header is included, so a build takes seconds.  Libraries land in
``build/repro_torch_kernels/`` at the repository root (git-ignored), named
by a hash of the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source or header rebuilds and an unchanged one loads from the
cache.  A failed build raises with nvcc's
output.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(source: str) -> Path:
    # the hash covers the shared headers too, so editing one rebuilds
    src = (CSRC / source).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _compile(source: str) -> Path:
    out = _lib_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def resource_usage(source: str) -> str:
    """``nvcc -Xptxas -v``'s report for ``source``: each kernel's registers,
    shared memory and spills.  Compiles once more into a private
    directory under the build directory and removes it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
           os.path.join(tmp, "usage.so"), str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
    return proc.stdout + proc.stderr


def library(source: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (built on first use).  Builds of
    different sources may run in parallel threads; the lock only guards
    the table of loaded libraries."""
    with _LOCK:
        lib = _LOADED.get(source)
    if lib is not None:
        return lib
    path = _compile(source)
    with _LOCK:
        return _LOADED.setdefault(source, ctypes.CDLL(str(path)))
