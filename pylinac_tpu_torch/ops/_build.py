"""Build and load the port's hand-written CUDA kernels.

The JAX package has no counterpart: its Pallas kernels are compiled by XLA
(``pylinac_tpu/ops/pallas_median.py:53``). Here each ``csrc/<name>.cu`` has
a plain C interface and is compiled by ``nvcc`` into a shared library that
``ctypes`` loads. The library goes into ``pylinac_tpu_torch/_build/``, named
by a hash of its source and flags, and is built at first use. A failed
build raises; nothing falls back. The first use loads under a lock, and the
wrappers count their launches through :func:`count_launch`, so that the
shards of a mesh, one thread a device, neither build a library twice nor
lose a count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the one on
    ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {home}/bin or on PATH; the CUDA kernels "
            "need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by its content."""
    src = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns (library path, seconds spent compiling, nvcc's output). The
    output holds ``ptxas`` register and shared-memory counts; it is empty
    and the time 0 when the library was already built."""
    out = library_path(name)
    if out.is_file():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed; one
    thread builds it while the others wait."""
    with _LOAD_LOCK:
        return _load(name)


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, atomically across threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1
