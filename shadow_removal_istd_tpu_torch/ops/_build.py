"""Build and load the port's CUDA kernels and host libraries.

Each ``csrc/*.cu`` file has a plain C interface: ``nvcc`` compiles it for
``sm_90a`` into a shared library on first use and ``ctypes`` loads it, so
the build needs neither ninja nor PyTorch's headers and takes seconds.
The library lands in ``shadow_removal_istd_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the source and flags, so an edited
source is rebuilt and an unchanged one is reused. A failed build raises.
Host C++ libraries (the native PNG loader) are built the same way by
``g++`` (:func:`build_host`).
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
HOST_LIBS = ("-lz", "-pthread")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(src: Path, name: str, cmd: list[str],
             libs: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Run ``cmd -o <lib> src libs`` unless a library built from the same
    source and command exists; returns its path and the compiler's
    output (empty when reused)."""
    key = hashlib.sha256(src.read_bytes() + " ".join(
        [*cmd, *libs]).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{key}.so"
    if lib.is_file():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(src), *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists.

    Returns the library path and the compiler's output (register and
    shared-memory use from ``-Xptxas -v``; empty when reused)."""
    return _compile(CSRC_DIR / f"{name}.cu", name, [nvcc_path(), *NVCC_FLAGS])


def build_host(src: Path, name: str) -> tuple[Path, str]:
    """Compile the host C++ source ``src`` with ``$CXX`` (default g++),
    ``HOST_FLAGS`` and ``HOST_LIBS`` into ``_build/``, keyed as
    :func:`build`. Raises when the compiler is missing or fails."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found")
    return _compile(src, name, [cxx, *HOST_FLAGS], HOST_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            path, _ = build(name)
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
