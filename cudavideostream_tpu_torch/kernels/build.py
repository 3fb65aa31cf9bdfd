"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``) and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Nothing here runs at import time: the first caller of
:func:`load` pays the build. The ops modules reach it through
:mod:`.launch`, which binds each library from its source's table.

There is no fallback: without ``nvcc`` or on a failed build :func:`load`
raises.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of cudavideostream_tpu_torch are built from source "
        "at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for this source and
    the headers beside it (``csrc/*.cuh``), which it may include."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(src) -> ctypes.CDLL:
    """Build (if needed), load and bind the library of the binding table
    ``src`` (a :class:`.launch.Source`): ``src.bind`` declares its
    functions (and may refuse it by raising) before it is cached, so every
    caller gets it bound. A library already loaded is returned without
    taking the lock, which a build holds."""
    lib = _loaded.get(src.name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(src.name)
        if lib is None:
            lib = ctypes.CDLL(str(build(src.name)))
            src.bind(lib)
            _loaded[src.name] = lib
        return lib
