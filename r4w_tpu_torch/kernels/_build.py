"""Build the port's CUDA sources into one shared library, loaded with ctypes.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into ``build/r4w_tpu_torch/`` at the repository root, under a name keyed by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. The sources have plain C entry points and include
no PyTorch header, which keeps the build to seconds. Importing this module
needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "r4w_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libr4w_tpu_torch_{digest.hexdigest()[:16]}.so"


def ensure_built() -> tuple[Path, str]:
    """Compile the sources unless their library exists.

    Returns the library's path and nvcc's messages (ptxas resource usage),
    or "" when the library was already built. Raises with nvcc's stderr if
    the compile fails.
    """
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library, compiled on the first call in a process."""
    path, _ = ensure_built()
    return ctypes.CDLL(str(path))
