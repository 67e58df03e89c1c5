"""Build the port's CUDA sources into shared libraries, loaded with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
library under ``build/r4w_tpu_torch/`` at the repository root, named after
the source and a hash of its text and the flags, so an edited source builds
anew and an unchanged one is reused. `ensure_built` starts one nvcc per
missing library, all at once, and waits for them together. The sources
have plain C entry points and include no PyTorch header, which keeps each
build to seconds. Importing this module needs neither ``nvcc`` nor a GPU.
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


def sources() -> dict[str, Path]:
    """Every CUDA source, by name (its file stem)."""
    return {src.stem: src for src in sorted(CSRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where the library of source `name`, at its current text, lives."""
    src = sources()[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def ensure_built(names=None) -> dict[str, tuple[Path, str]]:
    """Compile the named sources (default: all) whose library is missing.

    The compiles run in parallel, one nvcc each. Returns, per name, the
    library's path and nvcc's messages (ptxas resource usage), or "" when
    the library was already built. Raises with nvcc's stderr if any
    compile fails, after every started compile has ended.
    """
    names = sorted(sources()) if names is None else list(names)
    done, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            done[name] = (out, "")
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, cmd, tmp, out)
    failures = []
    for name, (proc, cmd, tmp, out) in running.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed with exit code {proc.returncode}: "
                            f"{' '.join(cmd)}\n{stderr}")
            continue
        os.replace(tmp, out)
        done[name] = (out, stderr)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of source `name`, compiled on first use in a process."""
    (path, _), = ensure_built([name]).values()
    return ctypes.CDLL(str(path))
