"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, cached by the hash of
its source under the package's ``build/`` directory (git-ignored), and
loaded with :mod:`ctypes`.  Nothing is built at import time: the first
call of a kernel's wrapper builds it, and :func:`build_all` builds
several at once (one ``nvcc`` process per source, started together).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build_all", "load_library"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by its source hash)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str, verbose: bool):
    """Start ``nvcc`` for one source; returns ``(target, tmp, process)``,
    with ``process`` None when the library is already built."""
    target = library_path(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def build_all(names, verbose: bool = False) -> dict:
    """Build every ``csrc/<name>.cu`` in parallel; returns ``{name: path}``.

    The library is written to a temporary file and renamed into place,
    so processes that build the same source at once never load a
    half-written file.  Raises with ``nvcc``'s output when a build fails.
    """
    started = {name: _start_build(name, verbose) for name in names}
    out = {}
    errors = []
    for name, (target, tmp, proc) in started.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                Path(tmp).unlink(missing_ok=True)
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            if verbose and log:
                print(log, end="")
            os.replace(tmp, target)
        out[name] = target
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_all([name])[name]))
