"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, cached by the hash of
its source under the package's ``build/`` directory (git-ignored), and
loaded with :mod:`ctypes`.  Nothing is built at import time: the first
call of a kernel's wrapper builds it, and :func:`build_all` builds
several at once (one ``nvcc`` process per source, started together).
:func:`start_compile` and :func:`finish_compile` also build the native
polygon rasteriser (:mod:`..data.native_raster`) with ``g++``.
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

__all__ = [
    "CSRC_DIR",
    "BUILD_DIR",
    "NVCC_FLAGS",
    "hashed_library",
    "library_path",
    "start_compile",
    "finish_compile",
    "build_all",
    "load_library",
]

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


def hashed_library(src: Path, stem: str) -> Path:
    """Where ``src`` builds to: ``build/lib<stem>-<hash of src>.so``."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by its source hash)."""
    return hashed_library(CSRC_DIR / f"{name}.cu", name)


def start_compile(compiler: list, src: Path, target: Path):
    """Start ``compiler -o <tmp> src`` with ``<tmp>`` a fresh file beside
    ``target``; returns ``(tmp, process)``, or None when ``target`` exists."""
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{target.stem}-", suffix=".so.tmp", dir=target.parent)
    os.close(fd)
    proc = subprocess.Popen([*compiler, "-o", tmp, str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return tmp, proc


def finish_compile(target: Path, tmp: str, proc) -> str:
    """Wait for a compile from :func:`start_compile` and rename its output
    to ``target``; returns the compiler's output.  The rename is atomic, so
    processes that build the same source at once never load a half-written
    file.  Raises ``RuntimeError`` with the compiler's output if it failed."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"{proc.args[0]} failed for {proc.args[-1]}:\n{log}")
    os.replace(tmp, target)
    return log


def build_all(names, verbose: bool = False) -> dict:
    """Build every ``csrc/<name>.cu`` in parallel; returns ``{name: path}``.
    Raises with ``nvcc``'s output when a build fails."""
    started = {}
    for name in names:
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
        target = library_path(name)
        started[name] = (target, start_compile(cmd, CSRC_DIR / f"{name}.cu", target))
    out = {}
    errors = []
    for name, (target, job) in started.items():
        if job is not None:
            try:
                log = finish_compile(target, *job)
            except RuntimeError as e:
                errors.append(str(e))
                continue
            if verbose and log:
                print(log, end="")
        out[name] = target
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_all([name])[name]))
