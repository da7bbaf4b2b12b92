"""Builds the package's CUDA sources into a shared library and loads it.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. The library is built on first
use into ``rag_arc_tpu_torch/_build/``, named by a hash of the source,
every header under ``csrc/`` (``hopper.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads as it is. Nothing
here runs at import time: a CPU-only install imports the package without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from rag_arc_tpu_torch.utils.tracing import stage

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


_COUNT_LOCK = threading.Lock()


def count_launch(module: str, name: str = "launches") -> None:
    """Adds one to ``<module>.<name>``, a wrapper's launch count. One lock
    serves every wrapper: ``+=`` on a module global is a read and a write,
    and a thread between them loses another's increment. The count stays a
    plain module attribute that callers read and set to 0."""
    mod = sys.modules[module]
    with _COUNT_LOCK:
        setattr(mod, name, getattr(mod, name) + 1)


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when an earlier build was reused
    ptxas: str      # nvcc's -Xptxas -v report (registers, shared memory)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's install default
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build on first "
        "use on a machine with the CUDA toolkit"
    )


def source_digest(name: str, csrc: Path = CSRC_DIR) -> str:
    """The hash that names ``csrc/<name>.cu``'s library: the source, every
    ``*.cuh`` header beside it (by name and content) and the nvcc flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build(name: str, csrc: Path = CSRC_DIR) -> Built:
    """Compile ``csrc/<name>.cu`` (once per source and header hash) and
    load it. ``csrc``: another source tree's kernels (an A/B against an
    earlier version), built beside these under their own hash."""
    src = csrc / f"{name}.cu"
    digest = source_digest(name, csrc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = BUILD_DIR / f"lib{name}_{digest}.log"
    seconds = 0.0
    if not lib_path.exists():
        # compile to a private name and rename into place, so concurrent
        # processes never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        # a build inside a served window is a stall: it shows as a span
        with stage("kernel.build", kernel=name):
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True, check=False,
            )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    ptxas = log_path.read_text() if log_path.exists() else ""
    return Built(ctypes.CDLL(str(lib_path)), lib_path, seconds, ptxas)
