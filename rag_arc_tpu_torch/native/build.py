"""On-demand compilation of the host C++ components (the port's own copy
of ``rag_arc_tpu/native/build.py``).

Bindings are plain ``extern "C"`` + ctypes. ``native/<name>.cpp`` builds
with ``g++ -O3 -march=native`` into ``rag_arc_tpu_torch/_build/native/``
at first use, and again only when the source is newer than the library.
The compiler writes a temporary file that is renamed into place, so
processes building at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build" / "native"

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL] = {}


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if stale) and dlopen ``native/<name>.cpp`` → lib<name>.so."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = NATIVE_DIR / f"{name}.cpp"
        if not src.exists():
            raise FileNotFoundError(f"no native source {src}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}.so"
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                str(src), "-o", tmp,
            ]
            logger.info("building native component: %s", " ".join(cmd))
            result = subprocess.run(cmd, capture_output=True, text=True)
            if result.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"native build of {name} failed:\n{result.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _cache[name] = lib
        return lib
