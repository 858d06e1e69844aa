"""Build the native runtime library with ``g++`` at first use.

``shm_queue.cpp`` compiles to ``paddle_tpu_torch/_build/libshm_queue_<hash>
.so``, named by a hash of the source, the flags and the compiler, so an
edited source rebuilds and an unchanged one is reused; the build writes a
temporary file and renames it, so concurrent importers see the old library
or the new one. Nothing compiles next to the sources, and nothing runs when
the package is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["lib_path"]

SOURCE = Path(__file__).resolve().parent / "shm_queue.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lpthread", "-lrt"]

_lock = threading.Lock()


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found: the shared-memory queue of the "
                           "DataLoader's worker processes needs a C++ "
                           "compiler (set CXX)")
    return found


def lib_path() -> str:
    """The built library's path, compiling it if no up-to-date one
    exists. Raises with the compiler's output if the build fails."""
    with _lock:
        cxx = _compiler()
        h = hashlib.sha256(SOURCE.read_bytes())
        h.update(" ".join([cxx, *FLAGS, *LIBS]).encode())
        target = BUILD_DIR / f"libshm_queue_{h.hexdigest()[:16]}.so"
        if target.exists():
            return str(target)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE),
                               *LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
        return str(target)
