"""Build the package's CUDA sources with ``nvcc`` at first use.

Every ``csrc/*.cu`` file compiles to its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The libraries go to ``paddle_tpu_torch/_build/``, named by a hash
of the source, the shared headers (``csrc/*.cuh``), the flags and the
compiler, so an edited source rebuilds and an unchanged one is reused. All
sources compile in parallel, one ``nvcc`` each, started together.

Nothing here runs when the package is imported: :func:`library` is called
by a kernel wrapper the first time it launches on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["build_all", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# -Xptxas -v: each source's log (``_build/<stem>.log``) reports registers,
# shared memory and spills per kernel
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the path, else the
    toolkit's usual place."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "to build paddle_tpu_torch's kernels")


def _target(src: Path, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the sources' own includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes started together; returns ``{source stem: library path}``.
    Raises with the compiler's output if any build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = []
    for src in sources:
        target = _target(src, nvcc)
        out[src.stem] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, target, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees a torn file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on the
    first call in this process, all sources at once)."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            for name, path in paths.items():
                _libs.setdefault(name, ctypes.CDLL(str(path)))
        return _libs[stem]
