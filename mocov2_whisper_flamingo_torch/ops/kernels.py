"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
libraries go to ``build/torch_kernels/`` at the root of the checkout, named
by a hash of the sources, so an edited source is rebuilt on next use and an
unchanged one is reused. All sources build in parallel, one ``nvcc`` each.
Building and loading hold one lock, so threads that reach a kernel's first
use together (a caller of ``build_all`` beside a serving thread in ``load``)
compile once and the others wait. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.RLock()  # re-entrant: load() builds while it holds it
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_sources_hash()}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, all at once.
    Returns ``{name: library path}``; raises with nvcc's output on failure.
    The ptxas report (registers, shared memory, spills) is kept beside each
    library as ``.log``."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = {src.stem: _lib_path(src.stem) for src in sorted(CSRC.glob("*.cu"))}
        procs = []
        for name, lib in out.items():
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, lib, tmp, proc in procs:
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        if name not in _libs:
            lib = _lib_path(name)
            if not lib.exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(lib))
        return _libs[name]
