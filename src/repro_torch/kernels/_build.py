"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and becomes one shared
library, compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the root
of the checkout and loaded with ``ctypes``.  The library's name carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  A failed build raises; nothing falls back.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found on PATH or at {NVCC_FALLBACK}")
    return found


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives (built or not)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; returns the library path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.ptxas.txt``.
    """
    lib = library_path(source)
    if lib.exists():
        return lib
    nvcc = _nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


def ptxas_report(source: Path) -> str:
    """The ``-Xptxas -v`` report of the library built from ``source``."""
    return build(source).with_suffix(".ptxas.txt").read_text()


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source``."""
    return ctypes.CDLL(str(build(source)))
