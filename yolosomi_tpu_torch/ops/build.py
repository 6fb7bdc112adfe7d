"""Build and load the port's CUDA kernels.

Each kernel source under csrc/ has a plain C interface and is compiled by
`nvcc` into its own shared library at first use, then loaded with ctypes.
Libraries go to build/yolosomi_tpu_torch/ under the repository root and
are named by a hash of their source and of the headers beside it
(csrc/*.cuh), so an edited source or header is rebuilt and a stale library
is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yolosomi_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict = {}
# compiler output (ptxas register/shared-memory report) of the last build
# of each source, for the smoke run's log
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile csrc/<source> unless a library for this exact source exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOG[source] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library for csrc/<source>, built on first use."""
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(str(build(source)))
    return _LIBS[source]
