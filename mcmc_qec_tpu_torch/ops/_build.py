"""Build and load the port's CUDA sources.

Each library is compiled by ``nvcc`` at first use into
``mcmc_qec_tpu_torch/build/<name>-<hash>/lib<name>.so``, where the hash
covers every file under ``csrc/`` and the compiler flags, and is loaded with
``ctypes`` (plain C entry points; no PyTorch headers, so a build takes
seconds).  A later process with the same sources reuses the library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# no --use_fast_math: the kernels' logf must equal torch.log on the card
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # compile time; 0.0 when an existing library was reused
    log: str  # nvcc/ptxas output of the compile ("" when reused)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from csrc/ at first use"
        )
    return found


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library for the current sources
    exists.  Raises ``RuntimeError`` with the compiler output on failure."""
    src = CSRC / f"{name}.cu"
    out_dir = BUILD_DIR / f"{name}-{_source_hash(name)}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return Built(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename, so no process ever loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, lib)
    return Built(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled on first call in this process."""
    return ctypes.CDLL(str(build(name).path))
