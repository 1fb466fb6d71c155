"""Native components: C++ exact minimum-weight perfect matching.

Counterpart of ``mcmc_qec_tpu/native``: the same ``blossom.cpp`` (a
byte-identical copy, pinned by tests/test_torch_matching.py), built with
``g++`` at first use into
``mcmc_qec_tpu_torch/build/blossom-<hash>/libblossom.so`` (the hash covers
the source and the flags, as ``ops/_build.py`` does for the CUDA sources)
and loaded through ctypes.  The library is compiled to a private name and
renamed into place, so processes that build it at once never load a
half-written file.  There is no Python fallback: a build failure raises,
and ``brute_force_mwpm`` is the tests' oracle.  numpy only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "blossom.cpp"
BUILD_DIR = _HERE.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"blossom-{h.hexdigest()[:16]}" / "libblossom.so"


def build_library(force: bool = False) -> str:
    """Compile blossom.cpp unless a library for the current source exists;
    returns its path.  Raises ``RuntimeError`` with the compiler output on
    failure."""
    lib = _lib_path()
    if lib.exists() and not force:
        return str(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ to build {_SRC.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


@functools.lru_cache(maxsize=1)
def _get_lib():
    lib = ctypes.CDLL(build_library())
    lib.mwpm_solve.restype = ctypes.c_longlong
    lib.mwpm_solve.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    return lib


def mwpm_solve(
    n_nodes: int, edges: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Exact minimum-weight perfect matching.

    edges: (m, 3) array of (u, v, w) with integer weights >= 0.
    Returns (match, total_weight) where match[i] is i's partner.
    Raises ValueError if no perfect matching exists.
    """
    edges = np.asarray(edges)
    if n_nodes == 0:
        return np.zeros(0, dtype=np.int32), 0
    eu = np.ascontiguousarray(edges[:, 0], dtype=np.int32)
    ev = np.ascontiguousarray(edges[:, 1], dtype=np.int32)
    ew = np.ascontiguousarray(edges[:, 2], dtype=np.int64)
    out = np.zeros(n_nodes, dtype=np.int32)
    total = _get_lib().mwpm_solve(n_nodes, len(edges), eu, ev, ew, out)
    if total < 0:
        raise ValueError("no perfect matching exists for the given graph")
    return out, int(total)


def brute_force_mwpm(n_nodes: int, edges: np.ndarray) -> Tuple[Optional[np.ndarray], float]:
    """Exponential-time exact solver for tests (n <= ~12)."""
    w = {}
    for u, v, wt in np.asarray(edges):
        key = (min(int(u), int(v)), max(int(u), int(v)))
        if key not in w or wt < w[key]:
            w[key] = int(wt)
    best = [None, float("inf")]

    def rec(remaining, acc, pairs):
        if acc >= best[1]:
            return
        if not remaining:
            best[0] = list(pairs)
            best[1] = acc
            return
        u = remaining[0]
        for v in remaining[1:]:
            key = (min(u, v), max(u, v))
            if key in w:
                rest = [x for x in remaining if x not in (u, v)]
                rec(rest, acc + w[key], pairs + [(u, v)])

    rec(list(range(n_nodes)), 0, [])
    if best[0] is None:
        return None, float("inf")
    match = np.full(n_nodes, -1, dtype=np.int32)
    for u, v in best[0]:
        match[u] = v
        match[v] = u
    return match, best[1]
