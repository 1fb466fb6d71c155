"""The stream merge of the counting decoders on the card: one launch a
stream window folds every row's window candidates into its bounded buffer
of unique chains (``decoders/streaming.py::streaming_scan``).

``merge_window(key, r, halves, rank, valid)`` returns what the plain
version, ``decoders/streaming.py::_merge_row``, returns for the same
window, bit for bit: the new buffer (key (R, C) int64, r (R, C) float32) of
the C smallest unique (rank, key) entries in (rank, key) order, and per row
the new unique chains (int32), whether the buffer overflowed (bool) and the
rank in its last slot when full (float32, else +inf).  It takes the window
as K1 recorded it: the key halves (R, D, W, 2) int64 and the caller's
float32 ranks (R, D, W), with conv_mult's valid mask (R, D, W) or None.
The kernel (``csrc/stream_merge.cu``, built with ``nvcc`` at first use by
``ops/_build.py``) keeps one copy of each of the window's chains, sorts
by (rank, key) in shared memory only those that can still take a slot,
one block a row, and merges them with the buffer, which is in that order
already.  CUDA tensors only: ``streaming_scan`` routes a CPU tensor, and a
shape ``merge_kernel_fits`` refuses, to ``_merge_row``.  Every launch adds
one to ``stream_merge_counts.launches``; ``streaming_scan`` adds each merge
it gives the plain version to ``plain_calls``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .kernel_tables import KernelCounter, _check

# candidates a thread of the kernel sorts (csrc/stream_merge.cu::
# kItemsPerThread); a block sorts a power of two of them, 1024 to 8192
ITEMS_PER_THREAD = 8
MIN_ITEMS = 1024
MAX_ITEMS = 8192
# buffer slots a row: the buffer's counts share a 32-bit scan word with
# the candidates', 16 bits each (kMaxCapacity)
MAX_CAPACITY = 0xFFFF

# the merge kernel's counts
stream_merge_counts = KernelCounter()


def sort_items(S: int) -> int:
    """Candidates a block sorts for a window of ``S`` a row: the least
    power of two from MIN_ITEMS up that holds them (padding sorts last)."""
    n = MIN_ITEMS
    while n < S:
        n *= 2
    return n


def merge_kernel_fits(C: int, S: int) -> bool:
    """Whether the kernel takes a buffer of ``C`` slots and a window of
    ``S`` candidates a row, from shapes alone: S up to MAX_ITEMS (the sort
    in shared memory, whose widest block csrc/stream_merge.cu asserts fits
    a block's shared memory) and C up to MAX_CAPACITY.  It admits every default
    shape of the streamed decoders: STDC and STRC (``_pick_stream_window``:
    S = 4096 at 4 droplets, 4090 at 10; C = 4096), PTDC across rungs at
    toric d=5 (S = 4 droplets x 5 rungs x 256 = 5120, C = 4096) and PTRC a
    rung (S = 1024, C = 2048)."""
    return 1 <= S <= MAX_ITEMS and 1 <= C <= MAX_CAPACITY


class _Params(ctypes.Structure):
    """csrc/stream_merge.cu::MergeParams."""

    _fields_ = [(n, ctypes.c_int32) for n in ("R", "C", "S", "items")]


class _Buffers(ctypes.Structure):
    """csrc/stream_merge.cu::MergeBuffers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "key_in", "r_in", "halves", "rank", "valid", "key_out", "r_out",
        "disc", "overflowed", "max_kept",
    )]


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded on first use."""
    from . import _build

    lib = _build.load("stream_merge")
    lib.mqt_stream_merge.argtypes = [ctypes.POINTER(_Params),
                                     ctypes.POINTER(_Buffers), ctypes.c_void_p]
    lib.mqt_stream_merge.restype = ctypes.c_int
    return lib


def merge_window(key: torch.Tensor, r: torch.Tensor, halves: torch.Tensor,
                 rank: torch.Tensor, valid=None):
    """Merge the window into every row's buffer with one kernel launch.

    ``key`` (R, C) int64 and ``r`` (R, C) float32: the buffer, in (rank,
    key) order with its empty slots (sentinel key, +inf) last; ``halves``
    (R, ..., 2) int64: the window's key halves (values in [0, 2**32)),
    S = the product of the middle axes per row; ``rank`` (R, ...) float32
    and ``valid`` (R, ...) bool or None: the candidates' ranks and
    conv_mult's mask.  Returns (key, r, n_discovered, overflowed,
    max_kept) as ``decoders/streaming.py::_merge_row`` does, equal bit for
    bit.  Raises for a CPU tensor or a shape ``merge_kernel_fits``
    refuses."""
    device = key.device
    if device.type != "cuda":
        raise ValueError(f"merge_window runs on a CUDA device, not {device}")
    R, C = key.shape
    if R == 0:
        return (key.clone(), r.clone(), key.new_zeros(0, dtype=torch.int32),
                key.new_zeros(0, dtype=torch.bool), r.new_zeros(0))
    halves = halves.reshape(R, -1, 2).contiguous()
    S = halves.shape[1]
    if not merge_kernel_fits(C, S):
        raise ValueError(f"the merge kernel takes up to {MAX_CAPACITY} slots "
                         f"and {MAX_ITEMS} candidates a row, not {C} and {S}")
    rank = rank.reshape(R, S).contiguous()
    _check(key, "key", (R, C), torch.int64, device)
    _check(r, "r", (R, C), torch.float32, device)
    _check(halves, "halves", (R, S, 2), torch.int64, device)
    _check(rank, "rank", (R, S), torch.float32, device)
    if valid is not None:
        valid = valid.reshape(R, S).contiguous()
        _check(valid, "valid", (R, S), torch.bool, device)
    if halves.data_ptr() % 16:  # read as 16-byte pairs
        halves = halves.clone()
    key_out = torch.empty_like(key)
    r_out = torch.empty_like(r)
    disc = torch.empty((R,), dtype=torch.int32, device=device)
    ovf = torch.empty((R,), dtype=torch.bool, device=device)
    max_kept = torch.empty((R,), dtype=torch.float32, device=device)
    P = _Params(R=R, C=C, S=S, items=sort_items(S))
    bufs = _Buffers(*(None if t is None else t.data_ptr() for t in (
        key, r, halves, rank, valid, key_out, r_out, disc, ovf, max_kept)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mqt_stream_merge(ctypes.byref(P), ctypes.byref(bufs),
                                          stream)
    if err != 0:
        raise RuntimeError(f"stream merge launch failed: cudaError {err} "
                           f"(R={R}, C={C}, S={S})")
    stream_merge_counts.add_launch(R)
    return key_out, r_out, disc, ovf, max_kept
