"""What the port's kernel wrappers share, below all of them: the code tables
both kernels read, the plain versions' tables and Philox draws, the card
limits of both large variants, and the wrappers' launch counter and checks.

The window kernel (K2, ``ops/ladder_window.py``) and the sweep kernel (K1,
``ops/sweep.py``) read one set of tables, built here from the code alone
(``kernel_tables``, ``qubit_table``), as their CUDA sources share
``csrc/sweep.cuh``; ``utils/roofline.py`` counts their work from the same
tables.  Which shapes each kernel is built for is each wrapper's own list
(``ladder_window.WINDOW_SHAPES``, ``sweep.SWEEP_SHAPES``).
"""

from __future__ import annotations

import functools
import threading
from typing import Tuple

import numpy as np
import torch

from ..models.base import CodeSpec
from .dense_sweep import _color_tables
from .philox import philox4x32

# 64-bit words per bit plane of the kernels' register instantiations (a
# code's word count is rounded up to the next; the extra words stay zero).
# 16 words (nq <= 1024) is the most, and a spanned-word entry packs a word
# index in 4 bits.  Above 16 words the tables hold the code's exact word
# count, and both kernels' large variants read ``qubit_table``
KERNEL_WORDS = (1, 2, 3, 4, 6, 8, 12, 16)
# most words per plane the kernels' large variants take (nq <= 16384: a
# qubit-table entry names a qubit in 14 bits)
WIDE_WORDS = 256
# threads per block of both large variants (their launch bounds: at most 64
# registers a thread) and the warps an SM holds of them
WIDE_MAX_THREADS = 1024
WIDE_WARPS_PER_SM = 32
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# bound on Philox blocks materialised at once by the plain versions
_DRAW_BUDGET = 1 << 21
# components of the chain hash in the window kernel's trace mode, and bits
# per coefficient
N_KEY = 4
_KEY_BITS = 6
# bits of a qubit index in an entry of ``qubit_table``
_QUBIT_BITS = 14


class KernelCounter:
    """How often a kernel wrapper launched its kernel, how often it ran
    the plain version instead (CPU tensors), and the batch rows of those
    calls summed (``rows``: a window's syndrome rows, a sweep's chains).
    The wrappers count through ``add_launch`` and ``add_plain``, under a
    lock: the shards of ``parallel.map_shards`` launch from one host thread
    each."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.plain_calls = 0
        self.rows = 0

    def add_launch(self, rows: int = 0) -> None:
        with self._lock:
            self.launches += 1
            self.rows += rows

    def add_plain(self, rows: int = 0) -> None:
        with self._lock:
            self.plain_calls += 1
            self.rows += rows

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0
            self.rows = 0


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, state on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def key_coefficients(nq: int) -> np.ndarray:
    """(N_KEY, nq) int64 hash coefficients in [0, 64) of trace mode: the
    same draws as the TPU kernel's table (pallas_ladder.py:318-324)."""
    rng = np.random.RandomState(0x5EED ^ (nq * 7919))
    return np.stack([rng.randint(0, 64, size=nq) for _ in range(N_KEY)]).astype(
        np.int64
    )


# ---------------------------------------------------------------------------
# The plain versions' tables and draws
# ---------------------------------------------------------------------------


class _PlainTables:
    """Tables of the plain versions on one device.  States are held as
    int64 Pauli values with one extra always-zero column ``nq`` that
    padded stabilizer slots point at."""

    def __init__(self, spec: CodeSpec, device: torch.device):
        nq = spec.nq
        q1 = nq + 1
        v = np.arange(4)
        # per color: Pauli op per qubit (q1,), flat lookups of the change in
        # "qubit in error" and in "qubit is X / Y / Z" at (support slot,
        # value) (W * deg * 4,) and (3, W * deg * 4), the flattened support
        # (W * deg,), and the owning slot per qubit (q1,)
        self.colors = []
        for sel, xop, zop in _color_tables(spec):
            n = sel.shape[0]
            op = np.zeros(q1, np.int64)
            op[:nq] = xop.astype(np.int64) ^ (3 * zop.astype(np.int64))
            new = v[None, :] ^ op[:, None]  # (q1, 4) value after the op
            dtab = (new != 0).astype(np.int64) - (v[None, :] != 0)
            dtab3 = np.stack([(new == k).astype(np.int64) - (v[None, :] == k)
                              for k in (1, 2, 3)])
            deg = int(sel.sum(axis=1).max())
            supp = np.full((n, deg), nq, np.int64)
            owner = np.full(q1, n, np.int64)
            for j in range(n):
                qs = np.flatnonzero(sel[j])
                supp[j, : len(qs)] = qs
                owner[qs] = j
            flat = supp.reshape(-1)
            dsupp = dtab[flat].reshape(-1)
            dsupp3 = dtab3[:, flat].reshape(3, -1)
            self.colors.append(tuple(
                torch.as_tensor(a, device=device)
                for a in (op, dsupp, dsupp3, flat, owner)
            ) + (n, deg))
        draws = spec.logical_draws
        n_pos = [d.x_masks.shape[0] for d in draws]
        xm = np.zeros((len(draws), max(n_pos), q1), np.int64)
        zm = np.zeros_like(xm)
        for i, d in enumerate(draws):
            xm[i, : n_pos[i], :nq] = d.x_masks
            zm[i, : n_pos[i], :nq] = d.z_masks
        lut = np.stack([np.asarray(d.op_lut, bool) for d in draws])  # (nd, 4, 2)
        self.xm = torch.as_tensor(xm, device=device)
        self.zm = torch.as_tensor(zm, device=device)
        self.n_pos = torch.as_tensor(n_pos, dtype=torch.int64, device=device)
        self.lut_x = torch.as_tensor(lut[..., 0], device=device)
        self.lut_z = torch.as_tensor(lut[..., 1], device=device)
        self.draw_id = torch.arange(len(draws), device=device)
        pad = np.zeros((spec.n_class_bits, 1), np.int64)
        self.class_a = torch.as_tensor(
            np.concatenate([spec.class_A.astype(np.int64), pad], 1), device=device
        )
        self.class_b = torch.as_tensor(
            np.concatenate([spec.class_B.astype(np.int64), pad], 1), device=device
        )
        self.bit_w = 1 << torch.arange(spec.n_class_bits, device=device)
        self.b2e = torch.as_tensor(spec.bits_to_eq.astype(np.int64), device=device)
        keyc = np.zeros((N_KEY, q1), np.int64)
        keyc[:, :nq] = key_coefficients(nq)
        self.keyc = torch.as_tensor(keyc, device=device)
        self.paulis = torch.arange(1, 4, device=device)  # X, Y, Z values


@functools.lru_cache(maxsize=None)
def _plain_tables(spec: CodeSpec, device: torch.device) -> _PlainTables:
    return _PlainTables(spec, device)


def _draw_words(k0: int, k1: int, t0: int, t1: int, B: int, use0: int,
                n_uses: int, n_blocks: int, fixed, device) -> torch.Tensor:
    """Draws of uses [use0, use0 + n_uses) in steps [t0, t1):
    (t1 - t0, B, n_uses, 4 * n_blocks) int64 words in [0, 2**32), element
    e at [..., e]; every word is ``fixed`` unless it is None."""
    shape = (t1 - t0, B, n_uses, 4 * n_blocks)
    if fixed is not None:
        return torch.full(shape, fixed, dtype=torch.int64, device=device)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    c0 = ar(n_blocks).view(1, 1, 1, -1)
    c1 = ar(use0, use0 + n_uses).view(1, 1, -1, 1)
    c2 = ar(t0, t1).view(-1, 1, 1, 1)
    c3 = ar(B).view(1, -1, 1, 1)
    words = torch.stack(philox4x32(c0, c1, c2, c3, k0, k1), dim=-1)
    return words.reshape(shape)


# ---------------------------------------------------------------------------
# The kernels' tables
# ---------------------------------------------------------------------------


def kernel_words(nq: int) -> int:
    """64-bit words per bit plane of the kernels' tables for ``nq``: the
    register instantiation's (the next of KERNEL_WORDS) up to 16 words,
    the exact count above."""
    need = -(-nq // 64)
    return next((nw for nw in KERNEL_WORDS if nw >= need), need)


def is_wide(spec: CodeSpec) -> bool:
    """Whether ``spec`` needs more than KERNEL_WORDS[-1] words per plane:
    the kernels' large variants (no register instantiation holds its
    planes)."""
    return -(-spec.nq // 64) > KERNEL_WORDS[-1]


def _words(mask: np.ndarray, nw: int) -> np.ndarray:
    """(nq,) 0/1 mask -> (nw,) uint64 bit words (bit q of word q // 64)."""
    out = np.zeros(nw, np.uint64)
    for q in np.flatnonzero(mask):
        out[q // 64] |= np.uint64(1) << np.uint64(q % 64)
    return out


def _xz(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """X- and Z-component planes of a Pauli-valued array."""
    m = m.astype(np.int64)
    return (m & 1) ^ ((m >> 1) & 1), (m >> 1) & 1


def _pack_span(words, cx: int, cz: int, nw: int) -> int:
    """A stabilizer's entry in the spanned-word table of a code of ``nw``
    words per plane: the count of words its support spans (bits 0-3), the
    qubits its op flips in the X plane (bits 4-7) and in the Z plane (bits
    8-11) and, up to 16 words per plane, the word indices, 4 bits each from
    bit 12 (none above, where only the large variants run); both kernels'
    register instantiations read it."""
    v = len(words) | (cx << 4) | (cz << 8)
    if nw <= KERNEL_WORDS[-1]:
        for m, w in enumerate(words):
            v |= w << (12 + 4 * m)
    return v


def unpack_span(v: int):
    """(word indices, cx, cz) of a spanned-word entry ``v``."""
    n = v & 15
    return [(v >> (12 + 4 * m)) & 15 for m in range(n)], (v >> 4) & 15, (v >> 8) & 15


@functools.lru_cache(maxsize=None)
def kernel_tables(spec: CodeSpec):
    """(u64 table, int32 meta, offsets) the kernels read: per stabilizer
    (ordered by color) its support and op X/Z masks over all words (the
    sweep kernel's); per logical-draw position the X/Z planes of its x- and
    z-mask; per class bit its A/B masks; per hash component and coefficient
    bit the qubits whose coefficient has that bit; per stabilizer its
    support and op X/Z masks on only the words its support spans, ``span``
    triples each (zero-padded).  Meta: color starts, draw starts, op LUT,
    per stabilizer its packed spanned words (``unpack_span``), per color
    its first Philox block of a sweep use's draws (one block per four
    stabilizers), per such block its color, and bits_to_eq.  The window
    kernel reads the table from ``off_draw`` on, in either form
    (ops/ladder_window.py::window_form)."""
    nq = spec.nq
    nw = kernel_words(nq)
    tab, meta = [], []
    color_start = [0]
    spans = []  # per stabilizer: [(word, support, X op, Z op)], cx, cz
    for sel, xop, zop in _color_tables(spec):
        for row in sel:
            on = row.astype(bool)
            dense = (_words(on, nw), _words(on & (xop > 0), nw),
                     _words(on & (zop > 0), nw))
            tab += list(dense)
            spans.append(([(w, dense[0][w], dense[1][w], dense[2][w])
                           for w in range(nw) if dense[0][w]],
                          int((on & (xop > 0)).sum()), int((on & (zop > 0)).sum())))
        color_start.append(color_start[-1] + sel.shape[0])
    n_per_color = np.diff(color_start)
    off_draw = len(tab) * nw
    draw_start = [0]
    for d in spec.logical_draws:
        for p in range(d.x_masks.shape[0]):
            (xx, xz), (zx, zz) = _xz(d.x_masks[p]), _xz(d.z_masks[p])
            tab += [_words(xx, nw), _words(xz, nw), _words(zx, nw), _words(zz, nw)]
        draw_start.append(draw_start[-1] + d.x_masks.shape[0])
    off_class = len(tab) * nw
    for f in range(spec.n_class_bits):
        tab += [_words(spec.class_A[f], nw), _words(spec.class_B[f], nw)]
    off_key = len(tab) * nw
    for coef in key_coefficients(nq):
        tab += [_words((coef >> k) & 1, nw) for k in range(_KEY_BITS)]
    off_span = len(tab) * nw
    span = spanned_words(spec)
    for s, _, _ in spans:
        ent = np.zeros(3 * span, np.uint64)
        for m, (_, su, xs, zs) in enumerate(s):
            ent[3 * m: 3 * m + 3] = (su, xs, zs)
        tab.append(ent)
    meta += color_start
    m_draw = len(meta)
    meta += draw_start
    m_lut = len(meta)
    for d in spec.logical_draws:
        meta += [int(v) for v in np.asarray(d.op_lut).reshape(-1)]
    m_span = len(meta)
    meta += [_pack_span([w for w, *_ in s], cx, cz, nw) for s, cx, cz in spans]
    m_blk = len(meta)
    blk = np.concatenate([[0], np.cumsum(-(-n_per_color // 4))])
    meta += [int(v) for v in blk]
    m_bcol = len(meta)
    meta += [c for c, n in enumerate(np.diff(blk)) for _ in range(n)]
    m_b2e = len(meta)
    meta += [int(v) for v in spec.bits_to_eq]
    tab_np = np.concatenate(tab).view(np.int64)
    meta_np = np.asarray(meta, np.int32)
    offs = dict(n_tab=len(tab_np), n_meta=len(meta_np), off_draw=off_draw,
                off_class=off_class, off_key=off_key, off_span=off_span,
                span=span, m_draw=m_draw, m_lut=m_lut, m_span=m_span,
                m_blk=m_blk, m_bcol=m_bcol, n_blk=int(blk[-1]), m_b2e=m_b2e,
                n_colors=len(color_start) - 1, w_max=int(n_per_color.max()),
                nw=nw, n_stabs=len(spans))
    return tab_np, meta_np, offs


@functools.lru_cache(maxsize=None)
def qubit_table(spec: CodeSpec) -> np.ndarray:
    """(n_stabs,) int64 (the bits of a uint64) entries of both kernels'
    large variants, one per stabilizer in ``kernel_tables``' color order:
    qubit k (k < 4) of its support in bits 14k .. 14k + 13 and its op
    there, x | z << 1 (X 1, Y 3, Z 2), in bits 56 + 2k and 57 + 2k; a
    stabilizer of fewer qubits leaves op 0 (and qubit 0) in the rest.  A
    kernel reads a proposal's qubits from its entry alone
    (csrc/ladder_window.cu::entry_states).  A ``ValueError`` for a code of
    more than 2**14 qubits or a stabilizer of more than four."""
    if spec.nq > 1 << _QUBIT_BITS:
        raise ValueError(f"nq={spec.nq}: a qubit-table entry names qubits "
                         f"below {1 << _QUBIT_BITS}")
    out = []
    for sel, xop, zop in _color_tables(spec):
        for row in sel:
            qs = np.flatnonzero(row)
            if len(qs) > 4:
                raise ValueError(f"a stabilizer of {len(qs)} qubits: the "
                                 f"qubit table holds at most four")
            e = 0
            for k, q in enumerate(qs):
                op = int(xop[q] > 0) | (int(zop[q] > 0) << 1)
                e |= (int(q) << (_QUBIT_BITS * k)) | (op << (56 + 2 * k))
            out.append(e)
    return np.asarray(out, np.uint64).view(np.int64)


@functools.lru_cache(maxsize=None)
def spanned_words(spec: CodeSpec) -> int:
    """Entries per stabilizer of the spanned-word table (``kernel_tables``'
    ``span``, from the spec alone): the most 64-bit words one stabilizer's
    support spans, 3 padded to 4 (the register instantiations take 1, 2
    and 4)."""
    stabs = np.unique(spec.color_stabs[spec.color_stabs < spec.n_stabs])
    w = np.sort(np.where(spec.stab_ops[stabs] != 0,
                         spec.stab_qubits[stabs] // 64, -1), axis=1)
    first = np.ones_like(w, bool)  # the first of each run of one word
    first[:, 1:] = w[:, 1:] != w[:, :-1]
    span = int(((w >= 0) & first).sum(1).max())
    return span + (span == 3)


def lanes_per_rung(offs, Nc: int) -> int:
    """Lanes that split a rung's proposals in the window kernel's register
    form, and the most a chain takes in the sweep kernel's
    (ops/sweep.py::lanes_per_chain): a power of two, about one lane per
    four stabilizers of the widest color, at most 8 (toric d=5: 4, so a
    syndrome's five rungs fit one warp; xzzx d=13: 8)."""
    want = min(8, -(-offs["w_max"] // 4))
    return 1 << max(0, want - 1).bit_length()
