"""One PTEQ parallel-tempering window: CUDA kernel and plain PyTorch version.

Counterpart of ``mcmc_qec_tpu/ops/pallas_ladder.py`` (the fused Pallas TPU
window).  ``make_ladder_window`` returns a function with the exact
``_get_window_fn`` contract of ``make_pallas_ladder_window``
(pallas_ladder.py:160-171).  It dispatches on the device of the state:

- a CUDA tensor launches ``csrc/ladder_window.cu`` (built with ``nvcc`` at
  first use, ``ops/_build.py``) once per window, or raises;
- a CPU tensor runs ``ladder_window_reference``, the plain version.

Only the production branch of the TPU kernel is ported: equal per-Pauli
betas, exactly-zero top-rung betas (always-accept logical mix), sequential
replica exchange, no traces (pteq.py:398-411 takes it for every
``beta_ladder_depolarizing`` ladder).

Randomness: every draw is Philox4x32-10 (``ops/philox.py``) word ``e % 4``
at counter ``(e // 4, use, step, row)`` under key ``(seed mod 2**32,
seed >> 32)``, where ``row`` is the syndrome's batch index, ``step`` the
window-local ladder step and ``e`` the element within the use.  Uses per
step, with ``G = iters * n_colors * Nc``:

- ``(it * n_colors + c) * Nc + r``: sweep ``it``, color ``c``, rung ``r``;
  element ``j`` is the uniform of the color's ``j``-th stabilizer;
- ``G``: top-mix gates, element ``it``;
- ``G + 1``: top-mix draws, element ``(it * n_draws + i) * 3 + k`` for
  (op, X position, Z position) of logical draw ``i``;
- ``G + 2``: exchange, element ``i`` for rung pair ``(i, i + 1)``.

No two draws share a counter, so no two are correlated (the overlap
ROADMAP.md §3 warns of).  ``rng="zeros"`` makes every draw 0: that is what
the Pallas TPU interpreter's PRNG returns on the CPU, so the zeros-mode
plain window reproduces ``make_pallas_ladder_window(..., interpret=True)``
output for output (tests/test_torch_ladder_window.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import CodeSpec
from .dense_sweep import _color_tables
from .philox import MASK32, philox4x32

# compile-time maximum of 64-bit words per bit plane in the kernel
MAX_WORDS = 2
# syndromes per block ceiling (threads per block = syndromes * Nc <= 1024)
MAX_SPB = 32
# bound on Philox blocks materialised at once by the plain version
_DRAW_BUDGET = 1 << 21

WindowOut = Tuple[torch.Tensor, ...]


class KernelCounter:
    """How often a kernel wrapper launched its kernel and how often it ran
    the plain version instead (CPU tensors)."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


# the ladder-window wrapper's counts (every function ``make_ladder_window``
# returns adds to it)
ladder_window_counts = KernelCounter()


def _rng_layout(spec: CodeSpec, Nc: int, iters: int) -> Tuple[int, int, int]:
    """(first non-sweep use G, Philox blocks per sweep use, Philox blocks
    per non-sweep use) of the layout above."""
    tables = _color_tables(spec)
    w_max = max(sel.shape[0] for sel, _, _ in tables)
    n_extra = max(iters, 3 * iters * len(spec.logical_draws), Nc - 1, 1)
    return iters * len(tables) * Nc, -(-w_max // 4), -(-n_extra // 4)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


class _PlainTables:
    """Tables of the plain version on one device.  States are held as
    int64 Pauli values with one extra always-zero column ``nq`` that
    padded stabilizer slots point at."""

    def __init__(self, spec: CodeSpec, device: torch.device):
        nq = spec.nq
        q1 = nq + 1
        v = np.arange(4)
        # per color: Pauli op per qubit (q1,), flat lookup of the change in
        # "qubit in error" at (support slot, value) (W * deg * 4,), the
        # flattened support (W * deg,), and the owning slot per qubit (q1,)
        self.colors = []
        for sel, xop, zop in _color_tables(spec):
            n = sel.shape[0]
            op = np.zeros(q1, np.int64)
            op[:nq] = xop.astype(np.int64) ^ (3 * zop.astype(np.int64))
            # change in "qubit is in error" when the color's op hits value v
            dtab = ((v[None, :] ^ op[:, None]) != 0).astype(np.int64) - (
                v[None, :] != 0
            )
            deg = int(sel.sum(axis=1).max())
            supp = np.full((n, deg), nq, np.int64)
            owner = np.full(q1, n, np.int64)
            for j in range(n):
                qs = np.flatnonzero(sel[j])
                supp[j, : len(qs)] = qs
                owner[qs] = j
            dsupp = dtab[supp.reshape(-1)].reshape(-1)
            self.colors.append(tuple(
                torch.as_tensor(a, device=device)
                for a in (op, dsupp, supp.reshape(-1), owner)
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


@functools.lru_cache(maxsize=None)
def _plain_tables(spec: CodeSpec, device: torch.device) -> _PlainTables:
    return _PlainTables(spec, device)


def _draw_words(k0: int, k1: int, t0: int, t1: int, B: int, use0: int,
                n_uses: int, n_blocks: int, zeros: bool, device) -> torch.Tensor:
    """Draws of uses [use0, use0 + n_uses) in steps [t0, t1):
    (t1 - t0, B, n_uses, 4 * n_blocks) int64 words in [0, 2**32), element
    e at [..., e]."""
    shape = (t1 - t0, B, n_uses, 4 * n_blocks)
    if zeros:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    c0 = ar(n_blocks).view(1, 1, 1, -1)
    c1 = ar(use0, use0 + n_uses).view(1, 1, -1, 1)
    c2 = ar(t0, t1).view(-1, 1, 1, 1)
    c3 = ar(B).view(1, -1, 1, 1)
    words = torch.stack(philox4x32(c0, c1, c2, c3, k0, k1), dim=-1)
    return words.reshape(shape)


def _class_ids(T: _PlainTables, s: torch.Tensor) -> torch.Tensor:
    """Class index of int64 Pauli states ``s`` (..., nq + 1)."""
    b0 = ((s & 1) ^ ((s >> 1) & 1)).unsqueeze(-2)
    b1 = ((s >> 1) & 1).unsqueeze(-2)
    feats = ((b0 & T.class_a).sum(-1) + (b1 & T.class_b).sum(-1)) & 1
    return T.b2e[(feats * T.bit_w).sum(-1)]


def ladder_window_reference(
    spec: CodeSpec,
    state: torch.Tensor,
    flag: torch.Tensor,
    tops0: torch.Tensor,
    eq_count: torch.Tensor,
    since_burn: torch.Tensor,
    seed: int,
    betas,
    weights,
    *,
    window: int,
    iters: int,
    p_logical: float,
    tops_burn: int,
    energy_chunk: int,
    rng: str = "philox",
) -> WindowOut:
    """Plain PyTorch version of one window (production branch of
    ``make_pallas_ladder_window``) on the device of ``state``.

    Same inputs and outputs as the kernel wrapper (see
    ``make_ladder_window``).  Per step: every color of every sweep updates
    all (syndrome, rung) chains at once through per-qubit lookup tables,
    the exchange runs on a per-syndrome rung permutation, and the class
    histogram and energy of the bottom rung are folded once per chunk."""
    device = state.device
    B, Nc, nq = state.shape
    T = _plain_tables(spec, device)
    C = energy_chunk
    f32 = torch.float32
    use_gate, n_blocks, n_xblocks = _rng_layout(spec, Nc, iters)
    n_draws = len(spec.logical_draws)
    k0, k1 = int(seed) & MASK32, (int(seed) >> 32) & MASK32
    zeros = rng == "zeros"

    S = torch.zeros((B, Nc, nq + 1), dtype=torch.int64, device=device)
    S[..., :nq] = state
    fl = flag.to(torch.int64)
    tops = tops0.to(torch.int64)
    eq = eq_count.to(torch.int64)
    since = since_burn.to(torch.int64)
    bfirst = torch.full((B,), -1, dtype=torch.int64, device=device)
    swaps = torch.zeros((B, max(Nc - 1, 0)), dtype=torch.int64, device=device)
    beta = torch.as_tensor(betas, dtype=f32, device=device).reshape(Nc, 3)[:, 0]
    beta_col = beta.view(1, Nc, 1)
    dbeta = beta[1:] - beta[:-1]
    w0 = torch.as_tensor(weights, dtype=f32, device=device).reshape(3)[0]
    inv_c = torch.tensor(np.float32(1.0 / C), device=device)
    two_m24 = torch.tensor(2.0 ** -24, dtype=f32, device=device)
    eps = torch.tensor(1e-12, dtype=f32, device=device)
    top_only = torch.zeros((1, Nc, 1), dtype=torch.int64, device=device)
    top_only[0, -1, 0] = 1
    rung_ids = torch.arange(Nc, device=device).expand(B, Nc)
    no_hit = torch.zeros((B, Nc, 1), dtype=torch.bool, device=device)
    slot4 = [4 * torch.arange(n * deg, device=device)
             for _, _, _, _, n, deg in T.colors]
    draw_e = (
        torch.arange(iters, device=device).view(-1, 1, 1) * n_draws
        + torch.arange(n_draws, device=device).view(1, -1, 1)
    ) * 3 + torch.arange(3, device=device)  # (iters, n_draws, 3)
    energies = torch.empty((window // C, B), dtype=f32, device=device)
    chunk_s, chunk_g, chunk_n = [], [], []

    per_step = B * (use_gate * n_blocks + 3 * n_xblocks)
    span = max(1, _DRAW_BUDGET // max(per_step, 1))
    for t0 in range(0, window, span):
        t1 = min(window, t0 + span)
        sweep_bits = _draw_words(k0, k1, t0, t1, B, 0, use_gate, n_blocks,
                                 zeros, device) >> 8
        logu = torch.log(sweep_bits.to(f32) * two_m24 + eps)
        bits24 = _draw_words(k0, k1, t0, t1, B, use_gate, 3, n_xblocks,
                             zeros, device) >> 8
        logu_sw = torch.log(bits24[:, :, 2].to(f32) * two_m24 + eps)
        for t in range(t0, t1):
            lt = t - t0
            # 1) colored sweeps on all (syndrome, rung) chains
            for it in range(iters):
                for c, (op, dsupp, supp, owner, n, deg) in enumerate(T.colors):
                    base = (it * len(T.colors) + c) * Nc
                    lu = logu[lt, :, base : base + Nc, :n]
                    vals = S.index_select(-1, supp)  # (B, Nc, n * deg)
                    dn = dsupp.take(vals + slot4[c]).view(B, Nc, n, deg).sum(-1)
                    acc = lu < -(beta_col * dn.to(f32))
                    hit = torch.cat([acc, no_hit], -1).index_select(-1, owner)
                    S = torch.where(hit, S ^ op, S)
            # 2) top-rung logical mix: every gated proposal accepts
            if p_logical > 0.0:
                u_gate = bits24[lt, :, 0, :iters].to(f32) * two_m24 + eps
                gate = u_gate < p_logical  # (B, iters)
                d = bits24[lt, :, 1][:, draw_e]  # (B, iters, n_draws, 3)
                opb = d[..., 0] % 4
                posx = d[..., 1] % T.n_pos
                posz = d[..., 2] % T.n_pos
                dox = T.lut_x[T.draw_id, opb] & gate[..., None]
                doz = T.lut_z[T.draw_id, opb] & gate[..., None]
                m = (T.xm[T.draw_id, posx] * dox[..., None]) ^ (
                    T.zm[T.draw_id, posz] * doz[..., None]
                )  # (B, iters, n_draws, nq + 1) Pauli masks
                mx = (((m & 1) ^ ((m >> 1) & 1)).sum((1, 2))) & 1
                mz = (((m >> 1) & 1).sum((1, 2))) & 1
                S = S ^ ((mx ^ (3 * mz)).unsqueeze(1) * top_only)
            # 3) sequential top->bottom exchange on counts after the mix
            N = (S != 0).sum(-1)  # (B, Nc)
            cols = torch.stack([rung_ids, N, fl], dim=-1)  # (B, Nc, 3)
            lsw = logu_sw[lt]
            for i in reversed(range(Nc - 1)):
                logr = dbeta[i] * (cols[:, i + 1, 1] - cols[:, i, 1]).to(f32)
                acc = lsw[:, i] < logr
                pair = cols[:, i : i + 2]
                cols = cols.clone()
                cols[:, i : i + 2] = torch.where(
                    acc[:, None, None], pair.flip(1), pair
                )
                swaps[:, i] += acc
            perm, N, fl = cols.unbind(-1)
            S = S.gather(1, perm.unsqueeze(-1).expand_as(S))
            # 4) flags (src/mcmc.py:100-103)
            fl = fl.clone()
            fl[:, -1] = 1
            arrived = fl[:, 0] == 1
            tops = tops + arrived
            fl[:, 0] = torch.where(arrived, 0, fl[:, 0])
            # 5) bottom-rung observation, folded per chunk
            burned = tops >= tops_burn
            since = since + burned
            bfirst = torch.where((bfirst < 0) & burned, t, bfirst)
            chunk_s.append(S[:, 0])
            chunk_g.append(burned)
            chunk_n.append(N[:, 0])
            if (t + 1) % C == 0:
                cls = _class_ids(T, torch.stack(chunk_s))  # (C, B)
                gated = torch.stack(chunk_g)[..., None]
                eq = eq + (F.one_hot(cls, spec.n_classes) * gated).sum(0)
                esum = torch.stack(chunk_n).sum(0)
                energies[t // C] = (w0 * esum.to(f32)) * inv_c
                chunk_s, chunk_g, chunk_n = [], [], []

    i32 = torch.int32
    return (
        S[..., :nq].to(torch.uint8),
        fl.to(i32),
        tops.to(i32),
        eq.to(i32),
        since.to(i32),
        energies,
        bfirst >= 0,
        bfirst.clamp(min=0).to(i32),
        swaps.to(i32),
    )


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """csrc/ladder_window.cu::WindowParams."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "Nc", "nq", "nw", "K", "n_bits", "n_colors", "n_draws",
        "window", "iters", "tops_burn", "energy_chunk", "zeros", "spb",
        "n_tab", "n_meta", "off_draw", "off_class", "m_draw", "m_lut", "m_b2e",
    )] + [(n, ctypes.c_float) for n in ("p_logical", "w0", "inv_chunk")] + [
        (n, ctypes.c_uint32) for n in ("key0", "key1")
    ]


class _Buffers(ctypes.Structure):
    """csrc/ladder_window.cu::WindowBuffers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "state_in", "state_out", "flag_in", "flag_out", "tops_in", "tops_out",
        "eq_in", "eq_out", "since_in", "since_out", "energies", "burn_any",
        "burn_first", "swap_acc", "betas", "tab", "meta",
    )]


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


@functools.lru_cache(maxsize=None)
def kernel_tables(spec: CodeSpec):
    """(u64 table, int32 meta, offsets) the kernel copies into shared
    memory: per stabilizer (ordered by color) its support and op X/Z masks;
    per logical-draw position the X/Z planes of its x- and z-mask; per class
    bit its A/B masks; color starts, draw starts, op LUT and bits_to_eq."""
    nq = spec.nq
    nw = -(-nq // 64)
    tab, meta = [], []
    color_start = [0]
    for sel, xop, zop in _color_tables(spec):
        for row in sel:
            on = row.astype(bool)
            tab += [_words(on, nw), _words(on & (xop > 0), nw),
                    _words(on & (zop > 0), nw)]
        color_start.append(color_start[-1] + sel.shape[0])
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
    meta += color_start
    m_draw = len(meta)
    meta += draw_start
    m_lut = len(meta)
    for d in spec.logical_draws:
        meta += [int(v) for v in np.asarray(d.op_lut).reshape(-1)]
    m_b2e = len(meta)
    meta += [int(v) for v in spec.bits_to_eq]
    tab_np = np.concatenate(tab).view(np.int64)
    meta_np = np.asarray(meta, np.int32)
    offs = dict(n_tab=len(tab_np), n_meta=len(meta_np), off_draw=off_draw,
                off_class=off_class, m_draw=m_draw, m_lut=m_lut, m_b2e=m_b2e,
                n_colors=len(color_start) - 1, nw=nw)
    return tab_np, meta_np, offs


def _syndromes_per_block(B: int, Nc: int, device: torch.device) -> int:
    """Spread the batch over about one block per SM: the window is
    latency-bound, so thin blocks on every SM beat full ones on a few."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    cap = max(1, min(MAX_SPB, 1024 // Nc))
    return max(1, min(cap, -(-B // n_sm)))


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
def _kernel_entry():
    """The kernel's C entry point, built and loaded on first use."""
    from . import _build

    fn = _build.load("ladder_window").mqt_ladder_window
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(spec, state, flag, tops0, eq_count, since_burn, seed, betas,
            weights, *, window, iters, p_logical, tops_burn, energy_chunk,
            zeros, device_tables) -> WindowOut:
    device = state.device
    B, Nc, nq = state.shape
    K = spec.n_classes
    if nq != spec.nq:
        raise ValueError(f"state has {nq} qubits, spec {spec.nq}")
    nw = -(-nq // 64)
    if nw > MAX_WORDS:
        raise NotImplementedError(
            f"nq={nq} needs {nw} words per plane; the kernel is built for at "
            f"most {MAX_WORDS} (nq <= {64 * MAX_WORDS})"
        )
    _check(state, "state", (B, Nc, nq), torch.uint8, device)
    _check(flag, "flag", (B, Nc), torch.int32, device)
    _check(tops0, "tops0", (B,), torch.int32, device)
    _check(eq_count, "eq_count", (B, K), torch.int32, device)
    _check(since_burn, "since_burn", (B,), torch.int32, device)
    betas_d = torch.as_tensor(betas, dtype=torch.float32, device=device)
    _check(betas_d, "betas", (Nc, 3), torch.float32, device)
    w0 = float(np.asarray(torch.as_tensor(weights, dtype=torch.float32).cpu())[0])

    tab_np, meta_np, offs = kernel_tables(spec)
    if device not in device_tables:
        device_tables[device] = (
            torch.as_tensor(tab_np, device=device),
            torch.as_tensor(meta_np, device=device),
        )
    tab, meta = device_tables[device]

    out = (
        torch.empty_like(state), torch.empty_like(flag), torch.empty_like(tops0),
        torch.empty_like(eq_count), torch.empty_like(since_burn),
        torch.empty((window // energy_chunk, B), dtype=torch.float32, device=device),
        torch.empty((B,), dtype=torch.bool, device=device),
        torch.empty((B,), dtype=torch.int32, device=device),
        torch.empty((B, Nc - 1), dtype=torch.int32, device=device),
    )
    if B == 0:
        return out
    P = _Params(
        B=B, Nc=Nc, nq=nq, nw=nw, K=K, n_bits=spec.n_class_bits,
        n_colors=offs["n_colors"], n_draws=len(spec.logical_draws),
        window=window, iters=iters, tops_burn=tops_burn,
        energy_chunk=energy_chunk, zeros=int(zeros),
        spb=_syndromes_per_block(B, Nc, device),
        n_tab=offs["n_tab"], n_meta=offs["n_meta"], off_draw=offs["off_draw"],
        off_class=offs["off_class"], m_draw=offs["m_draw"],
        m_lut=offs["m_lut"], m_b2e=offs["m_b2e"],
        p_logical=p_logical, w0=w0, inv_chunk=float(np.float32(1.0 / energy_chunk)),
        key0=int(seed) & MASK32, key1=(int(seed) >> 32) & MASK32,
    )
    st_o, fl_o, tp_o, eq_o, sb_o, en_o, ba_o, bf_o, sw_o = out
    bufs = _Buffers(*(t.data_ptr() for t in (
        state, st_o, flag, fl_o, tops0, tp_o, eq_count, eq_o, since_burn,
        sb_o, en_o, ba_o, bf_o, sw_o, betas_d, tab, meta,
    )))
    entry = _kernel_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(ctypes.byref(P), ctypes.byref(bufs), stream)
    if err != 0:
        raise RuntimeError(
            f"ladder_window kernel launch failed: cudaError {err} "
            f"(B={B}, Nc={Nc}, nq={nq}, spb={P.spb})"
        )
    ladder_window_counts.launches += 1
    return out


def make_ladder_window(
    spec: CodeSpec,
    Nc: int,
    window: int,
    iters: int,
    p_logical: float,
    tops_burn: int,
    energy_chunk: int = 1,
    top_exact: bool = False,
    equal_betas: bool = False,
    rng: str = "philox",
):
    """Build ``fn(state, flag, tops0, eq_count, since_burn, seed, betas,
    weights)`` running one PTEQ window of ``window`` ladder steps.

    Only the production branch is ported: the caller asserts with
    ``top_exact=True`` that the top rung's betas are zero (the logical mix
    always accepts) and with ``equal_betas=True`` that every rung has
    beta_x == beta_y == beta_z.  Anything else raises
    ``NotImplementedError``.

    Shapes (B = syndrome batch):
      state (B, Nc, nq) u8, flag (B, Nc) i32, tops0 (B,) i32,
      eq_count (B, K) i32, since_burn (B,) i32, seed int,
      betas (Nc, 3) f32 with beta_x == beta_y == beta_z per rung and a zero
      top rung, weights (3,) f32 (the energy uses weights[0]).
    Returns (state, flag, tops0, eq_count, since_burn,
             energies (window // energy_chunk, B) f32 chunk means,
             burn_any (B,) bool, burn_first (B,) i32,
             swap_acc (B, Nc-1) i32 accepted swaps per rung pair).

    The device of ``state`` decides: CUDA launches the kernel (one launch
    per call, counted in ``ladder_window_counts.launches``), CPU runs
    ``ladder_window_reference`` (counted in ``plain_calls``); any other
    device raises.  ``rng="zeros"`` makes every random draw 0 (parity
    tests and the chip smoke check only)."""
    if not (top_exact and equal_betas):
        raise NotImplementedError(
            "only top_exact=True with equal_betas=True is ported; the general "
            "sweep and logical mix are ROADMAP.md queue 2 (K2 branches)"
        )
    if window % energy_chunk != 0:
        raise ValueError(
            f"window ({window}) must be divisible by energy_chunk ({energy_chunk})"
        )
    if rng not in ("philox", "zeros"):
        raise ValueError(f"rng={rng!r}: expected 'philox' or 'zeros'")
    kw = dict(window=window, iters=iters, p_logical=float(p_logical),
              tops_burn=tops_burn, energy_chunk=energy_chunk)
    device_tables = {}

    def fn(state, flag, tops0, eq_count, since_burn, seed, betas, weights):
        if state.shape[1] != Nc:
            raise ValueError(f"state has {state.shape[1]} rungs, window {Nc}")
        if state.device.type == "cuda":
            return _launch(spec, state, flag, tops0, eq_count, since_burn,
                           seed, betas, weights, zeros=(rng == "zeros"),
                           device_tables=device_tables, **kw)
        if state.device.type == "cpu":
            ladder_window_counts.plain_calls += 1
            return ladder_window_reference(
                spec, state, flag, tops0, eq_count, since_burn, seed, betas,
                weights, rng=rng, **kw,
            )
        raise ValueError(f"no ladder window for device {state.device}")

    return fn
