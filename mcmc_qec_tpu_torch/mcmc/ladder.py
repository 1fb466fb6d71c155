"""Parallel-tempering ladder with replica exchange, batched over syndromes.

Counterpart of ``mcmc_qec_tpu/mcmc/ladder.py``: the numpy beta tables
(depolarizing, biased, alpha) are carried over unchanged, ``LadderState``
holds torch tensors, ``init_ladder`` replicates the initial states across
the rungs with the top rung flagged (src/mcmc.py:72-79).  The fused PTEQ
window runs its ladder inside one kernel (``ops/ladder_window.py``); the
unfused ladder step is here, in two forms:

- ``make_ladder_step``: ``iters`` Metropolis updates on every rung (the
  top rung mixing in logical proposals), then a replica-exchange sweep
  that reorders the rungs' states, with the flag/tops0 bookkeeping (the
  unfused PTEQ window);
- ``make_perm_ladder_step``: the chains keep their rows and carry their
  rung position instead, and every step records each rung's content key
  and X/Y/Z counts in rung order (PTDC, PTRC).  On a CUDA tensor its sweep
  is one launch of the sweep kernel's recording sampler for one step
  (``ops/sweep.py::make_recording_sweep``), at a row of betas per chain
  (``betas[pos]``), which returns the swept states, the keys and the counts
  together.

One swap rule, log r = sum_i (beta_hi_i - beta_lo_i) * (n_hi_i - n_lo_i),
covers every ladder; the exchange is sequential top->bottom (a replica can
fall the whole ladder in one step) or ``even_odd``.  Both steps run the
exchange in rung order on one small (B, Nc, 5) float32 table of (chain
index, flag, n_x, n_y, n_z), so each proposed pair is one compare and one
swap of two columns.  The JAX package's one-hot matmuls and 16-bit key
halves in the permutation step (ladder.py:387-389, 439-452) are a TPU
workaround: here the per-chain betas are a gather and the records one
gather by the rung-to-chain map.

Randomness: a step takes ``seed``, the sweep kernel's key for its sweeps
(``ops/sweep.py``), and a ``torch.Generator`` on the states' device for
every other draw: the literal engine's proposals, the top-rung logical mix
and, unless given, the exchange's uniforms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.base import CodeSpec
from ..ops.engines import resolve_engine
from ..ops.metropolis import _log_uniform, _logr, make_chain_update
from ..ops.pauli import (
    count_errors_xyz,
    draw_logicals,
    eq_class,
    logical_masks,
)


class LadderState(NamedTuple):
    """Batched ladder state: B independent ladders of Nc chains each."""

    state: torch.Tensor  # (B, Nc, nq) uint8
    flag: torch.Tensor  # (B, Nc) int32 — 1 marks the descendant of a top chain
    tops0: torch.Tensor  # (B,) int32 — count of top-flags reaching the bottom


def betas_xyz(p_x, p_y, p_z) -> np.ndarray:
    """beta_i = -ln(p_i / (1 - p_total)) (the unified acceptance form)."""
    p = p_x + p_y + p_z
    return -np.log(np.array([p_x, p_y, p_z]) / (1.0 - p))


def betas_depolarizing(p: float) -> np.ndarray:
    return betas_xyz(p / 3.0, p / 3.0, p / 3.0)


def beta_ladder_depolarizing(p_bottom: float, Nc: int, p_top: float = 0.75) -> np.ndarray:
    """linspace p-ladder bottom -> 0.75 (src/mcmc.py:62-66)."""
    ps = np.linspace(p_bottom, p_top, Nc)
    return np.stack([betas_depolarizing(p) for p in ps])


def beta_ladder_biased(p_bottom: float, eta: float, Nc: int) -> np.ndarray:
    """p_top = (eta+1)/(2*eta+1) (src/mcmc_biased.py:83-86)."""
    p_top = (eta + 1.0) / (2.0 * eta + 1.0)
    ps = np.linspace(p_bottom, p_top, Nc)
    out = []
    for p in ps:
        pz = p * eta / (eta + 1.0)
        px = p / (2.0 * (eta + 1.0))
        out.append(betas_xyz(px, px, pz))
    return np.stack(out)


def beta_ladder_alpha(pz_tilde_bottom: float, alpha: float, Nc: int) -> np.ndarray:
    """pz_tilde ladder bottom -> 1 (src/mcmc_alpha.py:94-98); the unified
    betas are beta_z = -ln pz_tilde, beta_x = beta_y = -alpha ln pz_tilde."""
    pzt = np.linspace(pz_tilde_bottom, 1.0, Nc)
    bz = -np.log(np.maximum(pzt, 1e-30))
    return np.stack([alpha * bz, alpha * bz, bz], axis=-1)


def init_ladder(spec: CodeSpec, init_states: torch.Tensor, Nc: int) -> LadderState:
    """Replicate (B, nq) uint8 initial states across Nc rungs on their
    device; the top rung starts flagged (src/mcmc.py:72-79)."""
    if init_states.dim() != 2 or init_states.shape[1] != spec.nq:
        raise ValueError(
            f"init_states must be (B, {spec.nq}), got {tuple(init_states.shape)}"
        )
    B = init_states.shape[0]
    device = init_states.device
    state = (
        init_states.to(torch.uint8).unsqueeze(1).expand(B, Nc, spec.nq)
        .contiguous()
    )
    flag = torch.zeros((B, Nc), dtype=torch.int32, device=device)
    flag[:, -1] = 1
    tops0 = torch.zeros((B,), dtype=torch.int32, device=device)
    return LadderState(state=state, flag=flag, tops0=tops0)


# ---------------------------------------------------------------------------
# Replica exchange
# ---------------------------------------------------------------------------


def _check_exchange(exchange: str) -> None:
    if exchange not in ("sequential", "even_odd"):
        # "none" exists only as a fused-kernel ablation in the JAX package
        raise ValueError(
            f"exchange={exchange!r}: expected 'sequential' or 'even_odd'"
        )


def _pairs(Nc: int, exchange: str):
    """The rung pairs (i, i + 1) in the order they are proposed: top to
    bottom, or every even pair and then every odd one (ladder.py:243-258)."""
    if exchange == "even_odd":
        return [i for ph in (0, 1) for i in range(ph, Nc - 1, 2)]
    return list(reversed(range(Nc - 1)))


def _exchange(table: torch.Tensor, betas: torch.Tensor, logu: torch.Tensor,
              exchange: str):
    """Replica exchange over a (B, Nc, 5) f32 rung-order table of (chain
    index, flag, n_x, n_y, n_z), in place: the j-th proposed pair (i, i +
    1) swaps its two rows where ``logu[j] < sum((betas[i+1] - betas[i]) *
    (n[i+1] - n[i]))`` (ladder.py:225-232), the sum over X, Y, Z in that
    order.  Returns the table and the (B, Nc - 1) int32 accepted swaps by
    pair.  Eight small kernels a pair: the host's launches, not the
    device, set the pace of this loop on the card."""
    Nc = table.shape[1]
    accepts = [None] * (Nc - 1)
    d_beta = betas[1:] - betas[:-1]  # (Nc - 1, 3)
    for j, i in enumerate(_pairs(Nc, exchange)):
        pair = table[:, i:i + 2]
        t = (pair[:, 1, 2:] - pair[:, 0, 2:]) * d_beta[i]
        acc = logu[j] < (t[:, 0] + t[:, 1]) + t[:, 2]
        accepts[i] = acc
        pair.copy_(torch.where(acc[:, None, None], pair.flip(1), pair))
    if Nc == 1:
        return table, torch.zeros((table.shape[0], 0), dtype=torch.int32,
                                  device=table.device)
    return table, torch.stack(accepts, 1).to(torch.int32)


def _exchange_table(chain, flag, n_xyz) -> torch.Tensor:
    """(B, Nc, 5) f32 (chain index, flag, n_x, n_y, n_z) in rung order;
    every entry is a small integer, exact in f32."""
    f32 = torch.float32
    return torch.cat([chain.to(f32)[..., None], flag.to(f32)[..., None],
                      n_xyz.to(f32)], -1)


def _flags_after(table: torch.Tensor, tops0: torch.Tensor):
    """Flag bookkeeping on the table's rung-order flags, in place
    (src/mcmc.py:100-103): the top rung is flagged, a flag at the bottom
    counts one round trip and is cleared.  Returns (flag (B, Nc) int32,
    tops0 int32)."""
    flag = table[..., 1]
    flag[:, -1] = 1
    tops0 = tops0 + flag[:, 0].to(torch.int32)
    flag[:, 0] = 0
    return flag.to(torch.int32), tops0


# ---------------------------------------------------------------------------
# Ladder step (physical order)
# ---------------------------------------------------------------------------


def make_ladder_step(
    spec: CodeSpec,
    Nc: int,
    iters: int = 10,
    p_logical: float = 0.5,
    engine: str = "literal",
    top_exact_accept: bool = False,
    exchange: str = "sequential",
):
    """Build ``step(ls, seed, betas, generator) -> (ls, bottom_eq (B,),
    bottom_n_xyz (B, 3) f32, swap_acc (B, Nc-1) int32)`` (ladder.py:101-293).

    One call is ``iters`` Metropolis updates on every rung, then the
    replica-exchange sweep with flag/tops0 bookkeeping.  ``betas`` is the
    (Nc, 3) f32 ladder on the states' device; ``seed`` keys the sweep
    kernel, ``generator`` (on the states' device) draws everything else.

    engine="literal" (and every engine that is not "sweep" once resolved
    for the "chain" family): one update is one random-stabilizer proposal,
    the top rung proposing a logical w.p. ``p_logical``.
    engine="sweep": ``iters`` colored sweeps of every chain at its rung's
    betas, one launch of the sweep kernel on the card
    (``ops/dense_sweep.py::make_dense_sweep``); the top rung then runs
    ``iters`` rounds of logical mixing: with ``top_exact_accept`` (zero
    top betas, where every proposal accepts and the masks commute) one XOR
    of the gated masks, else ``iters`` Metropolis rounds.
    """
    _check_exchange(exchange)
    engine = resolve_engine(engine, "chain")
    update = make_chain_update(spec, iters, include_logical=(p_logical > 0))
    if engine == "sweep":
        from ..ops.dense_sweep import make_dense_sweep

        sweep_fn = make_dense_sweep(spec, iters)

    def gated_masks(B, generator, device):
        """(iters, B, nq) random-logical masks, each kept w.p. p_logical."""
        gate = torch.rand((iters, B), generator=generator, device=device)
        idx = draw_logicals(spec, (iters, B), generator, device)
        masks = logical_masks(spec, idx)
        return masks * (gate < p_logical).to(torch.uint8)[..., None]

    def top_logical_mix(top, betas_top, generator):
        B = top.shape[0]
        masks = gated_masks(B, generator, top.device)
        if top_exact_accept:
            total = masks[0]
            for t in range(1, iters):
                total = total ^ masks[t]
            return top ^ total
        logu = _log_uniform((iters, B), generator, top.device)
        n_top = count_errors_xyz(top)
        for t in range(iters):
            new = top ^ masks[t]
            n_new = count_errors_xyz(new)
            accept = logu[t] < _logr(betas_top, n_new - n_top)
            top = torch.where(accept[:, None], new, top)
            n_top = torch.where(accept[:, None], n_new, n_top)
        return top

    p_log = {}  # device -> (Nc,) logical-proposal rate, the top rung's only

    def top_rate(device):
        if device not in p_log:
            v = torch.zeros(Nc, device=device)
            v[-1] = p_logical
            p_log[device] = v
        return p_log[device]

    def step(ls: LadderState, seed: int, betas: torch.Tensor,
             generator: torch.Generator, logu_swap=None):
        state, flag, tops0 = ls
        B = state.shape[0]
        device = state.device
        betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
        # 1) Metropolis on every rung
        if engine == "sweep":
            state = sweep_fn(state, seed, betas.expand(B, Nc, 3))
            if p_logical > 0:
                state[:, -1] = top_logical_mix(state[:, -1], betas[-1],
                                               generator)
        else:
            state = update(state, generator, betas, top_rate(device))
        # 2) replica exchange on the rung order, then one gather of the
        #    states
        if logu_swap is None:
            logu_swap = _log_uniform((Nc - 1, B), generator, device)
        chain = torch.arange(Nc, device=device).expand(B, Nc)
        table, swap_acc = _exchange(
            _exchange_table(chain, flag, count_errors_xyz(state)), betas,
            logu_swap, exchange)
        perm = table[..., 0].to(torch.int64)
        state = state.gather(1, perm[..., None].expand(B, Nc, spec.nq))
        # 3) flag bookkeeping
        flag, tops0 = _flags_after(table, tops0)
        bottom_eq = eq_class(spec, state[:, 0])
        return (LadderState(state, flag, tops0), bottom_eq, table[:, 0, 2:],
                swap_acc)

    return step


# ---------------------------------------------------------------------------
# Ladder step carrying rung positions (PTDC/PTRC)
# ---------------------------------------------------------------------------


class PermLadderState(NamedTuple):
    """Ladder state for position-carrying runs: ``state`` stays in
    physical chain order across steps; ``pos[b, j]`` is the rung that
    physical chain j holds; ``flag`` is per chain (the top-descendant
    marker travels with its chain)."""

    state: torch.Tensor  # (B, Nc, nq) uint8, physical order
    flag: torch.Tensor  # (B, Nc) int32, per chain
    tops0: torch.Tensor  # (B,) int32
    pos: torch.Tensor  # (B, Nc) int64, chain -> rung position


def perm_enter(ls: LadderState) -> PermLadderState:
    """Start carrying positions: every chain at its own rung (the flags of
    a LadderState are by rung, which is by chain here)."""
    B, Nc = ls.flag.shape
    pos = torch.arange(Nc, device=ls.flag.device).expand(B, Nc).contiguous()
    return PermLadderState(ls.state, ls.flag, ls.tops0, pos)


def _at_rung(pos: torch.Tensor) -> torch.Tensor:
    """(B, Nc) int64 chain at each rung: the inverse of ``pos``."""
    Nc = pos.shape[1]
    rung = torch.arange(Nc, device=pos.device).expand_as(pos)
    return torch.empty_like(pos).scatter_(1, pos, rung)


def perm_exit(pls: PermLadderState) -> LadderState:
    """Rung order again, with one gather of the states."""
    at = _at_rung(pls.pos)
    B, Nc, nq = pls.state.shape
    state = pls.state.gather(1, at[..., None].expand(B, Nc, nq))
    return LadderState(state, pls.flag.gather(1, at), pls.tops0)


def make_perm_ladder_step(
    spec: CodeSpec,
    Nc: int,
    iters: int = 10,
    engine: str = "sweep",
    exchange: str = "sequential",
    timing=None,
):
    """Position-carrying ladder step for the PT counting samplers
    (ladder.py:328-463), no logical mixing: ``step(pls, seed, betas,
    generator, logu_swap=None) -> (pls, keys (B, Nc, 2) int64, n_xyz (B,
    Nc, 3) int32, swap_acc (B, Nc-1) int32)``, the records of every rung
    after the exchange, in rung order (``pack_key`` halves and
    ``count_errors_xyz`` of ``perm_exit``'s states).

    Chain j runs at ``betas[pos[b, j]]``.  engine="sweep" (and "pallas",
    the "chain" family's mapping): ``iters`` colored sweeps, then the
    record, in one recording launch of the sweep kernel for one step under
    ``seed`` (an int, or a (1,) int64 tensor on the states' device that
    needs no copy); engine="literal": ``iters`` proposals from
    ``generator``, then ``pack_key`` and the counts in torch.
    ``logu_swap`` (Nc - 1, B) gives the exchange's log-uniforms, one row
    per proposed pair (a sampler draws a stream window's at once); else
    ``generator`` draws them.  ``timing`` (``decoders/streaming.py``'s
    ``StreamTiming``) gets the device time of the sweep and of the rest of
    the step (exchange, flags, records) as parts "sweep" and "exchange"."""
    from ..ops.pauli import make_hash_mults, pack_key
    from ..ops.sweep import make_recording_sweep

    _check_exchange(exchange)
    engine = resolve_engine(engine, "chain")
    if engine == "sweep":
        record = make_recording_sweep(spec, 1, iters, equal_betas=False)
    else:
        update = make_chain_update(spec, iters, include_logical=False)
    mults = make_hash_mults(spec)
    mults_d = {}
    rungs = {}  # (B, device) -> the (B, Nc) int64 rung index

    def rung_index(B, device):
        if (B, device) not in rungs:
            rungs[(B, device)] = torch.arange(Nc, device=device).expand(
                B, Nc).contiguous()
        return rungs[(B, device)]

    def step(pls: PermLadderState, seed, betas: torch.Tensor,
             generator: Optional[torch.Generator], logu_swap=None):
        state, flag, tops0, pos = pls
        B = state.shape[0]
        nq = spec.nq
        device = state.device
        betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
        t0 = timing.mark(device) if timing else None
        betas_chain = betas[pos]  # (B, Nc, 3)
        # 1) Metropolis on every chain at its rung's betas, and the records
        #    in physical order
        if engine == "sweep":
            if not isinstance(seed, torch.Tensor):
                seed = torch.tensor([int(seed)], dtype=torch.int64)
            flat, keys, n_phys = record(state.reshape(B * Nc, nq), seed,
                                        betas_chain.reshape(B * Nc, 3))
            state = flat.view(B, Nc, nq)
            keys = keys.view(B, Nc, 2)
            n_phys = n_phys.view(B, Nc, 3)
        else:
            state = update(state, generator, betas_chain)
            if device not in mults_d:
                mults_d[device] = torch.as_tensor(mults.astype(np.int64),
                                                  device=device)
            keys = pack_key(spec, state, mults_d[device])
            n_phys = count_errors_xyz(state)
        t1 = timing.mark(device) if timing else None
        # 2) replica exchange in rung order
        if logu_swap is None:
            logu_swap = _log_uniform((Nc - 1, B), generator, device)
        rung = rung_index(B, device)
        at = torch.empty_like(pos).scatter_(1, pos, rung)  # rung -> chain
        phys = _exchange_table(rung, flag, n_phys)  # in chain order
        table, swap_acc = _exchange(
            phys.gather(1, at[..., None].expand(B, Nc, 5)), betas, logu_swap,
            exchange)
        at = table[..., 0].to(torch.int64)
        # 3) flag bookkeeping, then back to chain order
        flag_r, tops0 = _flags_after(table, tops0)
        pos = torch.empty_like(at).scatter_(1, at, rung)
        flag = torch.empty_like(flag_r).scatter_(1, at, flag_r)
        keys_pos = keys.gather(1, at[..., None].expand(B, Nc, 2))
        n_pos = table[..., 2:].to(torch.int32)
        if timing:
            timing.add("sweep", t0, t1)
            timing.add("exchange", t1, timing.mark(device))
        return (PermLadderState(state, flag, tops0, pos), keys_pos, n_pos,
                swap_acc)

    return step
