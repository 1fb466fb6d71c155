"""The literal Metropolis engine: one uniformly random stabilizer proposal
at a time per chain, with the unified vector-beta acceptance rule

    accept  <=>  log u < -(beta_x*dn_x + beta_y*dn_y + beta_z*dn_z)

(beta_i = -ln(p_i / (1 - p_total))), vectorised over any batch of chains.

Counterpart of ``mcmc_qec_tpu/ops/metropolis.py``.  This is the opt-in
parity engine (``engine="literal"``): the reference's own cadence
(src/mcmc.py:82-103), a long chain of dependent proposals, so on every
device it is latency-bound by design and runs as plain torch.  Each
update draws all its stabilizer indices and uniforms in one call each and
looks up all its supports at once; then each proposal is one gather of
the ``deg`` qubits, the new values and count change from two small
tables, the compare and one scatter.

Randomness is separated from the dynamics: ``draw_chain`` makes a
``ChainDraws`` from a ``torch.Generator`` and ``make_chain_update``
applies one, so a test can inject the exact draws the JAX package's
``make_chain_stepper`` makes from its keys (metropolis.py:84-95) and
compare trajectories bit for bit.  ``make_sweep_stepper``, the colored
sweep, is ``ops/dense_sweep.py::make_dense_sweep``: the JAX package keeps
two XLA forms of that one computation for TPU reasons.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.base import CodeSpec
from .pauli import draw_logicals, logical_masks


def _extended_tables(spec: CodeSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Stabilizer tables with pad entries redirected to sentinel qubit nq."""
    qubits = spec.stab_qubits.copy()
    qubits[spec.stab_ops == 0] = spec.nq
    return qubits, spec.stab_ops


def _dn_xyz(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-Pauli count change over a local support; trailing axis (3,),
    int32."""
    return torch.stack(
        [(new == p).sum(-1, dtype=torch.int32)
         - (old == p).sum(-1, dtype=torch.int32) for p in (1, 2, 3)], -1)


def _logr(betas: torch.Tensor, dn: torch.Tensor) -> torch.Tensor:
    """-(beta . dn) in f32, summed in order as ``jnp.sum`` over the (3,)
    axis does; an infinite beta times a zero change is NaN, which
    rejects."""
    t = betas * dn.to(torch.float32)
    return -((t[..., 0] + t[..., 1]) + t[..., 2])


class ChainDraws(NamedTuple):
    """The randomness of ``iters`` proposals on a batch of chains, leading
    axes (iters, *batch).  ``use_logical``, ``logical`` and
    ``logu_logical`` are None unless logical proposals are mixed in."""

    stab: torch.Tensor  # (iters, *batch) int64 stabilizer of the proposal
    logu: torch.Tensor  # (iters, *batch) f32 log-uniform of its acceptance
    use_logical: Optional[torch.Tensor] = None  # (iters, *batch) bool
    logical: Optional[torch.Tensor] = None  # (iters, *batch, n_draws, 3)
    logu_logical: Optional[torch.Tensor] = None  # (iters, *batch) f32


def _log_uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """log u, u uniform on [1e-38, 1) (metropolis.py:58-60)."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.log(u.clamp_(min=1e-38))


def draw_chain(spec: CodeSpec, iters: int, batch_shape, generator,
               device, p_logical=None) -> ChainDraws:
    """The draws of ``iters`` proposals on every chain of ``batch_shape``
    from ``generator`` (on ``device``): one call for the stabilizer
    indices and one for the uniforms, and with ``p_logical`` (a scalar or
    a tensor broadcastable to the batch) the logical proposals, the gate
    ``u < p_logical`` and their indices.  Only one proposal of a step is
    applied, so the logical proposal reuses the step's uniform."""
    shape = (iters,) + tuple(batch_shape)
    stab = torch.randint(0, spec.n_stabs, shape, generator=generator,
                         device=device)
    logu = _log_uniform(shape, generator, device)
    if p_logical is None:
        return ChainDraws(stab, logu)
    gate = torch.rand(shape, generator=generator, device=device)
    p = torch.as_tensor(p_logical, dtype=torch.float32, device=device)
    return ChainDraws(stab, logu, gate < p,
                      draw_logicals(spec, shape, generator, device), logu)


@functools.lru_cache(maxsize=None)
def _tables(spec: CodeSpec, device: torch.device):
    """(qubits (n_stabs, deg) int64 with pads at nq, ops (n_stabs, deg)
    int64, at [old value, op]: the new value (4, 4) uint8 and the
    per-Pauli count change (4, 4, 3) int32) on ``device``."""
    qubits, ops = _extended_tables(spec)
    v = np.arange(4)
    new = v[:, None] ^ v[None, :]
    dn = np.stack([(new == p).astype(np.int32) - (v[:, None] == p)
                   for p in (1, 2, 3)], -1)
    return tuple(torch.as_tensor(a, dtype=t, device=device) for a, t in (
        (qubits, torch.int64), (ops, torch.int64), (new, torch.uint8),
        (dn, torch.int32)))


def _stab_proposal(ext, betas, qid, op, logu, tabs):
    """One stabilizer proposal on every chain of ``ext`` (N, nq + 1), in
    place: the support ``qid`` (N, deg) and its op ``op`` (N, deg) int64,
    accepted where ``logu < -(betas . dn)`` (metropolis.py:84-95)."""
    newtab, dtab = tabs
    old = ext.gather(1, qid).to(torch.int64)
    dn = dtab[old, op].sum(-2, dtype=torch.int32)
    accept = logu < _logr(betas, dn)
    return ext.scatter_(1, qid, torch.where(accept[:, None], newtab[old, op],
                                            old.to(torch.uint8)))


def _logical_proposal(spec, ext, betas, logical, logu_logical):
    """The random-logical proposal on every chain (metropolis.py:97-115)."""
    nq = spec.nq
    state = ext[:, :nq]
    new = state ^ logical_masks(spec, logical)
    accept = logu_logical < _logr(betas, _dn_xyz(state, new))
    out = ext.clone()
    out[:, :nq] = torch.where(accept[:, None], new, state)
    return out


def make_chain_stepper(spec: CodeSpec, include_logical: bool = False):
    """One proposal on every chain of a batch: ``step(ext (N, nq + 1) u8,
    betas (N, 3) f32, stab (N,), logu (N,)[, use_logical (N,), logical
    (N, n_draws, 3), logu_logical (N,)]) -> ext``.  ``ext`` holds the
    states with an always-zero sentinel column ``nq`` that pad slots point
    at.  The stabilizer is uniform over all of them, which matches every
    family's _apply_random_stabilizer (metropolis.py:64-75); with
    ``include_logical`` a chain whose gate is set proposes the logical
    instead (metropolis.py:97-124)."""

    def step(ext, betas, stab, logu, use_logical=None, logical=None,
             logu_logical=None):
        qubits, ops, *tabs = _tables(spec, ext.device)
        s_stab = _stab_proposal(ext.clone(), betas, qubits[stab], ops[stab],
                                logu, tabs)
        if not include_logical:
            return s_stab
        s_log = _logical_proposal(spec, ext, betas, logical, logu_logical)
        return torch.where(use_logical[:, None], s_log, s_stab)

    return step


def make_chain_update(spec: CodeSpec, iters: int, include_logical: bool = False):
    """``update(states, generator, betas, p_logical=0.0, draws=None) ->
    states`` running ``iters`` sequential proposals on every chain of a
    batch (metropolis.py:129-166; ``Chain.update_chain``, src/mcmc.py:19-46).

    ``states``: (..., nq) uint8 on any device; ``betas``: broadcastable to
    (..., 3); ``p_logical``: broadcastable to (...,), used only with
    ``include_logical``.  The draws come from ``generator`` (a
    ``torch.Generator`` on the states' device) through ``draw_chain``, or
    ``draws`` (a ``ChainDraws`` with leading axes (iters, ...)) gives
    them.  The supports and ops of all ``iters`` proposals are looked up
    at once; each proposal is then a gather, the count change, the
    compare and a scatter."""
    nq = spec.nq

    def update(states, generator, betas, p_logical=0.0,
               draws: Optional[ChainDraws] = None):
        batch_shape = states.shape[:-1]
        device = states.device
        if draws is None:
            draws = draw_chain(spec, iters, batch_shape, generator, device,
                               p_logical if include_logical else None)
        N = int(np.prod(batch_shape, dtype=np.int64))
        b = torch.as_tensor(betas, dtype=torch.float32, device=device)
        b = b.expand(batch_shape + (3,)).reshape(N, 3)
        ext = torch.zeros((N, nq + 1), dtype=torch.uint8, device=device)
        ext[:, :nq] = states.reshape(N, nq)
        qubits, ops, *tabs = _tables(spec, device)
        stab = draws.stab.reshape(iters, N)
        qid, op = qubits[stab], ops[stab]  # (iters, N, deg)
        logu = draws.logu.reshape(iters, N)
        if include_logical:
            use = draws.use_logical.reshape(iters, N, 1)
            logical = draws.logical.reshape(
                (iters, N) + draws.logical.shape[-2:])
            logu_l = draws.logu_logical.reshape(iters, N)
        for t in range(iters):
            if include_logical:
                s_log = _logical_proposal(spec, ext, b, logical[t], logu_l[t])
                ext = torch.where(use[t], s_log, _stab_proposal(
                    ext, b, qid[t], op[t], logu[t], tabs))
            else:
                ext = _stab_proposal(ext, b, qid[t], op[t], logu[t], tabs)
        return ext[:, :nq].reshape(states.shape)

    return update


def make_sweep_stepper(spec: CodeSpec):
    """The colored multi-proposal sweep (metropolis.py:172-215): one call
    proposes every stabilizer once, grouped into conflict-free colors.  It
    is the same computation as ``make_dense_sweep`` (the JAX package's two
    forms, gather and bit-plane, exist for the TPU's sake), so this returns
    that function: ``sweep(states (..., nq) u8, seed, betas (3,) or (...,
    3)) -> states``."""
    from .dense_sweep import make_dense_sweep

    return make_dense_sweep(spec)
