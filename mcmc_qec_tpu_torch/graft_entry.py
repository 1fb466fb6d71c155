"""Driver entry points of the port: one ladder step to check that the port
runs on a device, and the multi-device dry run.

Counterpart of the JAX package's root ``__graft_entry__.py`` (``entry``
and ``dryrun_multichip``), which stays the JAX package's own.  Both run on
the card unless the caller passes ``device="cpu"``; the dry run never falls
back to the CPU (JAX's self-configuring virtual CPU devices have no
counterpart here).
"""

from __future__ import annotations

import numpy as np
import torch

from .decoders.counting import SampleStream, make_sampler, z_direct_count
from .mcmc.ladder import (
    LadderState,
    beta_ladder_depolarizing,
    betas_depolarizing,
    init_ladder,
    make_ladder_step,
)
from .models import get_spec, np_syndrome
from .models.noise import sample_depolarizing
from .ops.engines import resolve_device, resolve_engine
from .ops.ladder_window import make_ladder_window
from .ops.pauli import all_class_states
from .parallel import make_mesh, map_shards, shard_batch


def entry(device="cuda"):
    """(fn, example_args): the flagship step, one parallel-tempering ladder
    step (Metropolis updates on every rung, replica exchange, class
    readout; ``mcmc/ladder.py::make_ladder_step``) on a batch of toric d=5
    syndromes, Nc=5, B=8, with every tensor on ``device``.
    ``fn(*example_args)`` returns (state, flag, tops0, bottom_eq)."""
    device = resolve_device(device)
    spec = get_spec("toric", 5)
    Nc, B = 5, 8
    step = make_ladder_step(spec, Nc, iters=10, p_logical=0.5)

    def fn(state, flag, tops0, seed, betas, generator):
        ls, bottom_eq, _, _ = step(LadderState(state, flag, tops0), seed,
                                   betas, generator)
        return ls.state, ls.flag, ls.tops0, bottom_eq

    ls0 = init_ladder(spec, torch.zeros((B, spec.nq), dtype=torch.uint8,
                                        device=device), Nc)
    example_args = (
        ls0.state, ls0.flag, ls0.tops0, 0,
        torch.as_tensor(beta_ladder_depolarizing(0.1, Nc), dtype=torch.float32,
                        device=device),
        torch.Generator(device=device).manual_seed(0),
    )
    return fn, example_args


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _syndromes_kept(spec, before: np.ndarray, rungs: np.ndarray) -> bool:
    """Every rung of every ladder (B, Nc, nq) has its syndrome's
    ``before`` (B, nq) syndrome."""
    syn0 = np.stack([np_syndrome(spec, s) for s in before])
    return all(
        np.array_equal(np.stack([np_syndrome(spec, s) for s in rungs[:, r]]),
                       syn0)
        for r in range(rungs.shape[1]))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Split the syndrome batch over a mesh of ``n_devices`` (cards, or
    CPU entries with ``device="cpu"``) and run one step of each part of
    the decode on tiny shapes, shard i under seed + i
    (``parallel.map_shards``):

    - the PT ladder step (``make_ladder_step``, its default engine);
    - the STDC sampler and the Z reduction, the sampler built as ``STDC``
      builds it from ``engine="auto"``: the sweep kernel K1's recording
      launch on a card.  JAX's dry run takes ``make_sampler``'s defaults,
      the literal engine; this one departs from it so that it launches
      both kernels;
    - the fused PT window (``ops/ladder_window.py::make_ladder_window``,
      K2 on a card).

    Checks the shapes, that every rung keeps its syndrome, and one top
    flag per ladder.  Asking for more cards than exist raises."""
    mesh = make_mesh(n_devices, device=device)
    spec = get_spec("toric", 3)
    B = 2 * n_devices
    Nc, K, D, steps = 3, spec.n_classes, 2, 4
    states = sample_depolarizing(torch.Generator().manual_seed(0), spec, 0.1,
                                 (B,)).numpy()
    shards = shard_batch(states, mesh)
    betas = beta_ladder_depolarizing(0.1, Nc).astype(np.float32)

    # --- PT ladder step ---
    ladder_step = make_ladder_step(spec, Nc, iters=2, p_logical=0.5)

    def pt_step(shard, seed):
        ls = init_ladder(spec, shard, Nc)
        gen = torch.Generator(device=shard.device).manual_seed(seed)
        ls, bottom_eq, _, _ = ladder_step(ls, seed, torch.as_tensor(
            betas, device=shard.device), gen)
        return ls.state.cpu().numpy(), bottom_eq.cpu().numpy()

    pt_state, bottom_eq = map_shards(pt_step, shards, 1)
    _check(pt_state.shape == (B, Nc, spec.nq) and bottom_eq.shape == (B,),
           f"PT step shapes {pt_state.shape}, {bottom_eq.shape}")
    _check(_syndromes_kept(spec, states, pt_state), "the PT step moved a "
           "syndrome")

    # --- STDC sampling and the Z reduction, the sampler of STDC's auto ---
    sampler = make_sampler(spec, steps, iters_per_step=1,
                           engine=resolve_engine("auto", "counting"),
                           equal_betas=True)
    be = betas_depolarizing(0.1).astype(np.float32)

    def stdc_step(shard, seed):
        b = torch.as_tensor(be, device=shard.device)
        seeds = all_class_states(spec, shard).movedim(0, 1)  # (B, K, nq)
        chains = seeds[:, :, None, :].expand(-1, -1, D, -1).contiguous()
        _, stream = sampler(chains, seed, b)
        n = shard.shape[0]
        merged = SampleStream(stream.keys.reshape(n, K, D * steps, 2),
                              stream.n_xyz.reshape(n, K, D * steps, 3))
        logz = z_direct_count(merged, b)
        return (torch.softmax(logz, -1) * 100.0).cpu().numpy()

    distr = map_shards(stdc_step, shards, 2)
    _check(distr.shape == (B, K) and np.isfinite(distr).all()
           and np.allclose(distr.sum(-1), 100.0, atol=1e-3),
           f"STDC percentages {distr}")

    # --- the fused PT window ---
    fused = make_ladder_window(spec, Nc, window=4, iters=2, p_logical=0.5,
                               tops_burn=1, energy_chunk=2)
    weights = np.ones(3, np.float32)

    def window(shard, seed):
        dev = shard.device
        ls = init_ladder(spec, shard, Nc)
        n = shard.shape[0]
        out = fused(ls.state, ls.flag, ls.tops0,
                    torch.zeros((n, K), dtype=torch.int32, device=dev),
                    torch.zeros((n,), dtype=torch.int32, device=dev), seed,
                    torch.as_tensor(betas, device=dev), weights)
        # the energies are (window // energy_chunk, n): batch first, to
        # join the shards
        return tuple(t.cpu().numpy() for t in out[:5]) + (
            out[5].T.cpu().numpy(),)

    st, fl, _, eq, _, en = map_shards(window, shards, 3)
    _check(st.shape == (B, Nc, spec.nq) and eq.shape == (B, K)
           and en.shape == (B, 2), f"window shapes {st.shape}, {eq.shape}, "
           f"{en.shape}")
    _check(_syndromes_kept(spec, states, st), "the window moved a syndrome")
    # exactly one top flag per ladder after the exchange's bookkeeping
    _check(bool((fl[:, -1] == 1).all()), f"top flags {fl}")
    print(f"dryrun_multichip ok: mesh={mesh.shape} on "
          f"{[str(d) for d in mesh.devices]}: PT step + STDC (engine auto) + "
          f"fused window over B={B} syndromes, {B // n_devices} per device")
