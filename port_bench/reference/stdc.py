"""STDC worked out again for chosen syndromes of a batch, in plain torch.

Direct counting (decoders.py:268-322 of the upstream project, with the
bounded buffer of its streamed form): for every class of a syndrome,
``droplets`` chains start from one state of that class and syndrome, each
randomised by a uniform half of the checks ("rain"), and run ``steps``
recording steps of one coloured Metropolis sweep at the sampling
temperature.  Every visited chain's content key (two 32-bit universal
hashes) and its X, Y, Z counts are recorded.  Z of a class is the sum of
exp(-w) over the distinct keys it visited, w = sum_i beta_err_i n_i, kept to
the ``capacity`` smallest (w, key); the result is Z over its sum, in percent.

Draws: the rain and the sampling seed come from the decode seed through
``torch`` generators (a CPU one for the seeds, one on the device for the
rain, drawn over the whole batch so that every row gets the decoder's
draws); step s sweeps under the s-th seed of a CPU generator seeded with the
sampling seed, check j of colour c of chain n taking Philox word j % 4 at
counter (j // 4, c, 0, n).

``dtype`` is the precision of the acceptance test (float32, or bfloat16
for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox
from .codes import Code, class_bits_np

MASK32 = 0xFFFFFFFF


def betas_depolarizing(p: float) -> np.ndarray:
    """beta_i = -ln(p_i / (1 - (p_x + p_y + p_z))) with p_i = p / 3, in
    float64 and then rounded to float32."""
    pi = p / 3.0
    return (-np.log(np.array([pi, pi, pi]) / (1.0 - (pi + pi + pi)))
            ).astype(np.float32)


def hash_mults(nq: int) -> np.ndarray:
    """(2, nq) int64 odd multipliers of the content key."""
    rng = np.random.RandomState(0x9E3779B9 & 0x7FFFFFFF)
    m = rng.randint(0, 1 << 31, size=(2, nq), dtype=np.int64) * 2 + 1
    return m.astype(np.uint32).astype(np.int64)


def class_seeds(code: Code, states: torch.Tensor) -> torch.Tensor:
    """(B, K, nq): the start state moved to every class, syndrome kept."""
    cur = class_bits_np(code.class_a, code.class_b, states.cpu().numpy())
    masks = torch.as_tensor(code.delta_masks, device=states.device)
    out = [states ^ masks[torch.as_tensor(cur ^ k, device=states.device)]
           for k in range(code.n_classes)]
    return torch.stack(out, 1)


def decode_seeds(seed: int, steps: int):
    """(rain seed, per-step sweep seeds (steps,) int64) of a decode seed."""
    gen = torch.Generator().manual_seed(int(seed))
    rain_seed, samp_seed = torch.randint(0, 2**62, (2,), generator=gen).tolist()
    g2 = torch.Generator().manual_seed(int(samp_seed))
    return rain_seed, torch.randint(0, 2**31 - 1, (steps,), generator=g2)


def rained(code: Code, states: torch.Tensor, droplets: int, rain_seed: int,
           pick: torch.Tensor) -> torch.Tensor:
    """(len(pick), K, droplets, nq): the droplets of batch rows ``pick``,
    each XORed with the checks its uniform draw selects."""
    B, nq = states.shape
    K = code.n_classes
    cs = class_seeds(code, states)
    gen = torch.Generator(device=states.device).manual_seed(int(rain_seed))
    sel = torch.rand((B, K, droplets, code.n_stabs), generator=gen,
                     device=states.device) < 0.5
    sel, cs = sel[pick], cs[pick]
    masks = torch.as_tensor(code.stab_masks, device=states.device)
    out = cs[:, :, None, :].expand(len(pick), K, droplets, nq).clone()
    for s in range(code.n_stabs):
        out ^= sel[..., s:s + 1].to(torch.uint8) * masks[s]
    return out


def _graphed(fn, state: torch.Tensor):
    """``fn`` (in-place on ``state`` and its other fixed inputs) captured
    once as a CUDA graph, so that each call is one launch; the same
    operations as ``fn``."""
    keep = state.clone()
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        run = graph.replay
    except RuntimeError:
        run = fn
    state.copy_(keep)
    return run


def sample(code: Code, states: torch.Tensor, chain_ids: torch.Tensor,
           seeds: torch.Tensor, beta: float, dtype=torch.float32):
    """Run one sweep a step under each of ``seeds`` on chains ``states``
    (N, nq) u8, whose Philox rows are ``chain_ids`` (N,); ``seeds`` is
    (steps,) for all chains or (steps, N), one per chain; returns (states,
    keys (N, steps, 2) int64 hash halves, counts (N, steps, 3) int32)."""
    dev = states.device
    N, nq = states.shape
    steps = len(seeds)
    S = states.to(torch.int64)
    cols = [(torch.as_tensor(code.stab_qubits[c], device=dev),
             torch.as_tensor(code.stab_ops[c, :1].astype(np.int64), device=dev))
            for c in code.colors]
    nb = -(-max(len(c) for c in code.colors) // 4)
    m = torch.as_tensor(hash_mults(nq), device=dev)
    two_m24 = torch.tensor(2.0 ** -24, dtype=dtype, device=dev)
    eps = torch.tensor(1e-12, dtype=dtype, device=dev)
    b = torch.tensor(float(np.float32(beta)), dtype=torch.float32,
                     device=dev).to(dtype)
    keys = torch.empty((N, steps, 2), dtype=torch.int64, device=dev)
    counts = torch.empty((N, steps, 3), dtype=torch.int32, device=dev)
    span = int(np.clip((1 << 23) // (N * len(cols) * 4 * nb), 1, 64))
    buf = torch.empty((span, N, nq), dtype=torch.int64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    c0 = torch.arange(nb, **i64).view(1, 1, 1, -1)
    c1 = torch.arange(len(cols), **i64).view(1, 1, -1, 1)
    c2 = torch.zeros(1, **i64).view(1, 1, 1, 1)
    c3 = chain_ids.to(dev, torch.int64).view(1, -1, 1, 1)
    seeds = seeds.to(dev, torch.int64)
    lu = torch.empty((N, len(cols), 4 * nb), dtype=dtype, device=dev)

    def sweep():
        for c, (supp, op) in enumerate(cols):
            n = supp.shape[0]
            v = S[:, supp]
            nv = v ^ op
            dn = ((nv != 0).sum(-1) - (v != 0).sum(-1)).to(dtype)
            acc = (lu[:, c, :n] < -(b * dn)).unsqueeze(-1)
            S[:, supp.reshape(-1)] = torch.where(acc, nv, v).reshape(N, -1)

    step = _graphed(sweep, S) if dev.type == "cuda" else sweep
    for s0 in range(0, steps, span):
        s1 = min(steps, s0 + span)
        k = seeds[s0:s1]
        k = k.view(-1, 1, 1, 1) if k.dim() == 1 else k[:, :, None, None]
        w = torch.stack(philox.philox(c0, c1, c2, c3, k & MASK32,
                                      (k >> 32) & MASK32), -1)
        w = w.reshape(s1 - s0, N, len(cols), 4 * nb)
        logu = torch.log((w >> 8).to(dtype) * two_m24 + eps)
        for s in range(s0, s1):
            lu.copy_(logu[s - s0])
            step()
            buf[s - s0] = S
        blk = buf[:s1 - s0]
        keys[:, s0:s1] = ((blk.unsqueeze(-2) * m).sum(-1) & MASK32
                          ).transpose(0, 1)
        counts[:, s0:s1] = torch.stack([(blk == v).sum(-1) for v in (1, 2, 3)],
                                       -1).transpose(0, 1).to(torch.int32)
    return S.to(torch.uint8), keys, counts


def percentages(keys: torch.Tensor, counts: torch.Tensor, beta_err,
                capacity: int) -> torch.Tensor:
    """(rows, K) percentages from each class's samples: ``keys`` (rows, K,
    S, 2) hash halves, ``counts`` (rows, K, S, 3)."""
    b = torch.as_tensor(beta_err, dtype=torch.float32, device=keys.device)
    w = torch.where(counts > 0, counts.to(torch.float32) * b, 0.0).sum(-1)
    rows, K, S = keys.shape[:3]
    k = ((keys[..., 0] - 2**31) * 2**32 + keys[..., 1]).reshape(rows * K, S)
    w = w.reshape(rows * K, S)
    sk, order = torch.sort(k, dim=-1, stable=True)
    sw = w.gather(-1, order)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    rr = torch.where(first, sw, torch.inf)
    rr, o2 = torch.sort(rr, dim=-1, stable=True)
    if rr.shape[-1] < capacity:
        pad = capacity - rr.shape[-1]
        rr = torch.cat([rr, torch.full((rr.shape[0], pad), torch.inf,
                                       device=rr.device)], -1)
    r = rr[:, :capacity]
    fin = torch.isfinite(r)
    neg = torch.where(fin, -r, -torch.inf)
    mx = neg.amax(-1, keepdim=True)
    safe = torch.where(torch.isfinite(mx), mx, 0.0)
    tot = torch.where(fin, torch.exp(neg - safe), 0.0).sum(-1)
    logz = (mx[..., 0] + torch.log(tot.clamp(min=1e-30))).reshape(rows, K)
    return torch.softmax(logz, -1) * 100.0


def decode(code: Code, batches, p_error: float, p_sampling: float,
           droplets: int, steps: int, capacity: int, dtype=torch.float32):
    """STDC of chosen syndromes: ``batches`` lists (start states (B, nq) of
    a batch, its rows to decode (n,), its decode seed); returns, a batch,
    (percentages (n, K), keys (n, K, droplets, steps, 2), counts (n, K,
    droplets, steps, 3)).  The chains of every batch run in one
    sampler call.  ``capacity`` bounds the distinct chains a class keeps
    (the streamed decode's buffer); None keeps them all."""
    K = code.n_classes
    chains, ids, seeds = [], [], []
    for states, pick, seed in batches:
        rain_seed, sd = decode_seeds(seed, steps)
        ch = rained(code, states, droplets, rain_seed, pick)
        dev = states.device
        i = ((pick.to(dev)[:, None, None] * K
              + torch.arange(K, device=dev)[None, :, None]) * droplets
             + torch.arange(droplets, device=dev)[None, None, :])
        chains.append(ch.reshape(-1, code.nq))
        ids.append(i.reshape(-1))
        seeds.append(sd[:, None].expand(steps, i.numel()))
    bs = betas_depolarizing(p_sampling)
    _, keys, counts = sample(code, torch.cat(chains), torch.cat(ids),
                             torch.cat(seeds, 1), float(bs[0]), dtype)
    out, at = [], 0
    be = betas_depolarizing(p_error)
    for states, pick, _ in batches:
        n = len(pick)
        sl = slice(at, at + n * K * droplets)
        at = sl.stop
        k = keys[sl].reshape(n, K, droplets, steps, 2)
        c = counts[sl].reshape(n, K, droplets, steps, 3)
        pct = percentages(
            k.reshape(n, K, droplets * steps, 2),
            c.reshape(n, K, droplets * steps, 3), be,
            droplets * steps if capacity is None
            else min(capacity, droplets * steps))
        out.append((pct, k, c))
    return out
