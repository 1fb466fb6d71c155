"""One parallel-tempering window of PTEQ, in plain torch, row by row.

Each row is one syndrome's ladder of ``Nc`` chains at the start of a window,
with the window's seed and the row's position in its batch, which together
name its random draws.  Rows from different windows and batches go through
one call.  Per ladder step (decoders.py:25-89 of the upstream project, as
the decoders batch it):

1. ``iters`` coloured sweeps of every rung: each check of a colour proposes
   its flip, accepted when ``log u < -beta * dN`` (equal betas, dN the change
   of the error count on its support) or ``< -((bx dNx + by dNy) + bz dNz)``;
2. the top rung mixes in random logicals: each of ``iters`` rounds is gated
   by ``u < p_logical`` and draws an op and two positions per logical draw;
   with zero top betas every gated proposal is taken, else each round is a
   Metropolis step on the top rung's weighted length;
3. the replica exchange, top pair first (or even then odd pairs), on the
   counts after the mix, each pair swapped when ``log u < dbeta * dN``;
4. the flags: the top chain is flagged, a flag reaching the bottom counts
   one ``tops0`` and clears;
5. once ``tops0 >= tops_burn`` each step's bottom chain is counted in its
   class, and every ``energy_chunk`` steps the mean bottom energy is kept.

Randomness: Philox4x32-10 word ``e % 4`` at counter ``(e // 4, use, step,
row)`` under the window seed; uses ``(it * n_colors + c) * Nc + r`` for the
sweeps, then gates, logical draws, exchange and the Metropolis mix.  A
uniform is ``(word >> 8) * 2**-24 + 1e-12``.

``dtype`` is the precision of the acceptance tests and energies: float32 is
the decoder's; bfloat16 is the control that must fail the comparison.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import philox
from .codes import Code

# int64 Philox words one call may hold (bounds the steps drawn at once)
DRAW_BUDGET = 1 << 24


def _tables(code: Code, device):
    cols = []
    for checks in code.colors:
        supp = torch.as_tensor(code.stab_qubits[checks], device=device)
        op = torch.as_tensor(code.stab_ops[checks, :1].astype("int64"),
                             device=device)  # (n, 1)
        cols.append((supp, op))
    draws = []
    for d in code.draws:
        draws.append(tuple(torch.as_tensor(a.astype("int64"), device=device)
                           for a in (d.x_masks, d.z_masks, d.op_lut)))
    return cols, draws


def counts_xyz(s: torch.Tensor) -> torch.Tensor:
    """(..., 3) X, Y, Z counts of Pauli states (..., nq)."""
    return torch.stack([(s == v).sum(-1) for v in (1, 2, 3)], -1)


def class_of(code: Code, s: torch.Tensor) -> torch.Tensor:
    """Class index of Pauli states (..., nq) (toric: the class bits)."""
    a = torch.as_tensor(code.class_a.astype("int64"), device=s.device)
    b = torch.as_tensor(code.class_b.astype("int64"), device=s.device)
    x = ((s & 1) ^ ((s >> 1) & 1)).unsqueeze(-2)
    z = ((s >> 1) & 1).unsqueeze(-2)
    feats = ((x & a).sum(-1) + (z & b).sum(-1)) & 1
    return (feats << torch.arange(a.shape[0], device=s.device)).sum(-1)


def _weighted(w, n):
    return (w[0] * n[..., 0] + w[1] * n[..., 1]) + w[2] * n[..., 2]


def window(code: Code, state, flag, tops0, eq_count, since_burn, keys, rows,
           betas, weights, *, W: int, iters: int, p_logical: float,
           tops_burn: int, energy_chunk: int, equal_betas: bool,
           top_exact: bool, exchange: str = "sequential",
           dtype=torch.float32):
    """Run one window of ``W`` steps for every row.

    ``state`` (R, Nc, nq) uint8, ``flag`` (R, Nc), ``tops0`` (R,),
    ``eq_count`` (R, K), ``since_burn`` (R,), ``keys`` (R,) int64 window
    seeds, ``rows`` (R,) int64 batch positions, ``betas`` (Nc, 3),
    ``weights`` (3,).  Returns the window's outputs in the decoder's order:
    (state, flag, tops0, eq_count, since_burn, energies (W // C, R),
    burn_any, burn_first, swaps (R, Nc - 1))."""
    dev = state.device
    R, Nc, nq = state.shape
    C = energy_chunk
    cols, draws = _tables(code, dev)
    n_colors, n_draws = len(cols), len(draws)
    n_blocks = -(-max(len(c) for c in code.colors) // 4)
    n_extra = max(iters, 3 * iters * n_draws, Nc - 1, 1)
    n_xblocks = -(-n_extra // 4)
    G = iters * n_colors * Nc
    keys = keys.to(dev, torch.int64)
    rows = rows.to(dev, torch.int64)

    S = state.to(torch.int64)
    fl = flag.to(torch.int64)
    tops = tops0.to(torch.int64)
    eq = eq_count.to(torch.int64)
    since = since_burn.to(torch.int64)
    bfirst = torch.full((R,), -1, dtype=torch.int64, device=dev)
    swaps = torch.zeros((R, Nc - 1), dtype=torch.int64, device=dev)
    b32 = torch.as_tensor(betas, dtype=torch.float32, device=dev).reshape(Nc, 3)
    beta = b32.to(dtype)
    dbeta = (b32[1:] - b32[:-1]).to(dtype)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev).to(dtype)
    two_m24 = torch.tensor(2.0 ** -24, dtype=dtype, device=dev)
    eps = torch.tensor(1e-12, dtype=dtype, device=dev)
    inv_c = torch.tensor(1.0 / C, dtype=torch.float32, device=dev).to(dtype)
    rung = torch.arange(Nc, device=dev).expand(R, Nc)
    if exchange == "even_odd":
        order = list(range(0, Nc - 1, 2)) + list(range(1, Nc - 1, 2))
    else:
        order = list(reversed(range(Nc - 1)))
    energies = torch.empty((W // C, R), dtype=torch.float32, device=dev)
    acc_s, acc_g, acc_n = [], [], []

    def unif(words):
        return (words >> 8).to(dtype) * two_m24 + eps

    per_step = R * (G * n_blocks + 4 * n_xblocks) * 4
    span = max(1, DRAW_BUDGET // max(per_step, 1))
    for t0 in range(0, W, span):
        t1 = min(W, t0 + span)
        steps = torch.arange(t0, t1, device=dev)
        logu = torch.log(unif(philox.words(keys, rows, steps, 0, G, n_blocks)))
        x24 = philox.words(keys, rows, steps, G, 4, n_xblocks) >> 8
        lsw = torch.log(x24[:, :, 2].to(dtype) * two_m24 + eps)
        for t in range(t0, t1):
            lt = t - t0
            for it in range(iters):
                for c, (supp, op) in enumerate(cols):
                    n = supp.shape[0]
                    base = (it * n_colors + c) * Nc
                    lu = logu[lt, :, base:base + Nc, :n]  # (R, Nc, n)
                    v = S[:, :, supp]  # (R, Nc, n, 4)
                    nv = v ^ op
                    if equal_betas:
                        dn = ((nv != 0).sum(-1) - (v != 0).sum(-1)).to(dtype)
                        logr = -(beta[:, 0].view(1, Nc, 1) * dn)
                    else:
                        d = (counts_xyz(nv) - counts_xyz(v)).to(dtype)
                        bb = beta.view(1, Nc, 1, 3)
                        logr = -((bb[..., 0] * d[..., 0] + bb[..., 1] * d[..., 1])
                                 + bb[..., 2] * d[..., 2])
                    acc = (lu < logr).unsqueeze(-1)
                    S[:, :, supp.reshape(-1)] = torch.where(acc, nv, v).reshape(
                        R, Nc, -1)
            if p_logical > 0.0:
                gate = (x24[lt, :, 0, :iters].to(dtype) * two_m24 + eps) < p_logical
                dw = x24[lt, :, 1]  # (R, 4 * n_xblocks) draw words
                mks = []
                for it in range(iters):
                    mk = torch.zeros((R, nq), dtype=torch.int64, device=dev)
                    for i, (xm, zm, lut) in enumerate(draws):
                        e = (it * n_draws + i) * 3
                        opb = dw[:, e] % 4
                        px = dw[:, e + 1] % xm.shape[0]
                        pz = dw[:, e + 2] % zm.shape[0]
                        g = gate[:, it].to(torch.int64)
                        mk = mk ^ (xm[px] * (lut[opb, 0] * g)[:, None])
                        mk = mk ^ (zm[pz] * (lut[opb, 1] * g)[:, None])
                    mks.append(mk)
                if top_exact:
                    for mk in mks:
                        S[:, -1] = S[:, -1] ^ mk
                else:
                    lmix = torch.log(x24[lt, :, 3, :iters].to(dtype) * two_m24
                                     + eps)
                    for it, mk in enumerate(mks):
                        top = S[:, -1]
                        dn = (counts_xyz(top ^ mk) - counts_xyz(top)).to(dtype)
                        ok = lmix[:, it] < -_weighted(beta[-1], dn)
                        S[:, -1] = top ^ (mk * ok[:, None])
            if equal_betas:
                N = (S != 0).sum(-1, keepdim=True)
            else:
                N = counts_xyz(S)
            tab = torch.cat([rung.unsqueeze(-1), N, fl.unsqueeze(-1)], -1)
            for i in order:
                dn = (tab[:, i + 1, 1:-1] - tab[:, i, 1:-1]).to(dtype)
                if equal_betas:
                    logr = dbeta[i, 0] * dn[:, 0]
                else:
                    logr = _weighted(dbeta[i], dn)
                ok = lsw[lt][:, i] < logr
                pair = tab[:, i:i + 2]
                tab = tab.clone()
                tab[:, i:i + 2] = torch.where(ok[:, None, None], pair.flip(1),
                                              pair)
                swaps[:, i] += ok
            S = S.gather(1, tab[..., 0:1].expand_as(S))
            N, fl = tab[..., 1:-1], tab[..., -1].clone()
            fl[:, -1] = 1
            arrived = fl[:, 0] == 1
            tops = tops + arrived
            fl[:, 0] = torch.where(arrived, 0, fl[:, 0])
            burned = tops >= tops_burn
            since = since + burned
            bfirst = torch.where((bfirst < 0) & burned, t, bfirst)
            acc_s.append(S[:, 0])
            acc_g.append(burned)
            acc_n.append(N[:, 0])
            if (t + 1) % C == 0:
                cls = class_of(code, torch.stack(acc_s))
                eq = eq + (F.one_hot(cls, code.n_classes)
                           * torch.stack(acc_g)[..., None]).sum(0)
                es = torch.stack(acc_n).sum(0).to(dtype)
                if equal_betas:
                    e = (w[0] * es[:, 0]) * inv_c
                else:
                    e = _weighted(w, es) * inv_c
                energies[t // C] = e.to(torch.float32)
                acc_s, acc_g, acc_n = [], [], []
    i32 = torch.int32
    return (S.to(torch.uint8), fl.to(i32), tops.to(i32), eq.to(i32),
            since.to(i32), energies, bfirst >= 0, bfirst.clamp(min=0).to(i32),
            swaps.to(i32))
