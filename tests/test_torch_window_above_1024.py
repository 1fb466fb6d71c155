"""The PT window kernel's large variant (csrc/ladder_window.cu::
ladder_window_kernel_wide, planes in shared memory) through what the CPU
can reach of it.

(a) The plain window equals ``make_pallas_ladder_window(...,
    interpret=True)`` in zeros mode, all nine outputs bit for bit, at
    toric d=21, toric d=23 and rotated d=33 (16, 17 and 18 words per
    plane).
(b) The large variant's qubit table names each stabilizer's qubits and
    ops as the dense masks do, and refuses codes past 2**14 qubits.  A
    numpy emulation of the large variant on its slots (2 bits a qubit,
    16 qubits a 32-bit word), read through the kernel's tables and its
    qubit table only, equals the plain window on the same Philox (or
    fixed) draws: the rung's lanes take whole Philox blocks of a color and
    run in step, each first loading its next block's states, then deciding
    its block's four stabilizers on packed 8-bit states, then XORing the
    accepted ops in; the exchange swaps slot indices and the state is
    written back through them; the class, hash and counts are read off the
    slots.  At toric d=21 and rotated d=29 (16 words), toric and planar
    d=23, xzzx d=31 and d=33, at 1 to 32 lanes a rung, in both betas
    forms, trace mode, even_odd and a fixed draw word.
(c) ``window_form`` at Nc = d and two sweeps a step: the large variant for
    every code the JAX package fuses on the TPU and the port ran unfused
    before (toric d=23/25, planar d=23-27, rotated and XZZX d=31-37) and
    for the 12- and 16-word codes, where it is the faster form (toric
    d=17-21, planar d=17-22, rotated and XZZX d=23-29), in both betas
    forms and at every batch; the register form at 1 word; where it names
    a form, that form's block shape fits 227 KB and its thread bound at
    every batch, and the large variant's keeps an SM's syndromes within
    its resident warps.
(d) The slice as a whole: PTEQ at toric d=23 runs the fused window on the
    CPU (the plain version, one call a window) and calls the true class on
    every row at p=0.02, as the JAX package's PTEQ does on the same
    syndromes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcmc_qec_tpu.decoders as jd
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops.pallas_ladder import make_pallas_ladder_window
import mcmc_qec_tpu_torch.decoders.pteq as pteq_mod
import mcmc_qec_tpu_torch.ops.kernel_tables as kt
import mcmc_qec_tpu_torch.ops.ladder_window as lw
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQConfig
from mcmc_qec_tpu_torch.mcmc.ladder import (
    beta_ladder_biased,
    beta_ladder_depolarizing,
)
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class
from mcmc_qec_tpu_torch.ops.philox import MASK32

from test_torch_codes_above_1024 import _pack, _unpack

OUT_NAMES = ("state", "flag", "tops0", "eq_count", "since_burn", "energies",
             "burn_any", "burn_first", "swap_acc", "eq_trace", "key_trace")
# the codes of the issue's table: the JAX package fuses them on the TPU,
# and before the large variant the port ran them unfused
TABLE = ([("toric", d) for d in (23, 25)] + [("planar", d) for d in (23, 25, 27)]
         + [(f, d) for f in ("rotated", "xzzx") for d in (31, 33, 35, 37)])
# the large variant's ladders at Nc = d: the table's codes and the 12- and
# 16-word codes, whose ladders the register form holds too
# (``window_form`` picks the faster form)
WIDE_FORM = TABLE + [("toric", 17), ("toric", 19), ("toric", 21),
                     ("planar", 17), ("planar", 20), ("planar", 22),
                     ("rotated", 23), ("rotated", 29), ("xzzx", 27),
                     ("xzzx", 29)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ladder_inputs(spec, B, Nc, seed):
    """Rung states with per-rung error rates in [0, 0.7), a few bottom
    rungs flagged, nonzero tops0 / eq_count / since_burn."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.0, 0.7, size=(B, Nc, 1))
    s = np.where(rng.uniform(size=(B, Nc, spec.nq)) < p,
                 rng.randint(1, 4, size=(B, Nc, spec.nq)), 0)
    flag = np.zeros((B, Nc), np.int32)
    flag[:, -1] = 1
    flag[::3, 0] = 1
    return ((s * spec.valid_mask).astype(np.uint8), flag,
            rng.randint(0, 4, size=B).astype(np.int32),
            rng.randint(0, 5, size=(B, spec.n_classes)).astype(np.int32),
            rng.randint(0, 7, size=B).astype(np.int32))


# ---------------------------------------------------------------------------
# (a) the plain window against the Pallas interpreter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,d", [("toric", 21), ("toric", 23),
                                      ("rotated", 33)])
def test_plain_window_equals_pallas_interpret_above_1024_qubits(family, d):
    jspec = jax_get_spec(family, d)
    spec = spec_from_jax(jspec)
    B, Nc, W, C, iters = 4, 3, 4, 2, 2
    inputs = _ladder_inputs(spec, B, Nc, seed=d)
    betas = beta_ladder_depolarizing(0.01, Nc).astype(np.float32)
    weights = np.ones(3, np.float32)
    jfn = make_pallas_ladder_window(jspec, Nc, W, iters, 0.5, 2, batch_tile=8,
                                    energy_chunk=C, interpret=True,
                                    top_exact=True, equal_betas=True)
    theirs = [np.asarray(a) for a in jfn(*map(jnp.asarray, inputs), 5,
                                         jnp.asarray(betas),
                                         jnp.asarray(weights))]
    fn = lw.make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, top_exact=True,
                               equal_betas=True, rng="zeros")
    ours = [a.numpy() for a in fn(*map(torch.as_tensor, inputs), 123, betas,
                                  weights)]
    assert len(ours) == len(theirs) == 9
    for name, a, b in zip(OUT_NAMES, theirs, ours):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert not np.array_equal(ours[0], inputs[0]), "the chains never moved"
    assert (ours[8] > 0).any() and (ours[8] < W).any()


# ---------------------------------------------------------------------------
# (b) a numpy emulation of the large variant against the plain window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,d", [("toric", 5), ("planar", 4), ("rotated", 7),
                                      ("xzzx", 9), ("toric", 23)])
def test_qubit_table_holds_each_stabilizers_qubits_and_ops(family, d):
    """Entry s of ``qubit_table`` names stabilizer s's qubits (in
    ``kernel_tables``' color order) with its op on each, as the dense
    support and op masks do, and op 0 (qubit 0) past them."""
    spec = get_spec(family, d)
    tab, _, offs = kt.kernel_tables(spec)
    dense = tab[: offs["off_draw"]].view(np.uint64).reshape(spec.n_stabs, 3, -1)
    qt = kt.qubit_table(spec).view(np.uint64)
    assert qt.shape == (spec.n_stabs,)
    for s in range(spec.n_stabs):
        e = int(qt[s])
        support, xs, zs = (
            set(np.flatnonzero(np.unpackbits(dense[s, k].view(np.uint8),
                                             bitorder="little")).tolist())
            for k in range(3))
        ops = {}
        for k in range(4):
            q, op = (e >> (14 * k)) & 0x3FFF, (e >> (56 + 2 * k)) & 3
            if op:
                ops[q] = op
            else:
                assert q == 0
        assert set(ops) == support
        assert {q for q, o in ops.items() if o & 1} == xs
        assert {q for q, o in ops.items() if o & 2} == zs


def test_qubit_table_refuses_what_an_entry_cannot_name():
    """Past 2**14 qubits (planar d=91) no entry names a qubit."""
    with pytest.raises(ValueError, match="below 16384"):
        kt.qubit_table(get_spec("planar", 91))


def _popc(a):
    return np.bitwise_count(a).astype(np.int64)


def _f32(x):
    return np.float32(x)


def _log_u(words):
    """log of the 24-bit uniforms of int64 draw words, as both versions
    form them."""
    u = (words >> 8).to(torch.float32) * torch.tensor(2.0 ** -24) + torch.tensor(1e-12)
    return torch.log(u).numpy()


def _uniform(words):
    return ((words >> 8).to(torch.float32) * torch.tensor(2.0 ** -24)
            + torch.tensor(1e-12)).numpy()


def _spread16(x):
    """Bit i of each 16-bit value to bit 2i (csrc/ladder_window.cu::spread16)."""
    x = x & np.uint64(0xFFFF)
    for sh, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                  (1, 0x55555555)):
        x = (x | (x << np.uint64(sh))) & np.uint64(m)
    return x


def _compact16(x):
    """Bit 2i to bit i (csrc/ladder_window.cu::compact16)."""
    x = x & np.uint64(0x55555555)
    for sh, m in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF),
                  (8, 0xFFFF)):
        x = (x | (x >> np.uint64(sh))) & np.uint64(m)
    return x


def _plane_words(W):
    """(..., 4 nw) slot words of 16 qubits, 2 bits each -> the (..., nw) X
    and Z plane words (plane_words)."""
    W = W.reshape(W.shape[:-1] + (-1, 4))
    x = np.zeros(W.shape[:-1], np.uint64)
    z = np.zeros_like(x)
    for h in range(4):
        x |= _compact16(W[..., h]) << np.uint64(16 * h)
        z |= _compact16(W[..., h] >> np.uint64(1)) << np.uint64(16 * h)
    return x, z


def _slot_words(x, z):
    """(..., nw) X and Z plane words -> (..., 4 nw) slot words
    (xor_plane_words on a zero slot)."""
    W = np.stack([_spread16(x >> np.uint64(16 * h))
                  | (_spread16(z >> np.uint64(16 * h)) << np.uint64(1))
                  for h in range(4)], -1)
    return W.reshape(x.shape[:-1] + (-1,))


def _emulate_large(spec, inputs, seed, betas, weights, *, W, iters, p_logical,
                   tops_burn, C, top_exact, equal_betas, exchange, traces,
                   rng, lanes):
    """One window of the large variant, read through ``kernel_tables``,
    ``qubit_table`` and the window's draws only, on its slots of 32-bit
    words, 2 bits a qubit.  A color's rung lanes run in step: lane l takes
    the blocks l, l + L, ...; in each round every lane first loads the
    states of its next block, then decides its current block's four
    stabilizers on the states it loaded (the packed 8-bit states, the
    entry's ops and a few popcounts), then XORs the accepted ops in."""
    state, flag, tops0, eq_count, since = (np.array(a) for a in inputs)
    B, Nc, nq = state.shape
    tab, meta, offs = kt.kernel_tables(spec)
    wt = tab[offs["off_draw"]:].view(np.uint64)  # the window kernel's table
    nw, n_colors = offs["nw"], offs["n_colors"]
    base = offs["off_draw"]
    qt = kt.qubit_table(spec).view(np.uint64)
    k4 = np.arange(4, dtype=np.uint64)
    Q = (qt[:, None] >> (np.uint64(14) * k4)) & np.uint64(0x3FFF)  # (n_s, 4)
    O = (qt[:, None] >> (np.uint64(56) + np.uint64(2) * k4)) & np.uint64(3)
    ops8 = qt >> np.uint64(56)
    starts = meta[: n_colors + 1]
    G, n_blk, n_xblk = lw._rng_layout(spec, Nc, iters)
    fixed = lw._fixed_word(rng)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    b3 = np.asarray(betas, np.float32).reshape(Nc, 3)
    w3 = np.asarray(weights, np.float32)
    K, n_draws = spec.n_classes, len(spec.logical_draws)
    u64 = np.uint64

    X, Z = _unpack(spec, state.reshape(B * Nc, nq))
    S = _slot_words(X, Z).reshape(B, Nc, 4 * nw)  # by slot
    slot = np.tile(np.arange(Nc), (B, 1))
    bi = np.arange(B)[:, None]
    fl, tops, eqc, sb = flag.copy(), tops0.astype(np.int64), eq_count.copy(), since.copy()
    bfirst = np.full(B, -1)
    swaps = np.zeros((B, Nc - 1), np.int32)
    esum = np.zeros((B, 1 if equal_betas else 3), np.int64)
    energies = np.zeros((W // C, B), np.float32)
    eq_tr = np.zeros((W, B), np.int32)
    key_tr = np.zeros((W, B, kt.N_KEY), np.int32)
    ev, od = u64(0x55), u64(0xAA)

    def gather(s):
        """(B, Nc, m) packed states of stabilizers ``s`` on every rung."""
        q = Q[s]  # (m, 4)
        v = S[bi[:, :, None, None], slot[:, :, None, None], q >> u64(4)]
        v = (v >> (u64(2) * (q & u64(15)))) & u64(3)
        return (v << (u64(2) * k4)).sum(-1, dtype=np.uint64)

    def mix_masks(d, it):
        """(B, nw) X and Z words of round ``it``'s gated logical masks."""
        mx = np.zeros((B, nw), np.uint64)
        mz = np.zeros((B, nw), np.uint64)
        for i in range(n_draws):
            e = (it * n_draws + i) * 3
            opb = (d[:, e] >> 8) % 4
            p0 = meta[offs["m_draw"] + i]
            npos = meta[offs["m_draw"] + i + 1] - p0
            for k, col in ((0, e + 1), (1, e + 2)):
                pos = (d[:, col] >> 8) % npos
                on = meta[offs["m_lut"] + (i * 4 + opb) * 2 + k] != 0
                at = ((p0 + pos) * 4 + 2 * k)[:, None] * nw + np.arange(nw)
                mx ^= np.where(on[:, None], wt[at], u64(0))
                mz ^= np.where(on[:, None], wt[at + nw], u64(0))
        return mx, mz

    for t in range(W):
        lu = _log_u(kt._draw_words(k0, k1, t, t + 1, B, 0, G, n_blk, fixed,
                                   "cpu"))[0]  # (B, G, 4 n_blk)
        extra = kt._draw_words(k0, k1, t, t + 1, B, G, 4, n_xblk, fixed,
                               "cpu")[0]  # (B, 4, 4 n_xblk)
        # 1) sweeps
        for it in range(iters):
            for c in range(n_colors):
                c0, n = int(starts[c]), int(starts[c + 1] - starts[c])
                nb = -(-n // 4)
                use = (it * n_colors + c) * Nc + np.arange(Nc)

                def block(rnd):
                    """The stabilizers (color-local) of round ``rnd``'s
                    blocks over the lanes, and their states now."""
                    g = np.arange(lanes) + lanes * rnd
                    j = (4 * g[:, None] + np.arange(4)).reshape(-1)
                    j = j[(np.repeat(g, 4) < nb) & (j < n)]
                    return j, gather(c0 + j)

                cur = block(0)
                for rnd in range(-(-nb // lanes)):
                    nxt = block(rnd + 1)  # the next loads before this apply
                    j, s = cur
                    if len(j):
                        o = ops8[c0 + j]
                        ns = s ^ o
                        if equal_betas:
                            d0 = (_popc((ns | (ns >> u64(1))) & ev)
                                  - _popc((s | (s >> u64(1))) & ev))
                            logr = -(b3[:, 0, None] * d0.astype(np.float32))
                        else:
                            tx, tz = _popc(s & o & ev), _popc(s & o & od)
                            d0 = (_popc(ns & (ns >> u64(1)) & ev)
                                  - _popc(s & (s >> u64(1)) & ev))
                            d1 = ((_popc(o & ev) - 2 * tx) - d0).astype(np.float32)
                            d3 = ((_popc(o & od) - 2 * tz) - d0).astype(np.float32)
                            logr = -((b3[:, 0, None] * d1 + b3[:, 1, None]
                                      * d0.astype(np.float32)) + b3[:, 2, None] * d3)
                        u = lu[:, use][:, :, j]  # (B, Nc, m)
                        acc = (logr >= 0) | (u < logr)
                        for k in range(4):
                            q, ok = Q[c0 + j, k], O[c0 + j, k]
                            val = np.where(acc, ok << (u64(2) * (q & u64(15))), u64(0))
                            idx = (bi[:, :, None], slot[:, :, None], (q >> u64(4))[None, None])
                            full = tuple(np.broadcast_to(a, val.shape) for a in idx)
                            np.bitwise_xor.at(S, full, val)
                    cur = nxt
        # 2) the top rung's logical mix, on its slot, word by word
        top = slot[:, -1]
        if p_logical > 0:
            gate = _uniform(extra[:, 0])
            mlogu = _log_u(extra[:, 3])
            d = extra[:, 1].numpy()
            for it in range(iters):
                mx, mz = mix_masks(d, it)
                gated = gate[:, it] < _f32(p_logical)
                if top_exact:
                    acc = gated
                else:
                    x, z = _plane_words(S[np.arange(B), top])
                    nx, nz = x ^ mx, z ^ mz
                    dn = [(_popc(a).sum(-1) - _popc(o).sum(-1)).astype(np.float32)
                          for a, o in ((nx & ~nz, x & ~z), (nx & nz, x & z),
                                       (~nx & nz, ~x & z))]
                    bt = b3[-1]
                    logr = -((bt[0] * dn[0] + bt[1] * dn[1]) + bt[2] * dn[2])
                    acc = gated & ((logr >= 0) | (mlogu[:, it] < logr))
                keep = np.where(acc[:, None], ~u64(0), u64(0))
                S[np.arange(B), top] ^= _slot_words(mx & keep, mz & keep)
        # 3) exchange on the slots; 4) flags; 5) the bottom rung's readout
        v = S[bi, slot]  # (B, Nc, 4 nw)
        xs, zs = v & u64(0x55555555), (v >> u64(1)) & u64(0x55555555)
        if equal_betas:
            cnt = _popc(xs | zs).sum(-1)[..., None]
        else:
            cnt = np.stack([_popc(xs & ~zs).sum(-1), _popc(xs & zs).sum(-1),
                            _popc(zs & ~xs).sum(-1)], -1)
        xlogu = _log_u(extra[:, 2])
        if exchange == "even_odd":
            order = list(range(0, Nc - 1, 2)) + list(range(1, Nc - 1, 2))
        else:
            order = list(reversed(range(Nc - 1)))
        for b in range(B):
            for i in order:
                dn = (cnt[b, i + 1] - cnt[b, i]).astype(np.float32)
                db = b3[i + 1] - b3[i]
                if equal_betas:
                    logr = db[0] * dn[0]
                else:
                    logr = (db[0] * dn[0] + db[1] * dn[1]) + db[2] * dn[2]
                if logr >= 0 or xlogu[b, i] < logr:
                    for a in (slot, fl, cnt):
                        a[b, [i, i + 1]] = a[b, [i + 1, i]]
                    swaps[b, i] += 1
        fl[:, -1] = 1
        arrived = fl[:, 0] == 1
        tops += arrived
        fl[arrived, 0] = 0
        burned = tops >= tops_burn
        sb += burned
        bfirst = np.where((bfirst < 0) & burned, t, bfirst)
        esum += cnt[:, 0]
        if (t + 1) % C == 0:
            if equal_betas:
                e = (w3[0] * esum[:, 0].astype(np.float32)) * _f32(1.0 / C)
            else:
                f = esum.astype(np.float32)
                e = ((w3[0] * f[:, 0] + w3[1] * f[:, 1]) + w3[2] * f[:, 2]) * _f32(1.0 / C)
            energies[t // C] = e
            esum[:] = 0
        x0, z0 = _plane_words(S[np.arange(B), slot[:, 0]])
        bits = np.zeros(B, np.int64)
        for f in range(spec.n_class_bits):
            a = wt[offs["off_class"] - base + f * 2 * nw + np.arange(2 * nw)]
            par = np.bitwise_xor.reduce(
                (_popc(a[:nw] & x0) + _popc(a[nw:] & z0)) & 1, axis=-1)
            bits |= par << f
        cls = meta[offs["m_b2e"] + bits]
        eqc[np.arange(B)[burned], cls[burned]] += 1
        eq_tr[t] = cls
        for c in range(kt.N_KEY):
            key = np.zeros(B, np.int64)
            for k in range(6):
                m = wt[offs["off_key"] - base + (c * 6 + k) * nw + np.arange(nw)]
                key += ((_popc(x0 & ~z0 & m) + 2 * _popc(x0 & z0 & m)
                         + 3 * _popc(~x0 & z0 & m)) << k).sum(-1)
            key_tr[t, :, c] = key
    # the state written back through the slots
    x, z = _plane_words(S[bi, slot].reshape(B * Nc, 4 * nw))
    out_state = _pack(spec, x, z).reshape(B, Nc, nq)
    out = [out_state, fl, tops.astype(np.int32), eqc, sb, energies, bfirst >= 0,
           np.maximum(bfirst, 0).astype(np.int32), swaps]
    return out + ([eq_tr, key_tr] if traces else [])


# (family, d, Nc, lanes, branch, exchange, traces, rng)
EMULATED = [
    ("toric", 23, 4, 8, "equal", "sequential", True, "philox"),
    ("toric", 23, 4, 2, "biased-mh", "even_odd", False, "philox"),
    ("planar", 23, 4, 8, "biased-mh", "sequential", True, 0x9E3779B9),
    ("planar", 23, 3, 1, "equal", "even_odd", False, "philox"),
    ("xzzx", 31, 4, 8, "biased-exact", "even_odd", True, "philox"),
    ("xzzx", 31, 3, 4, "biased-mh", "sequential", False, 0x9E3779B9),
    ("xzzx", 33, 4, 8, "biased-exact", "sequential", True, "philox"),
    ("xzzx", 33, 4, 32, "equal", "even_odd", False, "philox"),
    ("xzzx", 33, 3, 16, "biased-mh", "sequential", True, 0x9E3779B9),
    ("toric", 21, 4, 32, "equal", "sequential", True, "philox"),
    ("toric", 21, 3, 16, "biased-mh", "even_odd", False, "philox"),
    ("rotated", 29, 4, 16, "biased-exact", "sequential", True, "philox"),
    ("rotated", 29, 3, 32, "equal", "even_odd", False, 0x9E3779B9),
]


@pytest.mark.parametrize("family,d,Nc,lanes,branch,exchange,traces,rng", EMULATED,
                         ids=[f"{f}-{d}-{b}-{e}-L{L}" for f, d, _, L, b, e, _, _
                              in EMULATED])
def test_emulated_large_variant_equals_the_plain_window(family, d, Nc, lanes,
                                                        branch, exchange,
                                                        traces, rng):
    spec = get_spec(family, d)
    B, W, C, iters, seed = 3, 4, 2, 2, (3 << 32) | 0xBEEF
    inputs = _ladder_inputs(spec, B, Nc, seed=d + Nc)
    equal_betas = branch == "equal"
    top_exact = branch != "biased-mh"
    if equal_betas:
        betas = beta_ladder_depolarizing(0.05, Nc)
    else:
        betas = beta_ladder_biased(0.05, 4.0, Nc)
        if top_exact:
            betas[-1] = 0.0
    betas = np.asarray(betas, np.float32)
    weights = np.ones(3, np.float32) if equal_betas else np.asarray(
        [2.0, 2.0, 1.0], np.float32)
    kw = dict(iters=iters, p_logical=0.5, tops_burn=2, top_exact=top_exact,
              equal_betas=equal_betas, exchange=exchange)
    ours = _emulate_large(spec, inputs, seed, betas, weights, W=W, C=C,
                          traces=traces, rng=rng, lanes=lanes, **kw)
    plain = lw.ladder_window_reference(
        spec, *map(torch.as_tensor, inputs), seed, betas, weights, window=W,
        energy_chunk=C, track_traces=traces, rng=rng, **kw)
    assert len(ours) == len(plain) == (11 if traces else 9)
    for name, a, b in zip(OUT_NAMES, ours, plain):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert not np.array_equal(ours[0], inputs[0]), "the chains never moved"


# ---------------------------------------------------------------------------
# (c) which form runs where
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,d", WIDE_FORM,
                         ids=[f"{f}-{d}" for f, d in WIDE_FORM])
def test_the_large_variant_holds_every_code_the_jax_package_fuses(family, d):
    spec = get_spec(family, d)
    offs = kt.kernel_tables(spec)[2]
    K, nd = spec.n_classes, len(spec.logical_draws)
    for eq in (True, False):
        assert lw.window_kernel_fits(spec, d, eq, 2)
        for B in (1, 16, 64, 263, 4096):
            assert lw.window_form(spec, d, eq, 2, B, 132) == "large", (eq, B)
            shape = lw.wide_block_shape(offs, d, K, B, 132, eq, 2, nd)
            L, wpg, gpb = (shape.lanes, shape.warps_per_group,
                           shape.groups_per_block)
            assert 1 <= L <= 32 and L & (L - 1) == 0
            assert wpg == -(-d * L // 32)
            assert shape.threads == 32 * wpg * gpb <= kt.WIDE_MAX_THREADS
            if wpg > 1:
                assert gpb <= lw.MAX_NAMED_BARRIERS
            # an SM's syndromes within its resident warps (or one lane a
            # rung), and one syndrome an SM at the most lanes that fit
            assert L == 1 or gpb * wpg <= kt.WIDE_WARPS_PER_SM
            if B <= 132:
                assert L == (32 if 32 * d <= kt.WIDE_MAX_THREADS else 16)
            assert shape.smem == lw.wide_smem_bytes(offs, d, K, gpb, eq, 2,
                                                    nd, shape.tab_in_smem)
            assert shape.smem <= kt.SMEM_LIMIT
    # below 12 words the batch and the word count decide (``window_form``):
    # the register form at 1 word, the large variant from 8 words on
    assert lw.window_form(get_spec("toric", 5), 5, True, 2, 2603, 132) == "registers"
    assert lw.window_form(get_spec("toric", 15), 15, True, 2, 512, 132) == "large"
    assert lw.window_form(get_spec("xzzx", 21), 21, False, 2, 512, 132) == "large"


@pytest.mark.parametrize("family,d,Nc,want", [
    ("toric", 5, 5, "registers"),
    ("toric", 15, 15, "large"),     # 8 words: the faster form at B=512
    ("toric", 19, 19, "large"),     # 12 words: the faster form
    ("xzzx", 31, 31, "large"),      # 16 words, a group too large for registers
    ("xzzx", 31, 5, "large"),       # 16 words: the faster form
    ("toric", 5, 128, "registers"),  # 128 rungs x 4 lanes: 512 threads
    ("toric", 5, 129, "large"),     # past them: fewer lanes a rung
    ("toric", 5, 1024, "large"),    # one lane a rung
    ("toric", 5, 1025, None),       # more rungs than a block has threads
    ("toric", 45, 45, "large"),     # 64 words
    ("toric", 45, 217, "large"),    # 217 slots of 257 32-bit words in 227 KB
    ("toric", 45, 220, None),       # 220 do not fit
    ("planar", 91, 3, None),        # 259 words: no entry names a word
])
def test_window_form_at_the_limits(family, d, Nc, want):
    spec = get_spec(family, d)
    for eq in (True, False):
        assert lw.window_form(spec, Nc, eq, 2, 512, 132) == want
        assert lw.window_kernel_fits(spec, Nc, eq, 2) == (want is not None)
    if want == "large":
        offs = kt.kernel_tables(spec)[2]
        shape = lw.wide_block_shape(offs, Nc, spec.n_classes, 512, 132, True,
                                    2, len(spec.logical_draws))
        assert Nc * shape.lanes <= shape.threads <= kt.WIDE_MAX_THREADS
        assert shape.smem <= kt.SMEM_LIMIT


# ---------------------------------------------------------------------------
# (d) the slice as a whole
# ---------------------------------------------------------------------------


def test_pteq_at_toric_d23_runs_the_fused_window():
    spec = get_spec("toric", 23)
    Nc, W, B, p = 3, 8, 2, 0.02
    rng = np.random.RandomState(25)
    s = rng.randint(1, 4, (B, spec.nq)) * (rng.rand(B, spec.nq) < p)
    s = (s * spec.valid_mask).astype(np.uint8)
    truth = np_eq_class(spec, s)
    kw = dict(Nc=Nc, max_steps=2 * W, window=W, iters=1, energy_chunk=4,
              tops_burn=0)
    assert lw.window_form(spec, Nc, True, 1, B, 132) == "large"
    pteq_mod._WINDOW_CACHE.clear()
    lw.ladder_window_counts.reset()
    ours = PTEQ(spec, s, p, PTEQConfig(**kw), device="cpu")
    assert ours.window == "fused"
    windows = -(-int(ours.steps.max()) // W)
    assert lw.ladder_window_counts.plain_calls == windows
    theirs = jd.PTEQ(jax_get_spec("toric", 23), s, p, jd.PTEQConfig(**kw))
    for res in (ours, theirs):
        dist = np.asarray(res.distribution)
        assert dist.shape == (B, spec.n_classes) and dist.dtype == np.uint8
        assert bool(((dist.sum(1) > 0) & (dist.sum(1) <= 100)).all())
        np.testing.assert_array_equal(dist.argmax(1), truth)
    pteq_mod._WINDOW_CACHE.clear()
