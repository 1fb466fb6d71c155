"""Codes above 1024 qubits in the port, on the CPU: the sweep kernel's
large variant (csrc/sweep.cu::sweep_kernel_wide, above 16 words per plane)
through what the CPU can reach of it.

(a) A numpy emulation of the large variant, lane by lane, through the
    qubit table only (unpack by 32-qubit ballots into slots of 2 bits a
    qubit; per color each lane's Philox blocks, the next block's states
    loaded before the current block is decided, then its accepted flips
    applied; the recording kept up to date flip by flip in the lanes'
    shares; pack), equals ``sweep_reference`` and ``sample_reference`` bit
    for bit on the same Philox draws (``_draw_words``) at 1, 2, 8 and 32
    lanes: toric d=23 and rotated d=33, equal and general betas, a shared
    row and a row per chain; toric d=45 with counts past 1023; a step that
    accepts no flip; and zero betas, where every proposal accepts.
(b) ``sweep_reference`` with injected uniforms equals
    ``make_pallas_sweep(..., interpret=True)`` bit for bit at toric d=23
    and rotated d=33 in both branches, and the port's ``make_dense_sweep``
    equals the JAX one on the same injected uniforms.
(c) The slice as a whole: STDC at toric d=23, p=0.02, on the same 8
    syndromes through both packages (each recovers at least 7 and they
    agree on at least 7 argmaxes); PTEQ at toric d=23 with
    ``engine="sweep"`` runs the unfused window (one sweep call a ladder
    step, no window-kernel call) and its window keeps every rung's
    syndrome.
(d) ``sweep_kernel_fits`` is exactly where ``sweep_plan`` finds a launch,
    for every family up to the limit (256 words per plane) and past it;
    the large variant's launch (``wide_block``) stays within 1024 threads
    and 227 KB a block and spreads the batch over the SMs in whole waves;
    above the limit ``_launch`` raises before any work, and a failing build
    or launch raises without running the plain version.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcmc_qec_tpu.decoders as jd
from mcmc_qec_tpu.mcmc.ladder import betas_xyz
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops.dense_sweep import make_dense_sweep as jax_dense_sweep
from mcmc_qec_tpu.ops.pallas_sweep import make_pallas_sweep
import mcmc_qec_tpu_torch.decoders.pteq as pteq_mod
import mcmc_qec_tpu_torch.ops.kernel_tables as kt
import mcmc_qec_tpu_torch.ops.ladder_window as lw
import mcmc_qec_tpu_torch.ops.sweep as sw
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTEQ, STDC, PTEQConfig
from mcmc_qec_tpu_torch.mcmc.ladder import beta_ladder_depolarizing, init_ladder
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class, np_syndrome
from mcmc_qec_tpu_torch.ops.dense_sweep import make_dense_sweep
from mcmc_qec_tpu_torch.ops.pauli import count_errors_xyz, make_hash_mults, pack_key
from mcmc_qec_tpu_torch.ops.philox import MASK32

from test_torch_sweep import _pallas_logu

EMULATED = [("toric", 23), ("rotated", 33)]
# the largest distance of each family the card takes (nq <= 16384)
LARGEST = {"toric": 89, "planar": 89, "rotated": 127, "xzzx": 127}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(spec, B, seed, p=0.3):
    rng = np.random.RandomState(seed)
    s = rng.randint(1, 4, (B, spec.nq)) * (rng.rand(B, spec.nq) < p)
    return (s * spec.valid_mask).astype(np.uint8)


# ---------------------------------------------------------------------------
# (a) a numpy emulation of the large variant against sweep_reference
# ---------------------------------------------------------------------------


def _popc(a):
    return np.bitwise_count(a).astype(np.int64)


def _spread16(x):
    """csrc/sweep.cuh::spread16: bit i of the low 16 bits to bit 2i."""
    x = x.astype(np.uint32) & np.uint32(0xFFFF)
    for sh, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        x = (x | (x << np.uint32(sh))) & np.uint32(m)
    return x


def _unpack_slots(spec, states):
    """The kernel's unpack into slots of 2 bits a qubit: per 32-qubit chunk
    k, the ballots of the X and Z bits spread into slot words 2k and 2k +
    1 (16 qubits each; 4 nw words a chain)."""
    nw = kt.kernel_words(spec.nq)
    v = np.zeros((states.shape[0], 64 * nw), np.uint32)
    v[:, : spec.nq] = states & 3
    shifts = np.arange(32, dtype=np.uint32)
    xb, zb = ((bit.reshape(len(v), 2 * nw, 32) << shifts).sum(-1, dtype=np.uint32)
              for bit in ((v ^ (v >> 1)) & 1, (v >> 1) & 1))
    W = np.zeros((len(v), 4 * nw), np.uint32)
    for h in range(2):
        W[:, h::2] = _spread16(xb >> np.uint32(16 * h)) | (
            _spread16(zb >> np.uint32(16 * h)) << np.uint32(1))
    return W


def _pack_slots(spec, W):
    """The kernel's pack: qubit q's 2 bits s = x | z << 1 give x ^ 3z."""
    q = np.arange(spec.nq)
    s = (W[:, q >> 4] >> (2 * (q & 15)).astype(np.uint32)) & np.uint32(3)
    return ((s & 1) ^ ((s >> 1) * 3)).astype(np.uint8)


def _unpack(spec, states):
    """Bit planes of u64 words: per 32-qubit chunk k, the ballots of the X
    and Z bits are the 32-bit halves 2w, 2w + 1 of plane word w (the
    window kernel's model, tests/test_torch_window_above_1024.py, reads its
    slots from them)."""
    nw = kt.kernel_words(spec.nq)
    v = np.zeros((states.shape[0], 64 * nw), np.uint32)
    v[:, : spec.nq] = states
    shifts = np.arange(32, dtype=np.uint32)
    planes = []
    for bit in ((v ^ (v >> 1)) & 1, (v >> 1) & 1):
        halves = (bit.reshape(len(v), 2 * nw, 32) << shifts).sum(-1, dtype=np.uint32)
        planes.append(np.ascontiguousarray(halves).view(np.uint64))
    return planes


def _pack(spec, X, Z):
    q = np.arange(spec.nq)
    w, k = q // 64, (q % 64).astype(np.uint64)
    x = (X[:, w] >> k) & np.uint64(1)
    z = (Z[:, w] >> k) & np.uint64(1)
    return (x ^ (np.uint64(3) * z)).astype(np.uint8)


def _pauli(s):
    """csrc/sweep.cu::pauli_of: the Pauli values of packed 2-bit states."""
    return s ^ ((s >> np.uint32(1)) & np.uint32(0x55555555))


def _xyz_packed(s):
    """csrc/sweep.cu::xyz_packed: X-only, Y and Z-only 2-bit fields of s,
    21 bits apart in a u64."""
    x, z = s & 0x55555555, (s >> 1) & 0x55555555
    return (_popc(x & ~z) | (_popc(x & z) << 21) | (_popc(z & ~x) << 42)).astype(np.uint64)


def _entry_logr(s, o, bx, by, bz, equal_betas):
    """csrc/sweep.cuh::entry_logr on (B,) states of one entry's qubits
    (packed 2 bits a qubit) under its ops, in f32 as the kernel rounds."""
    ns = s ^ o
    if equal_betas:
        d0 = _popc((ns | (ns >> 1)) & 0x55) - _popc((s | (s >> 1)) & 0x55)
        return -(bx * d0.astype(np.float32))
    tx, tz = _popc(s & o & 0x55), _popc(s & o & 0xAA)
    d0 = _popc(ns & (ns >> 1) & 0x55) - _popc(s & (s >> 1) & 0x55)
    d1 = ((_popc(np.uint32(o) & 0x55) - 2 * tx) - d0).astype(np.float32)
    d3 = ((_popc(np.uint32(o) & 0xAA) - 2 * tz) - d0).astype(np.float32)
    return -((bx * d1 + by * d0.astype(np.float32)) + bz * d3)


class _Emulated:
    """csrc/sweep.cu::sweep_kernel_wide in numpy, lane by lane, through the
    qubit table and the color starts only: chains in 2-bit slots; per
    color, lane l takes Philox blocks g = l, l + L, ...; per block it loads
    the next block's states (load_block) before it decides the current
    one's four stabilizers on the states it loaded (entry_logr against the
    draws' log-uniforms), then flips the accepted ones and, recording,
    adds m_q * (v_new - v_old) and the count changes to its share.  A
    step's record is the wraparound sum of the chain's L shares."""

    def __init__(self, spec, states, betas, equal_betas, lanes):
        self.spec, self.eq, self.L = spec, equal_betas, lanes
        self.qt = kt.qubit_table(spec).view(np.uint64)
        tab, meta, offs = kt.kernel_tables(spec)
        self.starts = [int(v) for v in meta[: offs["n_colors"] + 1]]
        self.W = _unpack_slots(spec, states)
        B = len(states)
        b = np.asarray(betas, np.float32).reshape(-1, 3)
        self.bx, self.by, self.bz = (b[:, i] for i in range(3))  # (1 or B,)
        self.m = make_hash_mults(spec)
        # the unpack's sums are the share of each chain's lane 0
        v = states.astype(np.uint32) & 3
        self.h = np.zeros((lanes, 2, B), np.uint32)
        self.h[0] = (v[None] * self.m[:, None, :]).sum(-1, dtype=np.uint32)
        self.cnt = np.zeros((lanes, B), np.uint64)
        self.cnt[0] = (((v == 1).sum(1) | ((v == 2).sum(1) << 21)
                        | ((v == 3).sum(1) << 42))).astype(np.uint64)
        self.flips = 0  # accepted proposals that flip qubits, in all chains

    def _load_block(self, c0, n, g):
        st = np.zeros(len(self.W), np.uint32)
        ops = 0
        for e in range(4):
            if 4 * g + e >= n:
                continue  # an empty entry: no ops
            ent = int(self.qt[c0 + 4 * g + e])
            for k in range(4):
                q = (ent >> (14 * k)) & 0x3FFF
                s = (self.W[:, q >> 4] >> np.uint32(2 * (q & 15))) & np.uint32(3)
                st |= s << np.uint32(2 * k + 8 * e)
            ops |= (ent >> 56) << (8 * e)
        return st, ops

    def sweep(self, lu, t):
        """Sweep ``t`` on the log-uniforms ``lu`` (B, n_colors, 4 * blocks)."""
        rows = np.arange(len(self.W))
        for c in range(len(self.starts) - 1):
            c0, n = self.starts[c], self.starts[c + 1] - self.starts[c]
            nb = -(-n // 4)
            for l in range(self.L):
                if l >= nb:
                    continue
                st, ops = self._load_block(c0, n, l)
                for g in range(l, nb, self.L):
                    st_n, ops_n = self._load_block(c0, n if g + self.L < nb else 0, g + self.L)
                    flipped = np.zeros(len(rows), np.uint32)
                    for e in range(4):
                        o = (ops >> (8 * e)) & 255
                        s = (st >> np.uint32(8 * e)) & np.uint32(255)
                        with np.errstate(invalid="ignore"):  # inf * 0: NaN rejects
                            logr = _entry_logr(s, np.uint32(o), self.bx, self.by,
                                               self.bz, self.eq)
                        assert logr.dtype == np.float32
                        acc = (logr >= 0) | (lu[:, c, 4 * g + e] < logr)
                        if not o or not acc.any():
                            continue
                        self.flips += int(acc.sum())
                        ent = int(self.qt[c0 + 4 * g + e])
                        v0, v1 = _pauli(s), _pauli(s ^ np.uint32(o))
                        for k in range(4):  # a missing qubit: op 0 on qubit 0
                            ok = (o >> (2 * k)) & 3
                            q = (ent >> (14 * k)) & 0x3FFF
                            bit = np.where(acc, np.uint32(ok << (2 * (q & 15))), np.uint32(0))
                            self.W[:, q >> 4] ^= bit
                            dv = ((v1 >> np.uint32(2 * k)) & np.uint32(3)) - (
                                (v0 >> np.uint32(2 * k)) & np.uint32(3))
                            self.h[l] += self.m[:, q, None] * np.where(acc, dv, np.uint32(0))
                        flipped |= np.where(acc, np.uint32(o << (8 * e)), np.uint32(0))
                    self.cnt[l] += _xyz_packed(st ^ flipped) - _xyz_packed(st)
                    st, ops = st_n, ops_n

    def record(self):
        """(keys (B, 2), counts (B, 3)): the sums of the lanes' shares."""
        h = self.h.sum(0, dtype=np.uint32)
        cnt = self.cnt.sum(0, dtype=np.uint64)
        counts = np.stack([(cnt >> np.uint64(21 * i)) & np.uint64((1 << 21) - 1)
                           for i in range(3)], 1)
        return h.T.astype(np.int64), counts.astype(np.int64)


def _log_uniforms(spec, seed, n_sweeps, B):
    """The draws' logarithms as the plain version forms them (torch.log):
    (n_sweeps, B, n_colors, 4 * blocks)."""
    n_colors = len(spec.color_stabs)
    n_blocks = -(-sw.stab_width(spec) // 4)
    bits = kt._draw_words(seed & MASK32, (seed >> 32) & MASK32, 0, n_sweeps, B,
                          0, n_colors, n_blocks, None, "cpu") >> 8
    return torch.log(bits.to(torch.float32) * torch.tensor(2.0 ** -24)
                     + torch.tensor(1e-12)).numpy()


def _emulate_wide(spec, states, seed, betas, n_sweeps, equal_betas, lanes=1):
    """``n_sweeps`` sweeps of the large variant (``_Emulated``) under one
    seed; returns the emulation after them."""
    em = _Emulated(spec, states, betas, equal_betas, lanes)
    lu = _log_uniforms(spec, seed, n_sweeps, len(states))
    for t in range(n_sweeps):
        em.sweep(lu[t], t)
    return em


def _emulate_sampler(spec, states, seeds, betas, iters, equal_betas, lanes):
    """The large variant's recording launch: per seed ``iters`` sweeps, then
    the record.  Returns (emulation, keys (B, steps, 2), counts (B, steps,
    3), accepted flips per step)."""
    em = _Emulated(spec, states, betas, equal_betas, lanes)
    keys, counts, flips = [], [], []
    for seed in seeds:
        before = em.flips
        lu = _log_uniforms(spec, int(seed), iters, len(states))
        for t in range(iters):
            em.sweep(lu[t], t)
        k, c = em.record()
        keys.append(k)
        counts.append(c)
        flips.append(em.flips - before)
    return em, np.stack(keys, 1), np.stack(counts, 1), flips


def test_unpack_pack_round_trip_through_the_slots():
    spec = get_spec("toric", 23)
    states = _states(spec, 5, seed=2, p=0.7)
    W = _unpack_slots(spec, states)
    assert W.shape == (5, 4 * 17)
    q = np.arange(spec.nq)
    direct = (((states ^ (states >> 1)) & 1) | (states & 2)).astype(np.uint32)
    np.testing.assert_array_equal((W[:, q >> 4] >> (2 * (q & 15)).astype(np.uint32)) & 3,
                                  direct)
    assert not W[:, -(-spec.nq // 16):].any()  # nothing past nq
    np.testing.assert_array_equal(_pack_slots(spec, W), states)
    # slot word j spreads the 16 X and Z bits of bit-plane chunk j
    X, Z = _unpack(spec, states)
    np.testing.assert_array_equal(_pack(spec, X, Z), states)
    x16, z16 = (np.ascontiguousarray(P).view(np.uint16).astype(np.uint32) for P in (X, Z))
    np.testing.assert_array_equal(W, _spread16(x16) | (_spread16(z16) << np.uint32(1)))


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
@pytest.mark.parametrize("betas", ["equal", "general", "per-chain"])
@pytest.mark.parametrize("family,d", EMULATED, ids=[f"{f}-{d}" for f, d in EMULATED])
def test_emulated_large_variant_equals_the_plain_sweep(family, d, betas, lanes):
    spec = get_spec(family, d)
    B, n_sweeps, seed = 6, 2, (5 << 32) | 0x1234567
    states = _states(spec, B, seed=d, p=0.2)
    eq = betas == "equal"
    row = (np.full(3, 0.9, np.float32) if eq
           else betas_xyz(0.05, 0.02, 0.1).astype(np.float32))
    if betas == "per-chain":
        row = np.random.RandomState(d).uniform(0.2, 3.0, (B, 3)).astype(np.float32)
    em = _emulate_wide(spec, states, seed, row, n_sweeps, eq, lanes)
    ours = sw.sweep_reference(spec, torch.as_tensor(states), seed,
                              torch.as_tensor(row), n_sweeps, eq).numpy()
    np.testing.assert_array_equal(_pack_slots(spec, em.W), ours)
    assert not np.array_equal(ours, states), "the chains never moved"
    assert (np_syndrome(spec, ours) == np_syndrome(spec, states)).all()


def _compare_sampler(spec, states, seeds, row, iters, eq, lanes):
    em, keys, counts, flips = _emulate_sampler(spec, states, seeds, row, iters,
                                               eq, lanes)
    out, k, c = sw.sample_reference(spec, torch.as_tensor(states),
                                    torch.as_tensor(seeds), torch.as_tensor(row),
                                    iters, eq)
    np.testing.assert_array_equal(_pack_slots(spec, em.W), out.numpy())
    np.testing.assert_array_equal(keys, k.numpy())
    np.testing.assert_array_equal(counts, c.numpy())
    return counts, flips


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
def test_emulated_recording_step_equals_pack_key_and_counts(lanes):
    """csrc/sweep.cu::sweep_kernel_wide's recording: the unpack's hashes and
    counts, kept up to date flip by flip in the lanes' shares (wraparound
    u32 hashes, counts 21 bits apart in a u64), summed at each step, equal
    ``pack_key`` and ``count_errors_xyz`` after every step of
    ``sample_reference``, including counts past the register form's 10-bit
    fields."""
    spec = get_spec("toric", 45)
    states = _states(spec, 3, seed=3, p=0.9)
    states[0] = 3 * spec.valid_mask  # every qubit Z: a count of 4050
    seeds = np.asarray([(7 << 32) | 5, 2**31 - 1], np.int64)
    row = np.asarray([2.0, 2.0, 0.0], np.float32)  # Z errors cost nothing
    counts, flips = _compare_sampler(spec, states, seeds, row, 1, False, lanes)
    assert (counts[0, :, 2] > 1023).all()
    assert min(flips) > 0


@pytest.mark.parametrize("lanes", [1, 8])
def test_emulated_recording_keeps_a_step_without_flips(lanes):
    """At infinite equal betas only flips that lower the error count accept
    (no change gives NaN, which rejects): the chains settle, and a step
    that accepts nothing records the key and counts of the step before."""
    spec = get_spec("toric", 23)
    states = _states(spec, 4, seed=8, p=0.3)
    seeds = np.arange(100, 106, dtype=np.int64)
    row = np.full(3, np.inf, np.float32)
    counts, flips = _compare_sampler(spec, states, seeds, row, 1, True, lanes)
    assert flips[0] > 0 and 0 in flips
    s = flips.index(0)
    assert s > 0 and (counts[:, s] == counts[:, s - 1]).all()


@pytest.mark.parametrize("lanes", [2, 32])
def test_emulated_recording_at_zero_betas_accepts_every_proposal(lanes):
    """At zero betas logr is 0 for every proposal, which accepts: every
    stabilizer flips in every sweep, and the records still follow."""
    spec = get_spec("rotated", 33)
    states = _states(spec, 3, seed=9, p=0.2)
    seeds = np.asarray([3, 4], np.int64)
    row = np.zeros(3, np.float32)
    _, flips = _compare_sampler(spec, states, seeds, row, 2, False, lanes)
    assert flips == [2 * 3 * spec.n_stabs] * 2


# ---------------------------------------------------------------------------
# (b) against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("equal_betas", [True, False])
@pytest.mark.parametrize("family,d", EMULATED, ids=[f"{f}-{d}" for f, d in EMULATED])
def test_plain_equals_pallas_interpret_above_1024_qubits(family, d, equal_betas):
    jspec = jax_get_spec(family, d)
    spec = spec_from_jax(jspec)
    B, n_sweeps, batch_tile, seed = 8, 2, 8, 7
    states = _states(spec, B, seed=d + 11)
    betas = (np.full(3, 0.9, np.float32) if equal_betas
             else betas_xyz(0.05, 0.02, 0.1).astype(np.float32))
    fn, _ = make_pallas_sweep(jspec, n_sweeps=n_sweeps, batch_tile=batch_tile,
                              interpret=True, equal_betas=equal_betas)
    theirs = np.asarray(fn(jnp.asarray(states), seed, jnp.asarray(betas)))
    logu = _pallas_logu(jspec, B, n_sweeps, batch_tile, seed)
    ours = sw.sweep_reference(spec, torch.as_tensor(states), 0, betas, n_sweeps,
                              equal_betas, logu=logu).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, states), "the chains never moved"


def test_dense_sweep_equals_jax_above_1024_qubits():
    """Two sweeps of a (2, 3) batch of toric d=23 at a row of betas per
    chain, under the uniforms JAX's ``make_dense_sweep`` draws."""
    jspec = jax_get_spec("toric", 23)
    spec = spec_from_jax(jspec)
    shape = (2, 3)
    states = _states(spec, 6, seed=4, p=0.2).reshape(shape + (spec.nq,))
    betas = np.random.RandomState(5).uniform(0.3, 3.0, shape + (3,)).astype(np.float32)
    n_colors, W = len(spec.color_stabs), sw.stab_width(spec)
    jsweep = jax.jit(jax_dense_sweep(jspec))
    sweep = make_dense_sweep(spec)
    js, ts = jnp.asarray(states), torch.as_tensor(states)
    key = jax.random.PRNGKey(6)
    for _ in range(2):
        key, k = jax.random.split(key)
        logu = np.array(jnp.log(jax.random.uniform(
            k, (n_colors,) + shape + (W,), minval=1e-38)))
        js = jsweep(js, k, jnp.asarray(betas))
        ts = sweep(ts, 0, torch.as_tensor(betas), logu=torch.as_tensor(logu))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not np.array_equal(ts.numpy(), states)


# ---------------------------------------------------------------------------
# (c) the slice as a whole
# ---------------------------------------------------------------------------


def test_stdc_at_toric_d23_in_both_packages():
    """STDC at p_sampling 0.2, 2 droplets, 300 steps (the spread of this
    budget over seeds is about one syndrome in eight in either package)."""
    spec = get_spec("toric", 23)
    s = _states(spec, 8, seed=23, p=0.02)
    truth = np_eq_class(spec, s)
    kw = dict(droplets=2, steps=300)
    ours = STDC(spec, s, 0.02, 0.2, device="cpu", **kw).argmax(1)
    theirs = np.asarray(jd.STDC(jax_get_spec("toric", 23), s, 0.02, 0.2,
                                **kw)).argmax(1)
    assert (ours == truth).sum() >= 7 and (theirs == truth).sum() >= 7
    assert (ours == theirs).sum() >= 7


def test_pteq_at_toric_d23_runs_the_unfused_window():
    spec = get_spec("toric", 23)
    Nc, W, B, p = 3, 8, 2, 0.02
    s = _states(spec, B, seed=24, p=p)
    # the unfused window asked for by name (the window kernel's large
    # variant holds this ladder, tests/test_torch_window_above_1024.py)
    cfg = PTEQConfig(Nc=Nc, max_steps=W, window=W, iters=1, energy_chunk=4,
                     tops_burn=0, engine="sweep")
    pteq_mod._WINDOW_CACHE.clear()
    lw.ladder_window_counts.reset()
    sw.sweep_counts.reset()
    res = PTEQ(spec, s, p, cfg, device="cpu")
    assert res.window == "sweep"  # the unfused window, on the sweep kernel
    assert res.distribution.shape == (B, spec.n_classes)
    assert lw.ladder_window_counts.plain_calls == 0
    assert sw.sweep_counts.plain_calls == W  # one sweep call a ladder step
    # the window keeps every rung's syndrome
    fn = pteq_mod._get_window_fn(spec, Nc, cfg, equal_betas=True)
    ls = init_ladder(spec, torch.as_tensor(s), Nc)
    out = fn(ls, 5, torch.as_tensor(beta_ladder_depolarizing(p, Nc),
                                    dtype=torch.float32),
             torch.zeros((B, spec.n_classes), dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32), np.ones(3, np.float32))
    state = out[0].state.numpy()
    assert not np.array_equal(state, np.asarray(ls.state))
    for r in range(Nc):
        assert (np_syndrome(spec, state[:, r]) == np_syndrome(spec, s)).all()
    pteq_mod._WINDOW_CACHE.clear()


# ---------------------------------------------------------------------------
# (d) the predicate, the limit and no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(LARGEST))
def test_predicate_is_where_sweep_plan_finds_a_launch(family):
    top = LARGEST[family]
    for d in (5, 21, 23, 33, 63, top, top + 2):
        spec = get_spec(family, d)
        assert (d <= top) == (spec.nq <= 64 * sw.MAX_WORDS)
        for record in (True, False):
            fits = sw.sweep_kernel_fits(spec, record)
            launches = []
            for L in (1, 2, 4, 8, 16, 32):
                try:
                    plan = sw.sweep_plan(spec, record, L)
                except ValueError:
                    continue
                launches.append(L)
                assert plan.smem <= kt.SMEM_LIMIT
            assert fits == bool(launches) == (d <= top), (d, record)
            if fits:  # every lane count from the fewest up
                least = sw.least_lanes(spec, record)
                assert launches == [L for L in (1, 2, 4, 8, 16, 32) if L >= least]


BATCHES = (1, 37, 5888, 16384, 40960)
N_SM = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("family", sorted(LARGEST))
def test_large_variant_plan_fills_the_card_in_whole_waves(family, record):
    """``wide_block`` and ``sweep_plan`` at the largest code of each family
    and at toric d=25 and d=45: at most 1024 threads and 227 KB a block, at
    least ``least_lanes``, every chain in a block, and the batch over the
    SMs in as few whole waves as shared memory allows (a wave: one block
    an SM, as many chains as a block's shared memory holds)."""
    for spec in (get_spec(family, LARGEST[family]), get_spec("toric", 25),
                 get_spec("toric", 45)):
        least = sw.least_lanes(spec, record)
        chain = 4 * sw.plane_words(spec) + record * sw.tile_bytes(sw.TILE_STEPS, True)
        cap = (kt.SMEM_LIMIT - sw.sweep_smem_bytes(spec, 0, False, False, 0)) // chain
        for B in BATCHES:
            L, warps = sw.wide_block(spec, record, B, N_SM)
            plan = sw.sweep_plan(spec, record, L, warps)
            assert plan.lanes == L
            assert plan.threads == 32 * warps <= kt.WIDE_MAX_THREADS
            assert warps <= kt.WIDE_WARPS_PER_SM
            assert plan.smem <= kt.SMEM_LIMIT and L >= least
            blocks = -(-B // plan.chains_per_block)
            assert blocks * plan.chains_per_block >= B
            waves = -(-(-(-B // N_SM)) // cap)
            assert blocks <= N_SM * waves, (spec.nq, B, blocks, waves)
            if L < 32:  # twice the lanes would pass 32 warps a block
                assert -(-plan.chains_per_block * 2 * L // 32) > kt.WIDE_WARPS_PER_SM or (
                    2 * L >= 2 * -(-sw.stab_width(spec) // 4))
        for L in (1, 2, 4, 8, 16, 32):  # lanes given: a launch at every count
            if L >= least:
                plan = sw.sweep_plan(spec, record, *sw.wide_block(
                    spec, record, 40960, N_SM, lanes=L))
                assert plan.lanes == L and plan.smem <= kt.SMEM_LIMIT


def test_large_variant_plans_at_the_measured_shapes():
    """The launches PERF.md times: one wave of 128 blocks each."""
    want = {("toric", 25, 40960, True): (2, 20, True, True),
            ("rotated", 45, 5120, True): (16, 20, True, True),
            ("toric", 45, 16384, False): (8, 32, True, False),
            ("toric", 23, 5888, True): (16, 23, True, True)}
    for (family, d, B, record), (L, warps, tab, mults) in want.items():
        spec = get_spec(family, d)
        plan, P = sw._plan_params(spec, B, 40, 1, True, record, N_SM)
        assert (plan.lanes, plan.threads // 32) == (L, warps)
        assert (plan.tab_in_smem, plan.mults_in_smem) == (tab, mults)
        assert -(-B // plan.chains_per_block) == 128
        assert (P.threads, P.chains_per_block) == (plan.threads, plan.chains_per_block)
    # a register instantiation keeps its 256 threads
    plan, P = sw._plan_params(get_spec("toric", 5), 65536, 2, 1, True, True, N_SM)
    assert plan.threads == P.threads == sw.SWEEP_THREADS
    with pytest.raises(ValueError, match="warps=2"):
        sw.sweep_plan(get_spec("toric", 5), True, 1, 2)
    with pytest.raises(ValueError, match="warps=33"):
        sw.sweep_plan(get_spec("toric", 25), True, 1, 33)


def _no_library():
    raise AssertionError("the kernel was built or loaded")


class RecordingLibrary:
    """The sweep library's entry point without a card: records each
    launch's params and returns ``err`` (0: success)."""

    def __init__(self, err=0):
        self.params, self.err = [], err

    def mqt_sweep(self, P, bufs, stream):
        self.params.append({n: getattr(P._obj, n) for n, _ in P._obj._fields_})
        return self.err


@contextlib.contextmanager
def fake_card(monkeypatch, library):
    """The sweep wrapper's CUDA branch on CPU tensors: ``library()`` stands
    in for the built library; no plain call may happen."""
    monkeypatch.setattr(sw, "_library", library)
    monkeypatch.setattr(sw, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    sw.sweep_counts.reset()
    yield
    assert sw.sweep_counts.plain_calls == 0


def test_launch_above_the_limit_raises_before_any_work(monkeypatch):
    spec = get_spec("planar", LARGEST["planar"] + 2)
    states = torch.zeros((2, spec.nq), dtype=torch.uint8)
    with fake_card(monkeypatch, _no_library):
        for seeds in (None, torch.zeros(2, dtype=torch.int64)):
            with pytest.raises(ValueError, match=f"nq={spec.nq}.*nq <= 16384"):
                sw._launch(spec, states, torch.ones(3), steps=2, iters=1,
                           equal_betas=True, seeds=seeds, device_tables={})
    assert sw.sweep_counts.launches == 0


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_a_failing_large_variant_raises(monkeypatch, failure):
    def broken_build():
        raise RuntimeError("nvcc failed (build)")

    lib = RecordingLibrary(err=209)
    spec = get_spec("toric", 23)
    states = torch.as_tensor(_states(spec, 3, seed=1))
    with fake_card(monkeypatch, broken_build if failure == "build" else lambda: lib):
        want = ("nvcc failed" if failure == "build"
                else "sweep kernel launch failed: cudaError 209")
        with pytest.raises(RuntimeError, match=want):
            sw._launch(spec, states, torch.ones(3), steps=1, iters=2,
                       equal_betas=True, device_tables={})
    assert sw.sweep_counts.launches == 0
