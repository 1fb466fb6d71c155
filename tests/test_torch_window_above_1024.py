"""The PT window kernel's large variant (csrc/ladder_window.cu::
ladder_window_kernel_wide, planes in shared memory) through what the CPU
can reach of it.

(a) The plain window equals ``make_pallas_ladder_window(...,
    interpret=True)`` in zeros mode, all nine outputs bit for bit, at
    toric d=23 and rotated d=33 (17 and 18 words per plane).
(b) A numpy emulation of the large variant on u64 planes, read through the
    kernel's tables only, equals the plain window on the same Philox (or
    fixed) draws: the rung's lanes take whole Philox blocks of a color and
    run in step, each accepted flip XORed into the planes at once; the
    exchange swaps slot indices and the state is written back through
    them; the class, hash and counts are read off the slots.  At toric and
    planar d=23, xzzx d=31 (16 words: the narrow entry) and xzzx d=33, in
    both betas forms, trace mode, even_odd and a fixed draw word.
(c) ``window_form`` at Nc = d and two sweeps a step: the register form up
    to toric d=21, the large variant for every code the JAX package fuses
    on the TPU and the port ran unfused before (toric d=23/25, planar
    d=23-27, rotated and XZZX d=31-37), in both betas forms; where it names
    a form, that form's block shape fits 227 KB and 512 threads at every
    batch.
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


@pytest.mark.parametrize("family,d", [("toric", 23), ("rotated", 33)])
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


def _emulate_large(spec, inputs, seed, betas, weights, *, W, iters, p_logical,
                   tops_burn, C, top_exact, equal_betas, exchange, traces,
                   rng, lanes):
    """One window of the large variant, read through ``kernel_tables`` and
    the window's draws only."""
    state, flag, tops0, eq_count, since = (np.array(a) for a in inputs)
    B, Nc, nq = state.shape
    tab, meta, offs = lw.kernel_tables(spec)
    wt = tab[offs["off_draw"]:].view(np.uint64)  # the window kernel's table
    nw, S, n_colors, n_s = offs["nw"], offs["span"], offs["n_colors"], spec.n_stabs
    base = offs["off_draw"]
    heads = meta[offs["m_span"]: offs["m_span"] + n_s].astype(np.int64)
    if offs["m_wide"] is None:  # up to 16 words: the narrow entry's indices
        words = (heads[:, None] >> (12 + 4 * np.arange(S))) & 15
    else:
        wides = meta[offs["m_wide"]:].view(np.uint32).astype(np.int64)
        words = (wides[:, None] >> (8 * np.arange(S))) & 255
    ent = wt[offs["off_span"] - base:].reshape(n_s, S, 3)
    cx, cz = (heads >> 4) & 15, (heads >> 8) & 15
    starts = meta[: n_colors + 1]
    G, n_blk, n_xblk = lw._rng_layout(spec, Nc, iters)
    fixed = lw._fixed_word(rng)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    b3 = np.asarray(betas, np.float32).reshape(Nc, 3)
    w3 = np.asarray(weights, np.float32)
    K, n_draws = spec.n_classes, len(spec.logical_draws)

    X, Z = _unpack(spec, state.reshape(B * Nc, nq))
    X, Z = X.reshape(B, Nc, nw), Z.reshape(B, Nc, nw)  # by slot
    slot = np.tile(np.arange(Nc), (B, 1))
    bi = np.arange(B)[:, None]
    fl, tops, eqc, sb = flag.copy(), tops0.astype(np.int64), eq_count.copy(), since.copy()
    bfirst = np.full(B, -1)
    swaps = np.zeros((B, Nc - 1), np.int32)
    esum = np.zeros((B, 1 if equal_betas else 3), np.int64)
    energies = np.zeros((W // C, B), np.float32)
    eq_tr = np.zeros((W, B), np.int32)
    key_tr = np.zeros((W, B, lw.N_KEY), np.int32)

    def counts(x, z):
        if equal_betas:
            return _popc(x | z).sum(-1)[..., None]
        return np.stack([_popc(x & ~z).sum(-1), _popc(x & z).sum(-1),
                         _popc(~x & z).sum(-1)], -1)

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
                mx ^= np.where(on[:, None], wt[at], np.uint64(0))
                mz ^= np.where(on[:, None], wt[at + nw], np.uint64(0))
        return mx, mz

    for t in range(W):
        lu = _log_u(lw._draw_words(k0, k1, t, t + 1, B, 0, G, n_blk, fixed,
                                   "cpu"))[0]  # (B, G, 4 n_blk)
        extra = lw._draw_words(k0, k1, t, t + 1, B, G, 4, n_xblk, fixed,
                               "cpu")[0]  # (B, 4, 4 n_xblk)
        # 1) sweeps: per color the rung's lanes in step, lane l on blocks
        # l, l + L, ..., element e of its k-th block in round 4k + e; every
        # decision reads the planes as the earlier rounds left them
        for it in range(iters):
            for c in range(n_colors):
                c0, n = int(starts[c]), int(starts[c + 1] - starts[c])
                nb = -(-n // 4)
                use = (it * n_colors + c) * Nc + np.arange(Nc)
                for rnd in range(4 * -(-nb // lanes)):
                    g = np.arange(lanes) + lanes * (rnd // 4)
                    j = 4 * g + rnd % 4
                    j = j[(g < nb) & (j < n)]
                    if not len(j):
                        continue
                    s = c0 + j
                    Wd = words[s]  # (m, S)
                    idx = (bi[:, :, None, None], slot[:, :, None, None], Wd)
                    x, z = X[idx], Z[idx]  # (B, Nc, m, S)
                    su, xm, zm = ent[s, :, 0], ent[s, :, 1], ent[s, :, 2]
                    if equal_betas:
                        d0 = (_popc(((x ^ xm) | (z ^ zm)) & su)
                              - _popc((x | z) & su)).sum(-1)
                        logr = -(b3[:, 0, None] * d0.astype(np.float32))
                    else:
                        tx, tz = _popc(x & xm).sum(-1), _popc(z & zm).sum(-1)
                        d0 = (_popc((x ^ xm) & (z ^ zm) & su)
                              - _popc(x & z & su)).sum(-1)
                        d1 = ((cx[s] - 2 * tx) - d0).astype(np.float32)
                        d3 = ((cz[s] - 2 * tz) - d0).astype(np.float32)
                        logr = -((b3[:, 0, None] * d1 + b3[:, 1, None]
                                  * d0.astype(np.float32)) + b3[:, 2, None] * d3)
                    u = lu[:, use][:, :, j]  # (B, Nc, m)
                    acc = (logr >= 0) | (u < logr)
                    keep = np.where(acc[..., None], ~np.uint64(0), np.uint64(0))
                    full = tuple(np.broadcast_to(a, x.shape) for a in idx)
                    np.bitwise_xor.at(X, full, xm & keep)
                    np.bitwise_xor.at(Z, full, zm & keep)
        # 2) the top rung's logical mix, on its slot
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
                    x, z = X[np.arange(B), top], Z[np.arange(B), top]
                    nx, nz = x ^ mx, z ^ mz
                    dn = [(_popc(a).sum(-1) - _popc(o).sum(-1)).astype(np.float32)
                          for a, o in ((nx & ~nz, x & ~z), (nx & nz, x & z),
                                       (~nx & nz, ~x & z))]
                    bt = b3[-1]
                    logr = -((bt[0] * dn[0] + bt[1] * dn[1]) + bt[2] * dn[2])
                    acc = gated & ((logr >= 0) | (mlogu[:, it] < logr))
                X[np.arange(B), top] ^= np.where(acc[:, None], mx, np.uint64(0))
                Z[np.arange(B), top] ^= np.where(acc[:, None], mz, np.uint64(0))
        # 3) exchange on the slots; 4) flags; 5) the bottom rung's readout
        cnt = counts(X[bi, slot], Z[bi, slot])  # (B, Nc, 1 or 3)
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
        x0, z0 = X[np.arange(B), slot[:, 0]], Z[np.arange(B), slot[:, 0]]
        bits = np.zeros(B, np.int64)
        for f in range(spec.n_class_bits):
            a = wt[offs["off_class"] - base + f * 2 * nw + np.arange(2 * nw)]
            par = _popc(a[:nw] & x0).sum(-1) + _popc(a[nw:] & z0).sum(-1)
            bits |= (par & 1) << f
        cls = meta[offs["m_b2e"] + bits]
        eqc[np.arange(B)[burned], cls[burned]] += 1
        eq_tr[t] = cls
        for c in range(lw.N_KEY):
            key = np.zeros(B, np.int64)
            for k in range(6):
                m = wt[offs["off_key"] - base + (c * 6 + k) * nw + np.arange(nw)]
                key += (_popc(x0 & ~z0 & m).sum(-1) + 2 * _popc(x0 & z0 & m).sum(-1)
                        + 3 * _popc(~x0 & z0 & m).sum(-1)) << k
            key_tr[t, :, c] = key
    # the state written back through the slots
    out_state = _pack(spec, X[bi, slot].reshape(B * Nc, nw),
                      Z[bi, slot].reshape(B * Nc, nw)).reshape(B, Nc, nq)
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


@pytest.mark.parametrize("family,d", TABLE, ids=[f"{f}-{d}" for f, d in TABLE])
def test_the_large_variant_holds_every_code_the_jax_package_fuses(family, d):
    spec = get_spec(family, d)
    offs = lw.kernel_tables(spec)[2]
    K, nd = spec.n_classes, len(spec.logical_draws)
    for eq in (True, False):
        assert lw.window_form(spec, d, eq, 2) == "large", eq
        assert lw.window_kernel_fits(spec, d, eq, 2)
        for B in (1, 16, 64, 263, 4096):
            shape = lw.wide_block_shape(offs, d, K, B, 132, eq, 2, nd)
            assert shape.lanes == 8 and d * shape.lanes <= shape.threads
            assert shape.threads <= lw.MAX_THREADS
            assert shape.smem == lw.wide_smem_bytes(offs, d, K,
                                                    shape.groups_per_block, eq,
                                                    2, nd, shape.tab_in_smem)
            assert shape.smem <= lw.SMEM_LIMIT
    # the register form keeps every ladder it held
    assert lw.window_form(get_spec("toric", 21), 21, True, 2) == "registers"
    assert lw.window_form(get_spec("xzzx", 29), 29, False, 2) == "registers"


@pytest.mark.parametrize("family,d,Nc,want", [
    ("toric", 5, 5, "registers"),
    ("xzzx", 31, 31, "large"),      # 16 words: the group too large for registers
    ("xzzx", 31, 5, "registers"),
    ("toric", 5, 128, "registers"),  # 128 rungs x 4 lanes: 512 threads
    ("toric", 5, 129, "large"),     # past them: fewer lanes a rung
    ("toric", 5, 512, "large"),     # one lane a rung
    ("toric", 5, 513, None),        # more rungs than a block has threads
    ("toric", 45, 45, "large"),     # 64 words
    ("toric", 45, 182, "large"),    # 182 slots of 129 words in 227 KB
    ("toric", 45, 184, None),       # 184 do not fit
    ("planar", 91, 3, None),        # 259 words: no entry names a word
])
def test_window_form_at_the_limits(family, d, Nc, want):
    spec = get_spec(family, d)
    for eq in (True, False):
        assert lw.window_form(spec, Nc, eq, 2) == want
        assert lw.window_kernel_fits(spec, Nc, eq, 2) == (want is not None)
    if want == "large":
        offs = lw.kernel_tables(spec)[2]
        shape = lw.wide_block_shape(offs, Nc, spec.n_classes, 512, 132, True,
                                    2, len(spec.logical_draws))
        assert Nc * shape.lanes <= shape.threads <= lw.MAX_THREADS
        assert shape.smem <= lw.SMEM_LIMIT


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
    assert lw.window_form(spec, Nc, True, 1) == "large"
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
