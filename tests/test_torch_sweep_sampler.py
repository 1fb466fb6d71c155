"""The counting decoders' recording sampler (ops/sweep.py::
make_recording_sweep, the sweep kernel's recording mode) on the CPU.

(a) The plain recording sampler, given the per-step seeds as one tensor,
    equals the per-step loop it replaces (one ``make_sweep`` call, then
    ``pack_key`` and ``count_errors_xyz``, per step) bit for bit: states,
    keys and counts, on 4 families x both acceptance branches x 1 and 3
    sweeps per step; so does ``make_sampler``, through it.
(b) The kernel's recording arithmetic (csrc/sweep.cu::record_step and the
    unpack), modelled in numpy on random chains for all 27 codes it is
    built for: each lane's share of the qubits and words, wraparound u32
    sums, counts packed 10 bits each and an add butterfly over the lanes
    give pack_key and count_errors_xyz; each lane's share of a row's bytes
    ORed over the lanes gives the bit planes.
(c) The launch plan for all 27 codes: lanes against the batch, chains per
    warp and block, the warp's shared-memory region, tables in shared or
    device memory, and the block's shared memory within the card's bound.
(d) The ctypes structs match the kernel's C structs field for field.
(e) The wrappers' refusals.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mcmc_qec_tpu_torch.ops.ladder_window as lw
import mcmc_qec_tpu_torch.ops.sweep as sw
from mcmc_qec_tpu_torch.decoders.counting import make_sampler
from mcmc_qec_tpu_torch.mcmc.ladder import betas_xyz
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.ops.pauli import count_errors_xyz, make_hash_mults, pack_key

CODES = ([("toric", d) for d in range(3, 20, 2)]
         + [(f, d) for f in ("planar", "rotated", "xzzx") for d in range(3, 14, 2)])
IDS = [f"{f}-{d}" for f, d in CODES]
FAMILIES = [("toric", 5), ("planar", 3), ("rotated", 3), ("xzzx", 3)]
CSRC = Path(sw.__file__).resolve().parent.parent / "csrc" / "sweep.cu"
N_SM = 132  # an H100 SXM's SMs


def _states(spec, B, seed, p=0.3):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 4, (B, spec.nq)) * (rng.rand(B, spec.nq) < p)
    return (s * spec.valid_mask).astype(np.uint8)


def _betas(equal_betas):
    return torch.as_tensor(np.full(3, 0.9) if equal_betas
                           else betas_xyz(0.05, 0.02, 0.1), dtype=torch.float32)


def _seeds(steps, seed):
    """make_sampler's per-step seeds (decoders/counting.py)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**31 - 1, (steps,), generator=gen)


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("equal_betas", [True, False])
@pytest.mark.parametrize("family,d", FAMILIES)
def test_plain_sampler_equals_the_per_step_loop(family, d, equal_betas, iters):
    spec = get_spec(family, d)
    steps, seed = 5, 11
    s0 = torch.as_tensor(_states(spec, 12, seed=d))
    betas = _betas(equal_betas)
    seeds = _seeds(steps, seed)
    # the loop the kernel replaces
    sweep = sw.make_sweep(spec, iters, equal_betas)
    mults = make_hash_mults(spec)
    flat, keys, counts = s0, [], []
    for t in range(steps):
        flat = sweep(flat, int(seeds[t]), betas)
        keys.append(pack_key(spec, flat, mults))
        counts.append(count_errors_xyz(flat))
    keys, counts = torch.stack(keys, 1), torch.stack(counts, 1)

    out, k, c = sw.sample_reference(spec, s0, seeds, betas, iters, equal_betas)
    assert k.dtype == torch.int64 and c.dtype == torch.int32
    assert torch.equal(out, flat) and torch.equal(k, keys) and torch.equal(c, counts)
    assert not torch.equal(out, s0), "the chains never moved"
    assert bool((k >= 0).all()) and bool((k < 2**32).all())

    # make_sampler: the same stream on a (2, 6) batch, one plain call
    sw.sweep_counts.reset()
    final, stream = make_sampler(spec, steps, iters, engine="auto",
                                 equal_betas=equal_betas)(
        s0.reshape(2, 6, spec.nq), seed, betas)
    assert (sw.sweep_counts.launches, sw.sweep_counts.plain_calls) == (0, 1)
    assert torch.equal(final.reshape(-1, spec.nq), flat)
    assert torch.equal(stream.keys.reshape(12, steps, 2), keys)
    assert torch.equal(stream.n_xyz.reshape(12, steps, 3), counts)


def _butterfly(parts, op):
    """Every lane's value after the kernel's XOR butterfly over L lanes."""
    parts = list(parts)
    L = len(parts)
    k = 1
    while k < L:
        parts = [op(parts[l], parts[l ^ k]) for l in range(L)]
        k <<= 1
    assert all(np.array_equal(p, parts[0]) for p in parts)
    return parts[0]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("family,d", CODES, ids=IDS)
def test_recording_arithmetic_models_pack_key_and_counts(family, d, lanes):
    spec = get_spec(family, d)
    nq, nw = spec.nq, lw.kernel_words(spec.nq)
    L = lanes
    R = 16
    states = _states(spec, R, seed=d, p=0.5)
    states[0] = 0
    states[1] = 3 * spec.valid_mask  # every qubit Z: counts near nq
    v = states.astype(np.int64)
    xbit, zbit = (v ^ (v >> 1)) & 1, (v >> 1) & 1
    m = make_hash_mults(spec)  # (2, nq) uint32

    # unpack: lane l ORs in the bits of qubits 64w + k, k = l, l + L, ...
    def words_of(bits, lane):
        out = np.zeros((R, nw), np.uint64)
        for q in range(nq):
            if (q % 64) % L == lane:
                out[:, q // 64] |= bits[:, q].astype(np.uint64) << np.uint64(q % 64)
        return out

    X = _butterfly([words_of(xbit, l) for l in range(L)], np.bitwise_or)
    Z = _butterfly([words_of(zbit, l) for l in range(L)], np.bitwise_or)
    for w in range(nw):
        for k in range(64):
            q = 64 * w + k
            xs = (X[:, w] >> np.uint64(k)) & np.uint64(1)
            zs = (Z[:, w] >> np.uint64(k)) & np.uint64(1)
            if q < nq:
                np.testing.assert_array_equal(xs, xbit[:, q])
                np.testing.assert_array_equal(zs, zbit[:, q])
                # the pack: x ^ 3z is the Pauli value
                np.testing.assert_array_equal(
                    (xs ^ (np.uint64(3) * zs)).astype(np.uint8), states[:, q])
            else:  # padding bits stay zero in both planes
                assert not xs.any() and not zs.any()

    # record_step: per lane, wraparound u32 sums over its qubits and packed
    # popcounts over its words
    def popc(a):
        return np.unpackbits(a.view(np.uint8).reshape(R, 8), axis=1).sum(1)

    h0, h1, cnt = [], [], []
    for lane in range(L):
        a0 = np.zeros(R, np.uint32)
        a1 = np.zeros(R, np.uint32)
        c = np.zeros(R, np.uint32)
        for w in range(nw):
            a, z = X[:, w] ^ Z[:, w], Z[:, w]
            if (w & (L - 1)) == lane:
                x_only = popc(np.ascontiguousarray(X[:, w] & ~Z[:, w]))
                y = popc(np.ascontiguousarray(X[:, w] & Z[:, w]))
                z_only = popc(np.ascontiguousarray(~X[:, w] & Z[:, w]))
                c += (x_only | (y << 10) | (z_only << 20)).astype(np.uint32)
            for k in range(lane, min(64, nq - 64 * w), L):
                val = (((a >> np.uint64(k)) & np.uint64(1))
                       + np.uint64(2) * ((z >> np.uint64(k)) & np.uint64(1))).astype(np.uint32)
                a0 += m[0, 64 * w + k] * val
                a1 += m[1, 64 * w + k] * val
        h0.append(a0)
        h1.append(a1)
        cnt.append(c)
    h0, h1, cnt = (_butterfly(p, np.add) for p in (h0, h1, cnt))
    key = pack_key(spec, torch.as_tensor(states), m).numpy()
    np.testing.assert_array_equal(h0.astype(np.int64), key[:, 0])
    np.testing.assert_array_equal(h1.astype(np.int64), key[:, 1])
    n = np.stack([(cnt >> s) & 1023 for s in (0, 10, 20)], 1)
    np.testing.assert_array_equal(n, count_errors_xyz(torch.as_tensor(states)).numpy())
    assert nq < 1024  # a packed count never carries into the next


@pytest.mark.parametrize("family,d", CODES, ids=IDS)
def test_sweep_plan(family, d):
    spec = get_spec(family, d)
    offs = lw.kernel_tables(spec)[2]
    most = lw.lanes_per_rung(offs, 1)
    want = min(8, -(-offs["w_max"] // 4))
    assert most == 1 << max(0, want - 1).bit_length()  # the next power of two
    # lanes against the batch: the fewest that still give every SM
    # MIN_WARPS_PER_SM warps, at most ``most``
    need = 32 * N_SM * sw.MIN_WARPS_PER_SM
    prev = most
    for B in (1, 7, 2048, 8192, 16384, 33792, 65536, 1 << 20):
        L = sw.lanes_per_chain(offs, B, N_SM)
        assert L & (L - 1) == 0 and 1 <= L <= prev
        assert L == 1 or B * (L // 2) < need
        assert L == most or B * L >= need
        prev = L
    if family == "toric" and d == 5:  # the STDC main path's 65,536 chains
        assert sw.lanes_per_chain(offs, 65536, N_SM) == 1
        assert sw.lanes_per_chain(offs, 2048, N_SM) == 4
    for record in (True, False):
        for L in (1, 2, 4, 8):
            plan = sw.sweep_plan(spec, record, L)
            assert plan.lanes == L
            assert plan.chains_per_warp * L == 32
            assert plan.chains_per_block * L == sw.SWEEP_THREADS
            assert plan.tile_steps == sw.TILE_STEPS
            cpw = plan.chains_per_warp
            tile = 4 * (3 * plan.tile_steps + 2)  # 2 hashes + counts a step, padded
            assert sw.tile_bytes(plan.tile_steps) == tile
            assert plan.region_bytes % 16 == 0
            assert plan.region_bytes >= cpw * spec.nq
            if record:
                assert plan.region_bytes >= cpw * tile
            assert plan.region_bytes < cpw * max(spec.nq, tile * record) + 16
            with_tab = sw.sweep_smem_bytes(spec, plan.region_bytes, True)
            assert plan.tab_in_smem == (sw.MIN_BLOCKS_PER_SM * with_tab <= lw.SMEM_LIMIT)
            assert plan.smem == sw.sweep_smem_bytes(spec, plan.region_bytes,
                                                    plan.tab_in_smem)
            assert plan.smem <= lw.SMEM_LIMIT
            # the table part is the spanned-word table, 3 words per entry
            assert with_tab - sw.sweep_smem_bytes(spec, plan.region_bytes, False) == (
                8 * spec.n_stabs * 3 * offs["span"])
    if family == "toric":
        # at the widest lanes, toric d <= 13 keep the tables in shared
        # memory; d=15-19 read them from device memory
        assert sw.sweep_plan(spec, True, most).tab_in_smem == (d <= 13)
    # the stored rows of one tile are whole 32-byte sectors
    assert (16 * sw.TILE_STEPS) % 32 == 0 and (12 * sw.TILE_STEPS) % 32 == 0


def _c_fields(struct: str):
    """(C type, name) of each field of ``struct`` in csrc/sweep.cu, in
    order."""
    src = CSRC.read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S)[1]
    out = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.match(r"(const )?(\w+)(\*?) (.*);", line)
        ctype = m[2] + m[3]
        out += [(ctype, n.strip().lstrip("*")) for n in m[4].split(",")]
    return out


def test_ctypes_structs_match_the_c_structs():
    params = _c_fields("SweepParams")
    assert [n for _, n in params] == [n for n, _ in sw._Params._fields_]
    for (c, _), (_, t) in zip(params, sw._Params._fields_):
        assert t.__name__ == {"int32_t": "c_int", "uint32_t": "c_uint"}[c]
    bufs = _c_fields("SweepBuffers")
    assert [n for _, n in bufs] == [n for n, _ in sw._Buffers._fields_]
    assert all(c.endswith("*") for c, _ in bufs)


def test_wrappers_refuse():
    spec = get_spec("toric", 3)
    states = torch.as_tensor(_states(spec, 4, seed=1))
    fn = sw.make_recording_sweep(spec, 3)
    with pytest.raises(ValueError, match="2 seeds for 3 steps"):
        fn(states, torch.zeros(2, dtype=torch.int64), torch.ones(3))
    with pytest.raises(ValueError, match="no sweep for device"):
        fn(states.to("meta"), torch.zeros(3, dtype=torch.int64), torch.ones(3))
    with pytest.raises(ValueError, match="no sweep for device"):
        sw.make_sweep(spec, 1)(states.to("meta"), 1, torch.ones(3))
    with pytest.raises(ValueError, match="expected counts >= 0"):
        sw.make_recording_sweep(spec, -1)
    # the launch checks its inputs before it loads the kernel
    kw = dict(steps=3, iters=1, equal_betas=True, device_tables={})
    seeds = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="states must be torch.uint8"):
        sw._launch(spec, states.int(), torch.ones(3), seeds=seeds, **kw)
    with pytest.raises(ValueError, match="qubits"):
        sw._launch(spec, states[:, :-1], torch.ones(3), seeds=seeds, **kw)
    with pytest.raises(ValueError, match="betas must have shape"):
        sw._launch(spec, states, torch.ones(4), seeds=seeds, **kw)
    with pytest.raises(ValueError, match="seeds must have shape"):
        sw._launch(spec, states, torch.ones(3), seeds=seeds[:2], **kw)
    # the plan refuses codes above 12 words per plane
    with pytest.raises(NotImplementedError, match="words per plane"):
        sw._plan_params(get_spec("toric", 21), 4, 3, 1, True, True, N_SM)


def test_plain_sampler_runs_any_code_size_on_the_cpu():
    """Only the kernel is bounded by its words per plane: the plain sampler
    runs toric d=21 (14 words)."""
    spec = get_spec("toric", 21)
    states = torch.zeros((2, spec.nq), dtype=torch.uint8)
    out, keys, counts = sw.make_recording_sweep(spec, 2, equal_betas=True)(
        states, torch.tensor([3, 4]), torch.full((3,), 0.5))
    assert out.shape == states.shape and keys.shape == (2, 2, 2)
    assert torch.equal(counts[:, -1], count_errors_xyz(out))
