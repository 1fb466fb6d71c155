"""The premises of the window kernel's layout (csrc/ladder_window.cu), held
on the CPU for every family and size it is built for.

(a) A color's stabilizers share no qubit on the kernel's own table, so the
    kernel may decide a whole color on the planes as they stood before it.
(b) The spanned-word table: per stabilizer the words its support spans (at
    most 4), its masks there, and the counts of its op's X and Z qubits;
    the changes a proposal makes, computed on those words alone by the
    kernel's formulas, equal the changes over the whole plane.
(c) The Philox block table: each block of a sweep use's draws belongs to
    one color and covers four of its stabilizers.
(d) The launch shape: lanes, warps per syndrome, groups per block and
    shared memory within the card's bounds at every batch and rung count
    the smoke check uses.
"""

import numpy as np
import pytest

import mcmc_qec_tpu_torch.ops.kernel_tables as kt
import mcmc_qec_tpu_torch.ops.ladder_window as lw
from mcmc_qec_tpu_torch.models import get_spec

CODES = ([(f, d) for f in ("toric", "planar") for d in range(3, 22, 2)]
         + [(f, d) for f in ("rotated", "xzzx") for d in range(3, 28, 2)])
IDS = [f"{f}-{d}" for f, d in CODES]
BATCHES = (1, 7, 512, 2048, 8192)
N_SM = 132  # an H100 SXM's SMs


def _popc(a: np.ndarray) -> np.ndarray:
    """Bit count of each uint64 along the last axis, summed."""
    bits = np.unpackbits(np.ascontiguousarray(a).view(np.uint8), axis=-1)
    return bits.sum(-1, dtype=np.int64)


def _tables(family, d):
    spec = get_spec(family, d)
    tab, meta, offs = kt.kernel_tables(spec)
    tab = tab.view(np.uint64)
    nw = offs["nw"]
    dense = tab[: offs["off_draw"]].reshape(spec.n_stabs, 3, nw)
    span = tab[offs["off_span"]:].reshape(spec.n_stabs, offs["span"], 3)
    packed = meta[offs["m_span"]: offs["m_span"] + spec.n_stabs]
    return spec, meta, offs, dense, span, packed


@pytest.mark.parametrize("family,d", CODES, ids=IDS)
def test_colors_are_conflict_free_on_the_kernel_table(family, d):
    spec, meta, offs, dense, _, _ = _tables(family, d)
    starts = meta[: offs["n_colors"] + 1]
    assert starts[-1] == spec.n_stabs
    for c0, c1 in zip(starts[:-1], starts[1:]):
        supp = dense[c0:c1, 0]  # (n, nw)
        union = np.bitwise_or.reduce(supp, axis=0)
        # disjoint iff the union has as many qubits as the parts together
        assert int(_popc(supp).sum()) == int(_popc(union[None])[0])


@pytest.mark.parametrize("family,d", CODES, ids=IDS)
def test_spanned_word_table(family, d):
    spec, _, offs, dense, span, packed = _tables(family, d)
    nw, S = offs["nw"], offs["span"]
    assert 1 <= S <= 4
    for s in range(spec.n_stabs):
        words, cx, cz = kt.unpack_span(int(packed[s]))
        assert words == [w for w in range(nw) if dense[s, 0, w]]
        assert len(words) <= S
        for m, w in enumerate(words):
            np.testing.assert_array_equal(span[s, m], dense[s, :, w])
        assert not span[s, len(words):].any()
        assert cx == int(_popc(dense[s, 1][None])[0])
        assert cz == int(_popc(dense[s, 2][None])[0])

    # the kernel's deltas on the spanned words against the whole plane's
    rng = np.random.RandomState(d)
    vmask = np.array([(1 << min(64, max(0, spec.nq - 64 * w))) - 1
                      for w in range(nw)], np.uint64)

    def plane():
        hi, lo = rng.randint(0, 2**32, size=(2, nw), dtype=np.uint64)
        return ((hi << np.uint64(32)) | lo) & vmask

    for _ in range(3):
        X, Z = plane(), plane()
        su, xs, zs = dense[:, 0], dense[:, 1], dense[:, 2]
        nX, nZ = X ^ xs, Z ^ zs

        def counts(x, z):
            return (_popc(x & ~z & su), _popc(x & z & su), _popc(~x & z & su),
                    _popc((x | z) & su))

        old, new = counts(X, Z), counts(nX, nZ)
        d_all = [n.astype(int) - o.astype(int) for n, o in zip(new, old)]
        w = np.array([[(int(v) >> (12 + 4 * m)) & 15 for m in range(S)]
                      for v in packed])
        x, z = X[w], Z[w]  # (n_stabs, S) plane words under each entry
        esu, exs, ezs = span[..., 0], span[..., 1], span[..., 2]
        dn = (_popc((((x ^ exs) | (z ^ ezs)) & esu)[..., None])
              - _popc(((x | z) & esu)[..., None])).sum(-1)
        tx = _popc((x & exs)[..., None]).sum(-1)
        tz = _popc((z & ezs)[..., None]).sum(-1)
        dy = (_popc(((x ^ exs) & (z ^ ezs) & esu)[..., None])
              - _popc((x & z & esu)[..., None])).sum(-1)
        cx = (packed >> 4) & 15
        cz = (packed >> 8) & 15
        np.testing.assert_array_equal(dn, d_all[3])
        np.testing.assert_array_equal(dy, d_all[1])
        np.testing.assert_array_equal((cx - 2 * tx) - dy, d_all[0])
        np.testing.assert_array_equal((cz - 2 * tz) - dy, d_all[2])


@pytest.mark.parametrize("family,d", CODES, ids=IDS)
def test_draw_block_table(family, d):
    spec, meta, offs, _, _, _ = _tables(family, d)
    starts = meta[: offs["n_colors"] + 1]
    n_per = np.diff(starts)
    blk = meta[offs["m_blk"]: offs["m_blk"] + offs["n_colors"] + 1]
    np.testing.assert_array_equal(np.diff(blk), -(-n_per // 4))
    assert offs["n_blk"] == blk[-1]
    assert offs["w_max"] == n_per.max()
    bcol = meta[offs["m_bcol"]: offs["m_bcol"] + offs["n_blk"]]
    for k, c in enumerate(bcol):
        g = k - blk[c]
        assert 0 <= 4 * g < n_per[c]


@pytest.mark.parametrize("family,d", CODES, ids=IDS)
def test_block_shape_within_the_card(family, d):
    spec, _, offs, _, _, _ = _tables(family, d)
    K, nd = spec.n_classes, len(spec.logical_draws)
    for Nc in sorted({3, 5, 13, d}):
        for B in BATCHES:
            for eq in (True, False):
                shape = lw.block_shape(offs, Nc, K, B, N_SM, eq, 2, nd)
                L = shape.lanes
                assert L == kt.lanes_per_rung(offs, Nc) and L & (L - 1) == 0
                # one warp per syndrome exactly where its lanes fit one
                assert (shape.warps_per_group == 1) == (Nc * L <= 32)
                assert shape.warps_per_group == -(-Nc * L // 32)
                gpb = shape.groups_per_block
                assert 1 <= gpb <= max(1, -(-B // N_SM))
                if shape.warps_per_group > 1:
                    assert gpb <= lw.MAX_NAMED_BARRIERS
                assert shape.threads == 32 * shape.warps_per_group * gpb
                assert shape.threads <= lw.MAX_THREADS
                fits = lw.smem_bytes(offs, Nc, K, 1, eq, 2, nd, True)
                assert shape.tab_in_smem == (fits <= kt.SMEM_LIMIT)
                assert shape.smem == lw.smem_bytes(offs, Nc, K, gpb, eq, 2, nd,
                                                   shape.tab_in_smem)
                assert shape.smem <= kt.SMEM_LIMIT
