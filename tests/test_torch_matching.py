"""The port's matcher (``mcmc_qec_tpu_torch.native``) and MWPM graph layer
(``mcmc_qec_tpu_torch.matching``) against brute force and against the JAX
package's copies.

(a) ``blossom.cpp`` is a byte-identical copy of the JAX package's; the
    port builds it into ``build/blossom-<hash>/`` and concurrent builds
    leave one loadable library.
(b) ``mwpm_solve`` against ``brute_force_mwpm`` on the random graphs of
    tests/test_matching.py:13-56 (complete and sparse), and equal to the
    JAX package's ``mwpm_solve`` on the same graphs.
(c) ``mwpm_correction``, ``class_sorted_mwpm_batch``,
    ``regular_mwpm_batch`` and ``enhanced_mwpm`` on planar and toric d=3
    and d=5, on states made by numpy from a seed, equal to the JAX
    functions bit for bit.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from mcmc_qec_tpu import matching as jax_matching
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.native import mwpm_solve as jax_mwpm_solve
from mcmc_qec_tpu_torch import matching, native
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class, np_syndrome

REPO = Path(__file__).resolve().parents[1]
GRAPHS = [("complete", t) for t in range(30)] + [("sparse", t) for t in range(10)]
CODES = [("planar", 3), ("planar", 5), ("toric", 3), ("toric", 5)]


def _graph(kind, trial):
    """tests/test_matching.py's random graphs: complete graphs on 2-10
    nodes, or sparse ones (each edge kept w.p. 0.7) on 4-8 nodes."""
    if kind == "complete":
        rng = np.random.RandomState(trial)
        n = rng.choice([2, 4, 6, 8, 10])
        edges = [(u, v, rng.randint(0, 50))
                 for u in range(n) for v in range(u + 1, n)]
    else:
        rng = np.random.RandomState(100 + trial)
        n = rng.choice([4, 6, 8])
        edges = []
        for u in range(n):
            for v in range(u + 1, n):
                if rng.rand() < 0.7:
                    edges.append((u, v, rng.randint(0, 30)))
    edges = np.array(edges) if edges else np.zeros((0, 3), int)
    return int(n), edges


def _states(spec, p, n, seed):
    rng = np.random.RandomState(seed)
    s = np.where(rng.uniform(size=(n, spec.nq)) < p,
                 rng.randint(1, 4, size=(n, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


def test_blossom_source_is_the_jax_packages():
    ours = (REPO / "mcmc_qec_tpu_torch" / "native" / "blossom.cpp").read_bytes()
    theirs = (REPO / "mcmc_qec_tpu" / "native" / "blossom.cpp").read_bytes()
    assert ours == theirs


def test_builds_into_the_build_directory_atomically():
    """Six builds at once (the tier-1 workers' first use) each rename a
    finished library into place; the result loads and solves."""
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_library(force=True))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    lib = Path(paths[0])
    assert set(paths) == {str(lib)}
    assert lib.parent.parent == REPO / "mcmc_qec_tpu_torch" / "build"
    assert lib.parent.name.startswith("blossom-") and lib.name == "libblossom.so"
    match, total = native.mwpm_solve(4, np.array([(0, 1, 5), (2, 3, 0),
                                                  (0, 2, 1), (1, 3, 1)]))
    assert total == 2 and match.tolist() == [2, 3, 0, 1]


@pytest.mark.parametrize("kind,trial", GRAPHS)
def test_mwpm_solve_against_brute_force(kind, trial):
    n, edges = _graph(kind, trial)
    bf_match, bf_total = native.brute_force_mwpm(n, edges)
    if bf_match is None:
        with pytest.raises(ValueError):
            native.mwpm_solve(n, edges)
        return
    match, total = native.mwpm_solve(n, edges)
    assert total == bf_total
    assert np.all(match[match] == np.arange(n)) and np.all(match >= 0)


@pytest.mark.parametrize("kind,trial", GRAPHS)
def test_mwpm_solve_equals_jax(kind, trial):
    n, edges = _graph(kind, trial)
    if native.brute_force_mwpm(n, edges)[0] is None:
        return  # no perfect matching: both raise (previous test)
    ours = native.mwpm_solve(n, edges)
    theirs = jax_mwpm_solve(n, edges)
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_larger_graph_equals_jax():
    rng = np.random.RandomState(7)
    n = 100
    iu, iv = np.triu_indices(n, 1)
    edges = np.stack([iu, iv, rng.randint(0, 1000, len(iu))], axis=1)
    ours, theirs = native.mwpm_solve(n, edges), jax_mwpm_solve(n, edges)
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])


@pytest.mark.parametrize("family,d", CODES)
def test_mwpm_correction_and_regular_batch_equal_jax(family, d):
    spec, jspec = get_spec(family, d), jax_get_spec(family, d)
    states = _states(spec, 0.12, 16, seed=d + len(family))
    for s in states:
        ours = matching.mwpm_correction(spec, s)
        np.testing.assert_array_equal(
            ours, jax_matching.mwpm_correction(jspec, s))
        assert np.array_equal(np_syndrome(spec, ours.reshape(-1)),
                              np_syndrome(spec, s))
        np.testing.assert_array_equal(
            matching.mwpm_correction(spec, s, random_pairing=True, seed=3),
            jax_matching.mwpm_correction(jspec, s, random_pairing=True,
                                         seed=3))
    ours = matching.regular_mwpm_batch(spec, states)
    np.testing.assert_array_equal(
        ours, jax_matching.regular_mwpm_batch(jspec, states))
    # the pooled batch equals the sequential one
    np.testing.assert_array_equal(
        ours, matching.regular_mwpm_batch(spec, states, max_workers=1))


@pytest.mark.parametrize("d", [3, 5])
def test_class_sorted_and_enhanced_mwpm_equal_jax(d):
    spec, jspec = get_spec("planar", d), jax_get_spec("planar", d)
    states = _states(spec, 0.12, 16, seed=20 + d)
    states[0] = 0  # the empty syndrome's logical-only seeds
    ours = matching.class_sorted_mwpm_batch(spec, states, max_workers=4)
    np.testing.assert_array_equal(
        ours, jax_matching.class_sorted_mwpm_batch(jspec, states))
    np.testing.assert_array_equal(
        ours, matching.class_sorted_mwpm_batch(spec, states, max_workers=1))
    for b, s in enumerate(states):
        for eq in range(4):
            assert np_eq_class(spec, ours[b, eq]) == eq
            assert np.array_equal(np_syndrome(spec, ours[b, eq]),
                                  np_syndrome(spec, s))
        for model, kw in (("depolarizing", {}), ("uncorrelated", {}),
                          ("biased", dict(p_xyz=np.array([0.02, 0.01, 0.1])))):
            assert matching.enhanced_mwpm(spec, s, model, seed=b, **kw) == \
                jax_matching.enhanced_mwpm(jspec, s, model, seed=b, **kw)
