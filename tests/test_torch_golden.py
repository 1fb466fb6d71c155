"""The reference-format readers and the golden-corpus studies of the port
(``pipeline/dataset.py``, ``pipeline/evaluate.py``,
``studies/golden_replay.py``, ``studies/golden_ceiling.py``) on the CPU,
against the JAX package.

The golden corpus itself (drl_failures_p_0.15.xz) is not in the
repository, so each test writes a 7-row corpus in its layout: a pickled
DataFrame with columns ``qubit_matrix`` and ``drl_correction_chain``, each
a (2, 5, 5) uint8 toric d=5 state, xz-compressed by its extension.

(a) Both packages read it the same, bit for bit: ``load_golden_corpus``,
    ``read_reference_dataset``'s golden layout, ``MCMCDataReader``,
    ``replay_golden`` with a decoder of fixed distributions, and
    ``to_reference_dataframe`` of one dataset.
(b) Both studies' ``main`` run on the CPU at tiny caps; the ceiling's
    MWPM row equals the JAX ``regular_mwpm_batch``'s; the studies import
    no pandas until they read a corpus.
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import mcmc_qec_tpu.pipeline as jp
from mcmc_qec_tpu.matching.graph import regular_mwpm_batch as jax_regular_mwpm
import mcmc_qec_tpu_torch.pipeline as tp
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.studies import golden_ceiling, golden_replay

N_ROWS = 7


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    """A 7-row corpus in the golden layout: depolarizing toric d=5 states
    at p=0.15 and arbitrary correction chains."""
    spec = get_spec("toric", 5)
    rng = np.random.RandomState(2603)
    qm = (rng.randint(1, 4, (N_ROWS, spec.nq)) * (rng.rand(N_ROWS, spec.nq) < 0.15)
          ).astype(np.uint8).reshape(N_ROWS, *spec.state_shape)
    chains = rng.randint(0, 4, qm.shape).astype(np.uint8)
    df = pd.DataFrame({"qubit_matrix": list(qm),
                       "drl_correction_chain": list(chains)})
    path = str(tmp_path / "x.xz")
    pd.to_pickle(df, path)
    return path, qm, chains


def test_corpus_reads_the_same_in_both_packages(corpus):
    path, qm, chains = corpus
    assert qm.shape[1:] == (2, 5, 5)
    spec, flat, trues = tp.load_golden_corpus(path)
    jspec, jflat, jtrues = jp.load_golden_corpus(path)
    assert (spec.family, spec.size) == (jspec.family, jspec.size) == ("toric", 5)
    assert flat.dtype == jflat.dtype == np.uint8
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(flat, qm.reshape(N_ROWS, -1))
    np.testing.assert_array_equal(trues, jtrues)

    q, extra = tp.read_reference_dataset(path)
    jq, jextra = jp.read_reference_dataset(path)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(q, qm)
    np.testing.assert_array_equal(extra, jextra)
    np.testing.assert_array_equal(extra, chains)

    ours, theirs = tp.MCMCDataReader(path), jp.MCMCDataReader(path)
    assert ours.get_capacity() == theirs.get_capacity() == N_ROWS
    np.testing.assert_array_equal(ours.full(), theirs.full())
    while theirs.has_next():
        assert ours.has_next()
        (a, b), (ja, jb) = ours.next(), theirs.next()
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        assert ours.current_index() == theirs.current_index()
    assert not ours.has_next()


@pytest.mark.parametrize("limit,batch", [(None, 64), (5, 2)])
def test_replay_golden_with_fixed_distributions(corpus, limit, batch):
    """A decoder whose distribution depends only on the state's content:
    both packages' replays batch it the same way and score it the same."""
    path = corpus[0]

    def decoder(spec, states):
        s = np.asarray(states).astype(np.int64).sum(-1)
        out = np.full((len(s), spec.n_classes), 5.0)
        out[np.arange(len(s)), s % spec.n_classes] = 80.0
        return out

    ours = tp.replay_golden(path, decoder, limit=limit, batch=batch)
    theirs = jp.replay_golden(path, decoder, limit=limit, batch=batch)
    assert ours.n_points == theirs.n_points == (limit or N_ROWS)
    assert ours.n_failures == theirs.n_failures
    assert ours.success_rate == theirs.success_rate
    np.testing.assert_array_equal(ours.per_class_counts, theirs.per_class_counts)


def test_to_reference_dataframe_equals_the_jax_one(corpus):
    _, qm, _ = corpus
    rng = np.random.RandomState(5)
    dist = rng.rand(N_ROWS, 4).astype(np.float32)
    truth = rng.randint(0, 4, N_ROWS).astype(np.int32)
    params = {"code": "toric", "size": 5, "p_error": 0.15}
    ours = tp.to_reference_dataframe(tp.Dataset(qm, dist, truth), params)
    theirs = jp.to_reference_dataframe(jp.Dataset(qm, dist, truth), params)
    assert list(ours.index) == list(theirs.index)
    assert list(ours.columns) == list(theirs.columns) == ["data"]
    assert ours.iloc[0, 0] == theirs.iloc[0, 0] == params
    for a, b in zip(ours["data"].iloc[1:], theirs["data"].iloc[1:]):
        np.testing.assert_array_equal(a, b)
    # and it reads back through the other layout of read_reference_dataset
    path = Path(corpus[0]).with_name("ds.xz")
    ours.to_pickle(path)
    q, distrs = tp.read_reference_dataset(str(path))
    jq, jdistrs = jp.read_reference_dataset(str(path))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(q, qm)
    np.testing.assert_array_equal(np.stack(distrs), np.stack(jdistrs))


def _main_output(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue()


@pytest.mark.parametrize("decoder,engine", [("PTEQ", "fused"),
                                            ("STDC", "auto")])
def test_golden_replay_main_on_the_cpu(corpus, decoder, engine):
    path = corpus[0]
    (ok, n), out = _main_output(golden_replay.main, [
        "--corpus", path, "--device", "cpu", "--decoder", decoder,
        "--engine", engine, "--limit", "6", "--steps", "1200",
        "--droplets", "2"])
    assert n == 6 and 0 <= ok <= n
    lines = out.strip().splitlines()
    if decoder == "PTEQ":
        assert re.fullmatch(r"converged: \d+/6", lines[0])
    assert re.fullmatch(
        rf"{decoder}: recovered {ok}/6 \(\d+\.\d%\) of the DRL failure set "
        r"in \d+\.\ds", lines[-1])


def test_golden_ceiling_main_on_the_cpu(corpus):
    path = corpus[0]
    got, out = _main_output(golden_ceiling.main, [
        "--corpus", path, "--device", "cpu", "--cap", "400", "--window",
        "200", "--limit", "6"])
    jspec, jflat, jtrues = jp.load_golden_corpus(path)
    theirs = np.asarray(jax_regular_mwpm(jspec, jflat[:6]))
    np.testing.assert_array_equal(got["mwpm"], theirs)
    lines = out.strip().splitlines()
    assert lines[0] == "6 syndromes, toric d=5"
    assert lines[1].startswith(
        f"MWPM : {100 * np.mean(theirs == jtrues[:6]):.2f}% in ")
    assert lines[2].startswith("eMWPM: n/a")
    res = got["pteq"]
    assert res.distribution.shape == (6, jspec.n_classes)
    assert res.window == "fused"
    assert re.match(r"PTEQ cap=400 engine=auto: recovered \d+/6 ", lines[3])
    # --skip-mwpm leaves the MWPM rows out
    got, out = _main_output(golden_ceiling.main, [
        "--corpus", path, "--device", "cpu", "--cap", "200", "--window",
        "200", "--limit", "3", "--skip-mwpm"])
    assert got["mwpm"] is None
    assert not any(ln.startswith(("MWPM", "eMWPM")) for ln in out.splitlines())


def test_golden_studies_need_a_corpus_and_import_no_pandas():
    """``--corpus`` is required (the reference's default path is not in the
    repository), and the studies import pandas only to read a corpus, so
    ``run`` works on a host without it."""
    for main in (golden_replay.main, golden_ceiling.main):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
            main(["--device", "cpu"])
    code = ("import sys, mcmc_qec_tpu_torch.studies.golden_replay, "
            "mcmc_qec_tpu_torch.studies.golden_ceiling;"
            "print('pandas' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
