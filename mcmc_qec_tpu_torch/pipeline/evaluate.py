"""Evaluation: success/failure rates and golden-corpus replay.

The port's copy of ``mcmc_qec_tpu/pipeline/evaluate.py`` (numpy, on the
port's ``models``).

Covers plot_uncorrelated.py:11-197 (recompute true classes from stored
qubit matrices, score stored decoder distributions) and the
data/drl_failures_p_0.15.xz replay workflow (src/mcmc.py:118-141,
generate_data.py:314-321)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from ..models import get_spec, np_eq_class
from .config import RunConfig
from .dataset import Dataset, read_reference_dataset


@dataclasses.dataclass
class EvalResult:
    n_points: int
    n_failures: int
    success_rate: float
    per_class_counts: np.ndarray

    def __str__(self):
        return (
            f"{self.n_points} points, {self.n_failures} failures, "
            f"success {self.success_rate*100:.2f}%"
        )


def evaluate_dataset(ds: Dataset, decision: Optional[str] = None) -> EvalResult:
    """Score stored distributions against recomputed true classes
    (plot_uncorrelated.py:86-91).  The decision rule defaults to the stored
    method's convention: argmin for ST (generate_data.py:199-203), the
    middle/first block for concatenated multi-decoder rows, else argmax."""
    cfg = ds.config
    spec = get_spec(cfg.code, cfg.size) if cfg else None
    if np.all(ds.true_classes >= 0):
        trues = ds.true_classes
    else:
        trues = np_eq_class(spec, ds.qubit_matrices.reshape(len(ds), -1))
    distr = ds.distributions
    K = spec.n_classes if spec else distr.shape[-1]
    method = cfg.method if cfg else "argmax"
    if decision is None:
        decision = "argmin" if method == "ST" else "argmax"
    if method in ("all", "uncorrelated_comparison"):
        distr = distr[:, K : 2 * K]
    elif distr.shape[-1] > K:
        distr = distr[:, :K]
    if decision == "argmax":
        pred = np.argmax(distr, axis=-1)
    else:
        pred = np.argmin(distr, axis=-1)
    fails = int((pred != trues).sum())
    n = len(ds)
    per_class = np.bincount(trues, minlength=distr.shape[-1])
    return EvalResult(n, fails, 1.0 - fails / max(n, 1), per_class)


def load_golden_corpus(path: str, size: int = 5):
    """Load the reference's golden failure corpus (2603 hard d=5 toric
    syndromes at p=0.15 where a DRL decoder failed)."""
    qms, _ = read_reference_dataset(path)
    spec = get_spec("toric", size)
    flat = qms.reshape(len(qms), -1).astype(np.uint8)
    trues = np_eq_class(spec, flat)
    return spec, flat, trues


def replay_golden(
    path: str,
    decoder,
    limit: Optional[int] = None,
    batch: int = 64,
) -> EvalResult:
    """Decode the golden corpus with ``decoder(spec, states) -> (B, K)``
    distributions and report the success rate."""
    spec, flat, trues = load_golden_corpus(path)
    if limit:
        flat, trues = flat[:limit], trues[:limit]
    fails = 0
    preds = []
    for i in range(0, len(flat), batch):
        distr = decoder(spec, flat[i : i + batch])
        preds.append(np.argmax(distr, axis=-1))
    pred = np.concatenate(preds)
    fails = int((pred != trues).sum())
    per_class = np.bincount(trues, minlength=spec.n_classes)
    return EvalResult(len(flat), fails, 1.0 - fails / len(flat), per_class)


def evaluate_submethods(ds: Dataset) -> Dict[str, EvalResult]:
    """Per-sub-decoder evaluation for concatenated-distribution datasets
    (methods 'all' and 'uncorrelated_comparison'), the analog of
    plot_uncorrelated.py's success_rates_extensive (98-146)."""
    cfg = ds.config
    spec = get_spec(cfg.code, cfg.size)
    K = spec.n_classes
    trues = ds.true_classes
    if cfg.method == "all":
        blocks = {"ST": (0, "argmin"), "STDC": (1, "argmax"), "STRC": (2, "argmax")}
    elif cfg.method == "uncorrelated_comparison":
        blocks = {"MWPM": (0, "argmax"), "STDC": (1, "argmax")}
    elif cfg.method == "shortest_comparison":
        # the four per-block rates of plot_uncorrelated.py:149-197
        blocks = {
            "stdc_depol": (0, "argmax"),
            "stdc_depol_short": (1, "argmax"),
            "stdc_uncorr": (2, "argmax"),
            "stdc_uncorr_short": (3, "argmax"),
        }
    elif cfg.method == "PTEQ_with_shortest":
        # PT counting, shortest-chain Boltzmann, shortest-count
        # (decoders_biasednoise.py:163-172)
        blocks = {
            "PTEQ": (0, "argmax"),
            "shortest_boltzmann": (1, "argmax"),
            "shortest_count": (2, "argmax"),
        }
    else:
        return {cfg.method: evaluate_dataset(ds)}
    out = {}
    for name, (i, decision) in blocks.items():
        distr = ds.distributions[:, i * K : (i + 1) * K]
        pred = (np.argmin if decision == "argmin" else np.argmax)(distr, axis=-1)
        fails = int((pred != trues).sum())
        out[name] = EvalResult(
            len(ds), fails, 1.0 - fails / max(len(ds), 1),
            np.bincount(trues, minlength=K),
        )
    return out


def success_rate_curve(datasets: Sequence[Dataset]) -> Dict[float, float]:
    """p_error -> success rate over a sweep of datasets
    (plot_uncorrelated.py:200-267)."""
    out = {}
    for ds in datasets:
        res = evaluate_dataset(ds)
        out[ds.config.p_error] = res.success_rate
    return out
