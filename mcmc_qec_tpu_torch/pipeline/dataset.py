"""Dataset storage: npz-backed writer/reader plus compatibility with the
reference's pickled-pandas ``.xz`` format.

The port's copy of ``mcmc_qec_tpu/pipeline/dataset.py`` (numpy; pandas
only inside the reference-format bridges): the same ``.npz`` layout
(``qubit_matrices``, ``distributions``, ``true_classes``, ``config`` JSON),
so a dataset written by either package loads in the other.

The reference stores a MultiIndex (data_nr, type) DataFrame where type 0 is
the qubit matrix and type 1 the class distribution, re-pickled wholesale
every 50 points (generate_data.py:231-256).  Here the native format is a
single compressed ``.npz`` with parallel arrays — O(1) append-free
checkpointing and zero-copy reads — and ``read_reference_dataset`` /
``to_reference_dataframe`` bridge both directions, including the golden
``data/drl_failures_p_0.15.xz`` corpus (src/mcmc.py:118-141 MCMCDataReader).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .config import RunConfig


@dataclasses.dataclass
class Dataset:
    """Decoded-syndrome dataset: states plus per-class distributions."""

    qubit_matrices: np.ndarray  # (N, ...) uint8
    distributions: np.ndarray  # (N, n_classes) float32
    true_classes: np.ndarray  # (N,) int32 (-1 if unknown)
    config: Optional[RunConfig] = None

    def __len__(self) -> int:
        return len(self.qubit_matrices)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        np.savez_compressed(
            tmp,
            qubit_matrices=self.qubit_matrices,
            distributions=self.distributions,
            true_classes=self.true_classes,
            config=np.frombuffer(
                (self.config.to_json() if self.config else "{}").encode(),
                dtype=np.uint8,
            ),
        )
        os.replace(tmp + ".npz", path)

    @classmethod
    def load(cls, path: str) -> "Dataset":
        with np.load(path) as z:
            cfg_raw = bytes(z["config"]).decode() if "config" in z else "{}"
            cfg = RunConfig.from_dict(json.loads(cfg_raw)) if cfg_raw != "{}" else None
            return cls(
                qubit_matrices=z["qubit_matrices"],
                distributions=z["distributions"],
                true_classes=z["true_classes"],
                config=cfg,
            )

    def iter_points(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self.qubit_matrices[i], self.distributions[i]


def concat_datasets(datasets) -> Dataset:
    """Merge datasets, re-indexing data points (concat_data.py:8-75)."""
    datasets = list(datasets)
    return Dataset(
        qubit_matrices=np.concatenate([d.qubit_matrices for d in datasets]),
        distributions=np.concatenate([d.distributions for d in datasets]),
        true_classes=np.concatenate([d.true_classes for d in datasets]),
        config=datasets[0].config,
    )


# ---------------------------------------------------------------------------
# Reference-format bridges (pandas pickled .xz)
# ---------------------------------------------------------------------------


def read_reference_dataset(path: str):
    """Read a reference-format pickled DataFrame.

    Handles both layouts observed in the reference tree:
    - MCMC datasets: MultiIndex (data_nr, type) rows of 'data' cells
      (generate_data.py:231-246)
    - the golden failure corpus data/drl_failures_p_0.15.xz with columns
      ['qubit_matrix', 'drl_correction_chain'].
    Returns (qubit_matrices, extra) where extra is the distribution list or
    correction chains (may be None entries for param rows).
    """
    import pandas as pd

    df = pd.read_pickle(path)
    if "qubit_matrix" in getattr(df, "columns", []):
        qms = np.stack([np.asarray(x) for x in df["qubit_matrix"]])
        extra = None
        if "drl_correction_chain" in df.columns:
            extra = np.stack([np.asarray(x) for x in df["drl_correction_chain"]])
        return qms, extra
    # MultiIndex (data_nr, type) layout
    qms, distrs = [], []
    data_nrs = sorted({i for i, _ in df.index if i >= 0})
    for nr in data_nrs:
        qms.append(np.asarray(df.loc[(nr, 0), "data"]))
        try:
            distrs.append(np.asarray(df.loc[(nr, 1), "data"]))
        except KeyError:
            distrs.append(None)
    return np.stack(qms), distrs


class MCMCDataReader:
    """Sequential reader API matching the reference's MCMCDataReader
    (src/mcmc.py:118-141): iterate (qubit_matrix, distribution) pairs from
    either a native .npz Dataset or a reference-format pickled DataFrame."""

    def __init__(self, file_path: str, size: Optional[int] = None):
        self._file_path = file_path
        self._size = size
        if file_path.endswith(".npz"):
            ds = Dataset.load(file_path)
            self._qms = ds.qubit_matrices
            self._extras = ds.distributions
        else:
            self._qms, self._extras = read_reference_dataset(file_path)
        self._capacity = len(self._qms)
        self._index = 0

    def full(self) -> np.ndarray:
        out = []
        for i in range(self._capacity):
            out.append(np.asarray(self._qms[i]).ravel())
            if self._extras is not None:
                out.append(np.asarray(self._extras[i]).ravel())
        return np.concatenate(out) if out else np.zeros(0)

    def next(self):
        qm = self._qms[self._index]
        extra = self._extras[self._index] if self._extras is not None else None
        self._index += 1
        return qm, extra

    def has_next(self) -> bool:
        return self._index < self._capacity

    def current_index(self) -> int:
        return self._index

    def get_capacity(self) -> int:
        return self._capacity


def to_reference_dataframe(ds: Dataset, params: Optional[dict] = None):
    """Write a Dataset as the reference's MultiIndex DataFrame layout so
    downstream reference tooling can read our outputs."""
    import pandas as pd

    frames = []
    names = ["data_nr", "type"]
    if params is not None:
        idx = pd.MultiIndex.from_product([[-1], [0]], names=names)
        frames.append(pd.DataFrame([[params]], index=idx, columns=["data"]))
    for i in range(len(ds)):
        idx_q = pd.MultiIndex.from_product([[i], [0]], names=names)
        idx_d = pd.MultiIndex.from_product([[i], [1]], names=names)
        frames.append(
            pd.DataFrame([[ds.qubit_matrices[i]]], index=idx_q, columns=["data"])
        )
        frames.append(
            pd.DataFrame([[ds.distributions[i]]], index=idx_d, columns=["data"])
        )
    return pd.concat(frames)
