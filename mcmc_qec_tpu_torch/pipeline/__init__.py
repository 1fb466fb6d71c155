"""The batch pipeline of the port: run configuration, datasets, evaluation,
generation and plotting (``python -m mcmc_qec_tpu_torch generate``)."""

from .config import RunConfig
from .dataset import Dataset, MCMCDataReader, concat_datasets, read_reference_dataset, to_reference_dataframe
from .evaluate import EvalResult, evaluate_dataset, evaluate_submethods, load_golden_corpus, replay_golden, success_rate_curve
from .generate import decode_batch, generate, sample_errors
