"""The port's ``even_odd`` replica exchange with Philox draws against the JAX
sweep-engine window, in distribution (the pattern and bars of
tests/test_torch_ladder_distribution.py), at 1024 replicated chains: at
512 the two samplers' estimates differ by about the run-to-run noise of
either, close to the 0.05 TV bar.
"""

from test_torch_ladder_distribution import check_window_in_distribution


def test_even_odd_window_matches_jax_sweep_window_in_distribution():
    check_window_in_distribution("even_odd", B=1024)
