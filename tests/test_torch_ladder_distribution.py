"""The port's PT window with Philox draws against the JAX sweep-engine window,
in distribution, on the branches biased and alpha PTEQ run: the general
sweep with the Metropolis logical mix (biased ladder, eta=4) and the
general sweep with the exact mix and alpha weights (the ``even_odd``
exchange: tests/test_torch_ladder_even_odd.py).

Same pattern and bars as tests/test_torch_ladder_window.py's production
check (tests/test_pallas_ladder.py:98-102): on one replicated toric d=3
syndrome the class-occupation distribution, tops0 rate, late energy and
per-rung swap acceptance agree (the RNG streams differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.decoders.pteq import PTEQConfig as JaxPTEQConfig
from mcmc_qec_tpu.decoders.pteq import _get_window_fn as jax_window_fn
from mcmc_qec_tpu.mcmc.ladder import init_ladder as jax_init_ladder
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu_torch.convert import ladder_state_from_numpy, spec_from_jax
from mcmc_qec_tpu_torch.mcmc.ladder import (
    beta_ladder_alpha,
    beta_ladder_biased,
    beta_ladder_depolarizing,
)
from mcmc_qec_tpu_torch.ops.ladder_window import make_ladder_window

from test_torch_ladder_window import one_torch_thread

LADDERS = {
    # name: (betas of Nc=3 rungs, weights, top_exact, equal_betas, exchange)
    "biased": (beta_ladder_biased(0.15, 4.0, 3), (1.0, 1.0, 1.0), False, False,
               "sequential"),
    "alpha": (beta_ladder_alpha(0.15, 2.0, 3), (2.0, 2.0, 1.0), True, False,
              "sequential"),
    "even_odd": (beta_ladder_depolarizing(0.15, 3), (1.0, 1.0, 1.0), True, True,
                 "even_odd"),
}


def check_window_in_distribution(name, B):
    """The bars above for ladder ``name`` at ``B`` replicated chains: TV
    noise between two runs of one sampler is 0.03-0.045 at B=512 on this
    syndrome, so a ladder whose first comparison lands near the 0.05 bar
    runs at a larger B."""
    with one_torch_thread():
        _check_window_in_distribution(name, B)


def _check_window_in_distribution(name, B):
    ladder, weights, top_exact, equal_betas, exchange = LADDERS[name]
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    Nc, W, iters = 3, 400, 4
    K = jspec.n_classes
    rng = np.random.RandomState(3)
    one = np.where(rng.uniform(size=jspec.nq) < 0.15,
                   rng.randint(1, 4, size=jspec.nq), 0).astype(np.uint8)
    states = np.tile(one, (B, 1))
    betas = ladder.astype(np.float32)
    w = np.asarray(weights, np.float32)

    cfg = JaxPTEQConfig(engine="sweep", window=W, iters=iters, tops_burn=2,
                        energy_chunk=4, exchange=exchange)
    wfn = jax_window_fn(jspec, Nc, cfg, top_exact_accept=top_exact,
                        equal_betas=equal_betas)
    out = wfn(jax_init_ladder(jspec, jnp.asarray(states), Nc),
              jax.random.PRNGKey(4), jnp.asarray(betas),
              jnp.zeros((B, K), jnp.int32), jnp.zeros((B,), jnp.int32),
              jnp.asarray(w))
    ls2, eq2, sb2, en2 = out[0], out[1], out[2], np.asarray(out[3])
    d_xla = np.asarray(eq2.sum(0)) / max(int(sb2.sum()), 1)
    tops_xla = float(ls2.tops0.mean())
    en_xla = float(en2[en2.shape[0] // 2 :].mean())
    sw_xla = np.asarray(out[7]).sum(0) / (B * W)

    fn = make_ladder_window(spec, Nc, W, iters, 0.5, 2, 4, top_exact=top_exact,
                            equal_betas=equal_betas, exchange=exchange)
    flag = np.zeros((B, Nc), np.int32)
    flag[:, -1] = 1
    ls = ladder_state_from_numpy(np.repeat(states[:, None], Nc, 1), flag,
                                 np.zeros(B, np.int32), "cpu")
    st, fl, tp, eq, sb, en, ba, bf, sw = fn(
        ls.state, ls.flag, ls.tops0, torch.zeros((B, K), dtype=torch.int32),
        torch.zeros((B,), dtype=torch.int32), 11, betas, w,
    )
    d_port = eq.sum(0).numpy() / max(int(sb.sum()), 1)
    tops_port = float(tp.float().mean())
    en_port = float(en[en.shape[0] // 2 :].mean())
    sw_port = sw.numpy().sum(0) / (B * W)

    tv = 0.5 * np.abs(d_port - d_xla).sum()
    assert tv < 0.05, f"class distributions diverge, TV {tv:.3f}"
    assert abs(tops_port - tops_xla) / max(tops_xla, 1e-9) < 0.5
    assert abs(en_port - en_xla) < 1.0
    assert np.abs(sw_port - sw_xla).max() < 0.05, (sw_port, sw_xla)


@pytest.mark.parametrize("name", ["biased", "alpha"])
def test_philox_window_matches_jax_sweep_window_in_distribution(name):
    check_window_in_distribution(name, B=512)
