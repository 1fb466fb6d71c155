"""The port's multi-device layer (``mcmc_qec_tpu_torch.parallel`` and
``graft_entry``) on the CPU, against the JAX package's
``mcmc_qec_tpu.parallel`` where the two compute the same thing:
``pad_to_multiple`` and ``host_shard`` equal to the JAX functions; the
mesh, ``shard_batch``, ``replicate`` and ``map_shards`` on a 4-entry CPU
mesh; STDC under ``map_shards`` equal shard by shard to direct calls under
``seed + i`` and near the exact posterior; the degenerate single-process
``distributed_generate``; the dry run; ``make_mesh`` refusing more cards
than exist."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax

import mcmc_qec_tpu.parallel.multihost as jax_multihost
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import np_to_class as jax_np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from mcmc_qec_tpu_torch import graft_entry
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import STDC
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.ops.ladder_window import KernelCounter, ladder_window_counts
from mcmc_qec_tpu_torch.ops.sweep import sweep_counts
from mcmc_qec_tpu_torch.parallel import (
    Mesh,
    allgather_rows,
    distributed_generate,
    global_sum,
    host_shard,
    make_mesh,
    map_shards,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from mcmc_qec_tpu_torch.parallel import multihost
from mcmc_qec_tpu_torch.pipeline import RunConfig, evaluate_dataset, generate

from reference_oracles import exact_class_posterior
from test_torch_ladder_window import one_torch_thread

STDC_KW = dict(p_sampling=0.3, droplets=4, steps=1500)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread per shard thread (see
    tests/test_torch_ladder_window.py::one_torch_thread)."""
    with one_torch_thread():
        yield


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


@pytest.mark.parametrize("shape,multiple", [((5, 3), 4), ((8, 2), 4),
                                            ((1, 7), 3), ((6,), 1),
                                            ((3, 2, 2), 8)])
def test_pad_to_multiple_equals_jax(shape, multiple):
    arr = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    ours, n = pad_to_multiple(arr, multiple)
    theirs, n_jax = jax_pad_to_multiple(arr, multiple)
    assert n == n_jax == shape[0]
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype and len(ours) % multiple == 0


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_host_shard_equals_jax(world, monkeypatch):
    """Every rank of worlds of 1-5 over batches of 0-12: the same slices as
    the JAX function (``jax.process_count``/``process_index`` patched in
    the JAX module only), and the shards tile the batch."""
    for n_total in range(13):
        covered = []
        for rank in range(world):
            monkeypatch.setattr(jax_multihost.jax, "process_count",
                                lambda: world)
            monkeypatch.setattr(jax_multihost.jax, "process_index",
                                lambda: rank)
            monkeypatch.setattr(multihost, "_world", lambda: world)
            monkeypatch.setattr(multihost, "_rank", lambda: rank)
            ours = host_shard(n_total)
            assert ours == jax_multihost.host_shard(n_total), (world, rank,
                                                              n_total)
            covered.extend(range(n_total)[ours])
        assert covered == list(range(n_total))


def test_mesh_shard_replicate_map_shards():
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.shape == {"data": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    arr = np.arange(24, dtype=np.int64).reshape(8, 3)
    shards = shard_batch(arr, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), arr)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(arr[:7], mesh)
    with pytest.raises(ValueError, match="axis"):
        shard_batch(arr, mesh, axis_name="model")
    rep = replicate(torch.tensor([1.0, 2.0]), mesh)
    assert len(rep) == 4
    rep[0][0] = 5.0  # copies, not views of one tensor
    assert all(r.tolist() == [1.0, 2.0] for r in rep[1:])

    seen = []
    lock = threading.Lock()

    def fn(shard, seed, r):
        with lock:
            seen.append((seed, threading.get_ident()))
        return shard * 10 + seed, (shard[:, :1] + r[1]).numpy()

    t, a = map_shards(fn, shards, 100, replicate(torch.tensor([0, 7]), mesh))
    expect = torch.cat([s * 10 + 100 + i for i, s in enumerate(shards)])
    assert torch.equal(t, expect)
    np.testing.assert_array_equal(a, arr[:, :1] + 7)
    assert sorted(s for s, _ in seen) == [100, 101, 102, 103]
    with pytest.raises(ValueError, match="one entry per shard"):
        map_shards(fn, shards, 0, rep[:2])


def test_map_shards_raises_a_shards_error():
    mesh = make_mesh(3, device="cpu")

    def fn(shard, seed):
        if seed == 1:
            raise RuntimeError("shard 1 failed")
        return shard

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        map_shards(fn, shard_batch(np.zeros((3, 2)), mesh), 0)


def test_kernel_counter_under_threads():
    """The counters the kernel wrappers add to from ``map_shards``'s
    threads lose no count: 16 threads (more than the cores) with a short
    switch interval."""
    counter = KernelCounter()
    n_threads, per = 16, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            (counter.add_launch(), counter.add_plain()) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.launches == counter.plain_calls == n_threads * per
    counter.reset()
    assert counter.launches == counter.plain_calls == 0


def _jax_states(n, p=0.12, seed=1):
    """Planar d=3 syndromes from the JAX sampler
    (tests/test_decoders.py:55-66)."""
    jspec = jax_get_spec("planar", 3)
    states = np.asarray(
        jax_sample_depolarizing(jax.random.PRNGKey(seed), jspec, p, (n,)))
    return jspec, spec_from_jax(jspec), states


def test_stdc_over_the_mesh_equals_direct_calls_per_shard():
    """Two shards of two syndromes, shard i under seed + i: equal bit for
    bit to a direct STDC call on that shard with that seed, and every
    syndrome near its exact posterior (TV < 0.05, same argmax)."""
    jspec, spec, states = _jax_states(4)
    mesh = make_mesh(2, device="cpu")
    seed = 9

    def decode(shard, s):
        return STDC(spec, shard, 0.12, seed=s, device=shard.device, **STDC_KW)

    sweep_counts.reset()
    got = map_shards(decode, shard_batch(states, mesh), seed)
    assert sweep_counts.plain_calls == 2 and sweep_counts.launches == 0
    assert got.shape == (4, spec.n_classes) and got.dtype == np.float32
    for i in range(2):
        direct = STDC(spec, states[2 * i:2 * i + 2], 0.12, seed=seed + i,
                      device="cpu", **STDC_KW)
        np.testing.assert_array_equal(got[2 * i:2 * i + 2], direct)
    for b in range(4):
        exact = exact_class_posterior(jspec, states[b],
                                      betas_depolarizing(0.12),
                                      jax_np_to_class)
        assert tv(exact, got[b] / 100.0) < 0.05, (exact, got[b])
        assert np.argmax(got[b]) == np.argmax(exact)


def test_one_device_mesh_equals_the_unsharded_call():
    _, spec, states = _jax_states(3)
    kw = dict(STDC_KW, steps=300)
    mesh = make_mesh(1, device="cpu")
    got = map_shards(lambda sh, s: STDC(spec, sh, 0.12, seed=s,
                                        device="cpu", **kw),
                     shard_batch(states, mesh), 4)
    np.testing.assert_array_equal(got, STDC(spec, states, 0.12, seed=4,
                                            device="cpu", **kw))


def test_multihost_degenerate_single_process(tmp_path):
    """A world of one (no process group): the shard is the whole batch,
    the gathers return their input and ``distributed_generate`` equals
    ``generate``."""
    assert host_shard(10) == slice(0, 10)
    assert np.array_equal(allgather_rows(np.arange(6).reshape(2, 3)),
                          np.arange(6).reshape(2, 3))
    assert global_sum(np.array([2, 3])).tolist() == [2, 3]
    cfg = RunConfig(code="planar", method="STDC", size=3, p_error=0.08,
                    p_sampling=0.25, droplets=2, steps=500, batch=4,
                    device="cpu")
    path = tmp_path / "mh.npz"
    ds = distributed_generate(str(path), cfg, 6, progress=None)
    ref = generate(None, cfg, 6, progress=None)
    assert len(ds) == 6 and path.exists()
    for f in ("qubit_matrices", "distributions", "true_classes"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(ref, f))
        assert getattr(ds, f).dtype == getattr(ref, f).dtype, f
    assert ds.config == cfg
    evaluate_dataset(ds)


def test_init_distributed_checks_its_arguments(monkeypatch):
    with pytest.raises(ValueError, match="platform"):
        multihost.init_distributed(platform="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_distributed("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_entry_one_ladder_step_on_the_cpu():
    fn, args = graft_entry.entry("cpu")
    state, flag, tops0, bottom_eq = fn(*args)
    assert state.shape == (8, 5, 50) and flag.shape == (8, 5)
    assert tops0.shape == (8,) and bottom_eq.shape == (8,)
    assert (flag[:, -1] == 1).all()


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    ladder_window_counts.reset()
    sweep_counts.reset()
    graft_entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip ok" in capsys.readouterr().out
    # the plain versions of both kernels ran once per shard
    assert ladder_window_counts.plain_calls == 4
    assert sweep_counts.plain_calls == 4
    assert ladder_window_counts.launches == sweep_counts.launches == 0


def test_make_mesh_counts_the_cards(monkeypatch):
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        make_mesh(2, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0),
                                   torch.device("cuda", 1))
    assert make_mesh(1).size == 1
    with pytest.raises(ValueError, match="3 devices asked for, 2 present"):
        make_mesh(3)
    with pytest.raises(ValueError, match="at least one device"):
        Mesh(())
