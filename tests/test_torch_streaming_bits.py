"""Chunked equals monolithic, bit for bit, within the port (on the CPU).

fig14's equivalence lane (``benchmarks/fig14_stream.py:72-94``) at its
shape (4 × 3 cores, capacity 2, N = 240, loads and seeds (0.6, 0) and
(1.0, 1)): for each of its fifteen stacks (the nine balancers; E/LL/PS
under each built-in keep-alive; E/LL/PS and E/SWARM/PS on a ``two-gen``
fleet; DD + HYBRID_HIST + ``two-gen`` + ``TARGET_P99``) the batched
engine's stream at chunk sizes 1, 7, 96, N and N + 5 ends in the
monolithic batched run's final state (:func:`final_states_equal`: the
slot matrices, warm pools, clocks, integrals and the balancer's, life,
telemetry and fleet state), with the monolithic run's per-arrival planes
and its exact post-warmup counters.  This file holds the balancer stacks;
``test_torch_streaming_kernel_ref.py`` the others.
"""
import numpy as np
import pytest

from repro_torch.core import (Binding, ClusterCfg, PolicySpec, WorkerSched,
                              stack_workloads, synth_workload)
from repro_torch.core.simulator import simulate_many
from repro_torch.core.streaming import (final_states_equal,
                                        monolithic_state, simulate_stream)
from repro_torch.policy import balancer_names
from repro_torch.telemetry import TelemetryCfg, warmup_cutoff

EQ = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
EQ_N = 240
EQ_LOADS = ((0.6, 0), (1.0, 1))
CHUNK_SIZES = (1, 7, 96, EQ_N, EQ_N + 5)
TEL = TelemetryCfg()


def _batch(cluster):
    return stack_workloads(synth_workload(cluster, load, EQ_N, n_functions=5,
                                          seed=seed)
                           for load, seed in EQ_LOADS)


def assert_chunked_is_monolithic(policy, cluster):
    wb = _batch(cluster)
    mono = monolithic_state(policy, cluster, wb, device="cpu", telemetry=TEL)
    plain = simulate_many(policy, cluster, wb, device="cpu", telemetry=TEL)
    resp = plain.response
    obs = ~np.isnan(resp) & (np.arange(EQ_N) >= warmup_cutoff(EQ_N, TEL))
    for k in CHUNK_SIZES:
        out = simulate_stream(policy, cluster, wb, chunk_size=k,
                              device="cpu", collect_outputs=True,
                              keep_final_state=True)
        ok, bad = final_states_equal(out.final_state, mono)
        assert ok, (k, bad)
        for f in ("cold", "rejected", "worker"):
            assert getattr(out, f).tobytes() == getattr(plain, f).tobytes(), \
                (k, f)
        assert out.n_chunks == -(-EQ_N // k)
        np.testing.assert_array_equal(out.n_done, (~np.isnan(resp)).sum(1))
        np.testing.assert_array_equal(out.n_observed, obs.sum(1))
        # the counters add in completion order, the plain sum in arrival
        # order: the same numbers, summed in another order
        np.testing.assert_allclose(
            out.resp_mean, np.where(obs, resp, 0.0).sum(1) / obs.sum(1),
            rtol=1e-12)
        assert out.telemetry.slow_hist.tobytes() == \
            plain.telemetry.slow_hist.tobytes()


@pytest.mark.parametrize("balancer", balancer_names())
def test_balancer_stack_chunked_is_monolithic(balancer):
    assert_chunked_is_monolithic(
        PolicySpec(Binding.EARLY, balancer, WorkerSched.PS), EQ)
