"""Port engine under overload on a tiny cluster, where rejections,
warm-pool evictions and the late-binding controller queue all occur:
equal to the JAX engine (integer planes equal, floats to 1e-6 as in
test_torch_simulator.py), ``simulate_many`` ≡ R × ``simulate`` bit for
bit (the tests/test_batch_sim.py contract), and the Hermes kernel
backend equal to the plain one."""
import numpy as np
import pytest

import repro.core as rc
from repro.core.simulator import simulate_many as jax_simulate_many

from repro_torch.core import (E_LL_SRPT, E_LOC_FCFS, E_R_FCFS, HERMES,
                              LATE_BINDING, PAPER_TESTBED, ClusterCfg,
                              ms_trace, synth_workload)
from repro_torch.core.simulator import LoopStats, simulate, simulate_many

# one policy per overload mechanism: the controller queue (late binding),
# ring-probe and random rejections (LOC, R), the kernel's -1 (Hermes) and
# rank ties among waiting tasks (SRPT); together they cover every ported
# balancer and scheduler
POLICIES = (LATE_BINDING, E_LOC_FCFS, E_R_FCFS, HERMES, E_LL_SRPT)
N = 300
TOL = dict(rtol=1e-6, atol=1e-6)
TINY = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                  cold_start_penalty=0.25)


def _jax_cluster(cluster):
    return rc.ClusterCfg(*cluster[:4])


def _tiny_wls(cluster, synth):
    return [synth(cluster, load, N, n_functions=5, hot_fraction=0.8,
                  seed=seed) for load, seed in ((0.4, 0), (0.9, 1),
                                                (1.3, 2))]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_overload_matches_jax_and_single_runs(policy):
    wls = _tiny_wls(TINY, synth_workload)
    stats = LoopStats()
    out = simulate_many(policy, TINY, wls, device="cpu", stats=stats)
    ref = jax_simulate_many(rc.parse_policy(policy.name), _jax_cluster(TINY),
                            _tiny_wls(_jax_cluster(TINY), rc.synth_workload))
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(getattr(out, plane),
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(out.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time"):
        np.testing.assert_allclose(getattr(out, plane), getattr(ref, plane),
                                   **TOL, err_msg=plane)
    assert stats.arrivals == N and stats.advance_iters > N
    if policy.binding == "L":
        assert stats.pop_iters > 0        # the controller queue was used
    for r, wl in enumerate(wls):
        single = simulate(policy, TINY, wl, device="cpu")
        np.testing.assert_array_equal(
            np.nan_to_num(out.response[r], nan=-1.0),
            np.nan_to_num(single.response, nan=-1.0))
        for plane in ("cold", "rejected", "worker"):
            np.testing.assert_array_equal(getattr(out, plane)[r],
                                          getattr(single, plane))
        assert (out.server_time[r], out.core_time[r], out.end_time[r]) == \
            (single.server_time, single.core_time, single.end_time)


def test_kernel_and_plain_backends_agree_on_cpu():
    wls = [ms_trace(PAPER_TESTBED, load, N, seed=2)
           for load in (0.3, 0.7, 0.95)]
    a = simulate_many(HERMES, PAPER_TESTBED, wls, device="cpu",
                      backend="kernel")
    b = simulate_many(HERMES, PAPER_TESTBED, wls, device="cpu",
                      backend="torch")
    for plane in ("response", "cold", "rejected", "worker", "end_time"):
        np.testing.assert_array_equal(getattr(a, plane), getattr(b, plane))
