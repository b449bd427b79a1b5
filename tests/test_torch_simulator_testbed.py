"""Port engine against the JAX engine on the CPU: the testbed cluster.

The testbed half of test_torch_simulator.py, in a file of its own so
that the two halves run in parallel.  For every policy of FIG2 ∪ EVAL
∪ {E/LL/SRPT}, on the paper's testbed cluster (``BASE``) with and
without a cold-start penalty, at loads 0.3, 0.7 and 0.95 (one R=3
batch, N=300): ``worker``, ``cold`` and ``rejected`` are equal; the
float planes agree to rtol=atol=1e-6, the tolerance the JAX engine is
held to against its numpy oracle (tests/test_simulator.py).  The gap
actually seen is a few ulp: XLA on the CPU contracts ``a - b*c`` into a
fused multiply-add, torch does not.
"""
import numpy as np
import pytest

import repro.core as rc
from repro.core.simulator import simulate_many as jax_simulate_many

from repro_torch.core import (E_LL_SRPT, EVAL_POLICIES, FIG2_POLICIES,
                              PAPER_TESTBED, ms_trace)
from repro_torch.core.simulator import simulate_many

POLICIES = list(dict.fromkeys(FIG2_POLICIES + EVAL_POLICIES + (E_LL_SRPT,)))
LOADS = (0.3, 0.7, 0.95)
N = 300
TOL = dict(rtol=1e-6, atol=1e-6)
BASE = PAPER_TESTBED


def _jax_cluster(cluster):
    return rc.ClusterCfg(*cluster[:4])


def _compare(out, ref):
    for plane in ("worker", "cold", "rejected"):
        a, b = getattr(out, plane), getattr(ref, plane)
        assert a.dtype == b.dtype, plane
        np.testing.assert_array_equal(a, b, err_msg=plane)
    assert out.response.dtype == ref.response.dtype
    np.testing.assert_allclose(np.nan_to_num(out.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time", "prov_core_s"):
        a, b = getattr(out, plane), getattr(ref, plane)
        assert a.dtype == b.dtype, plane
        np.testing.assert_allclose(a, b, **TOL, err_msg=plane)


@pytest.mark.parametrize("penalty", [0.0, 0.5])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_matches_jax_engine(policy, penalty):
    cluster = BASE._replace(cold_start_penalty=penalty)
    wls = [ms_trace(cluster, load, N, seed=1) for load in LOADS]
    out = simulate_many(policy, cluster, wls, device="cpu")
    jcl = _jax_cluster(cluster)
    ref = jax_simulate_many(rc.parse_policy(policy.name), jcl,
                            [rc.ms_trace(jcl, load, N, seed=1)
                             for load in LOADS])
    _compare(out, ref)
