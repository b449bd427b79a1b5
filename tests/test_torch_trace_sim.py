"""Trace replay through the port's engines on the CPU.

* The mixed batch (all five ``azure-*`` scenarios at load 0.7, seed 1,
  widened to F = 60 by ``resample_workloads``; N = 300) on the paper's
  testbed with cold-start penalty 0.5: the port's ``simulate_many`` on
  the CPU against JAX's for E/H/PS, E/LL/PS, E/LOC/PS and L/LL/FCFS,
  integer planes equal and floats within rtol=atol=1e-6 (as
  tests/test_torch_simulator.py); the fused kernel's plain version
  (``sim_engine_ref``) bit-equal to the batched engine on it.
* fig14's horizon-lane cluster (1000 workers × 2 cores, capacity factor
  2: 4 slots) under ``azure-diurnal``: ``sim_engine_ref`` bit-equal to
  the batched engine at N = 200.
"""
import functools

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.simulator import simulate_many as jax_simulate_many
from repro.trace.replay import resample_workloads as ref_resample

from repro_torch.core import (E_LL_PS, E_LOC_PS, HERMES, LATE_BINDING,
                              PAPER_TESTBED, WORKLOADS, ClusterCfg,
                              replicate_workload)
from repro_torch.core.simulator import simulate_many
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.trace import resample_workloads

AZURE = ("azure-diurnal", "azure-bursty", "azure-cold-heavy",
         "azure-flash-crowd", "azure-fixture")
FUSED = (HERMES, E_LL_PS, E_LOC_PS)
N = 300
TESTBED = PAPER_TESTBED._replace(cold_start_penalty=0.5)
#: fig14's horizon lane: W = 1000, 2 cores, S = 4
HORIZON = ClusterCfg(n_workers=1000, cores=2, capacity_factor=2)
TOL = dict(rtol=1e-6, atol=1e-6)
PLANES = dict(response="resp", cold="cold", rejected="rejected",
              worker="worker_of", server_time="server_time",
              core_time="core_time", end_time="now")


def _mixed():
    return resample_workloads(WORKLOADS[name](TESTBED, 0.7, N, 1)
                              for name in AZURE)


@functools.cache
def _port(policy):
    return simulate_many(policy, TESTBED, _mixed(), device="cpu",
                         backend="torch")


def _inputs(wb):
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


def _assert_bit_equal(planes, out):
    for plane, key in PLANES.items():
        want = getattr(out, plane)
        got = planes[key].numpy()
        assert got.dtype == want.dtype, plane
        np.testing.assert_array_equal(got, want, err_msg=plane)


@pytest.mark.parametrize("policy", (*FUSED, LATE_BINDING),
                         ids=lambda p: p.name)
def test_mixed_trace_batch_matches_jax(policy):
    jcl = rc.ClusterCfg(*TESTBED[:4])
    jwb = ref_resample(rc.WORKLOADS[name](jcl, 0.7, N, 1) for name in AZURE)
    wb = _mixed()
    for f in ("arrival", "func", "service", "u_lb", "func_home"):
        np.testing.assert_array_equal(getattr(wb, f), getattr(jwb, f))
    assert wb.n_functions == jwb.n_functions == 60
    ref = jax_simulate_many(rc.parse_policy(policy.name), jcl, jwb)
    out = _port(policy)
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(getattr(out, plane),
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(out.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time"):
        np.testing.assert_allclose(getattr(out, plane), getattr(ref, plane),
                                   **TOL, err_msg=plane)
    assert out.cold.any()


@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_mixed_trace_batch_plain_fused_engine(policy):
    planes = sim_engine_ref(policy.balance, TESTBED, *_inputs(_mixed()))
    _assert_bit_equal(planes, _port(policy))


@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_horizon_lane_cluster_plain_fused_engine(policy):
    wb = replicate_workload(WORKLOADS["azure-diurnal"], HORIZON, (0.9, 0.97),
                            200, seeds=(1,))
    planes = sim_engine_ref(policy.balance, HORIZON, *_inputs(wb))
    out = simulate_many(policy, HORIZON, wb, device="cpu", backend="torch")
    _assert_bit_equal(planes, out)
    # the burst spreads over hundreds of the 1000 workers
    assert len(np.unique(out.worker)) > 50
