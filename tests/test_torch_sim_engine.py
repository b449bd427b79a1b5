"""The fused early-binding engine (``sim_engine``: E/<B>/PS for the nine
balancers in one launch) on the CPU.

* Its plain version ``sim_engine_ref`` (the kernel's control flow in
  plain torch) equals the port's batched engine (``backend="torch"``) bit
  for bit in every plane, and the JAX engine with integer planes equal and
  floats within rtol=atol=1e-6 (as tests/test_torch_simulator.py), for
  every fused policy on the paper's small and testbed clusters at loads
  0.3/0.7/0.95 with cold-start penalty 0 and 0.5, on an overloaded
  4 × 3-core cluster (rejections and warm-pool evictions) and with R = 1;
  N = 300.
* The same for the policy zoo (E/{JSQ2,RR,HIKU,DD,SWARM}/PS) against the
  batched engine, in every plane and in the final balancer state, on the
  small cluster, the overloaded one (where a rejected arrival must leave
  HIKU's and DD's state as it was) and the paper's large cluster (W =
  100); the zoo against JAX is ``tests/test_torch_policy_zoo.py``'s.
* The routing table: which policies run in the kernel on CUDA; the CPU
  launches nothing.
* The wrapper's named errors.

The last test holds the CUDA kernel against the batched engine and runs
only where a card is present, so the same file also runs on the card's
machine: ``python -m pytest tests/test_torch_sim_engine.py``.  Where JAX
is not installed, the reference-side tests skip.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import NotPortedError
from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_LL_FCFS,
                              E_LL_PS, E_LL_SRPT, E_LOC_PS, E_R_PS, E_RR_PS,
                              E_SWARM_PS, HERMES, LATE_BINDING, PAPER_LARGE,
                              PAPER_SMALL, PAPER_TESTBED, ClusterCfg,
                              stack_workloads)
from repro_torch.core import ms_trace, synth_workload
from repro_torch.core.simulator import (LoopStats, _build_engine,
                                        simulate_many)
from repro_torch.kernels.flash_attention.kernel import UnsupportedShapeError
from repro_torch.kernels.hermes_select import kernel as hermes_kernel
from repro_torch.kernels.sim_engine import kernel, ops
from repro_torch.kernels.sim_engine.ref import (BALANCER_CODES,
                                                balancer_name,
                                                sim_engine_ref)
from repro_torch.policy import ENGINES, engine

try:
    import repro.core as rc
    from repro.core.simulator import simulate_many as jax_simulate_many
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

FUSED = (HERMES, E_LL_PS, E_LOC_PS, E_R_PS)
ZOO = (E_JSQ2_PS, E_RR_PS, E_HIKU_PS, E_DD_PS, E_SWARM_PS)
N = 300
LOADS = (0.3, 0.7, 0.95)
TOL = dict(rtol=1e-6, atol=1e-6)
TINY = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                  cold_start_penalty=0.25)
#: case id -> (cluster, loads, workload generator name, its keywords)
CASES = {
    **{f"{name}-pen{pen}": (base._replace(cold_start_penalty=pen), LOADS,
                            "ms_trace", {})
       for name, base in (("small", PAPER_SMALL), ("testbed", PAPER_TESTBED))
       for pen in (0.0, 0.5)},
    "overload": (TINY, (1.3, 3.0, 6.0), "synth_workload",
                 dict(n_functions=5, hot_fraction=0.8)),
    "small-R1": (PAPER_SMALL._replace(cold_start_penalty=0.5), (0.95,),
                 "ms_trace", {}),
}
#: the zoo's cases: two of the above and the paper's large cluster
#: (W = 100; N = 150 there)
ZOO_CASES = {"small-pen0.5": CASES["small-pen0.5"],
             "overload": CASES["overload"],
             "large": (PAPER_LARGE._replace(cold_start_penalty=0.5),
                       (0.7, 0.97), "ms_trace", {})}
PLANES = dict(response="resp", cold="cold", rejected="rejected",
              worker="worker_of", server_time="server_time",
              core_time="core_time", end_time="now")


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _workloads(case):
    cluster, loads, gen, kw = {**CASES, **ZOO_CASES}[case]
    make = {"ms_trace": ms_trace, "synth_workload": synth_workload}[gen]
    n = 150 if case == "large" else N
    return cluster, stack_workloads(make(cluster, load, n, seed=1, **kw)
                                    for load in loads)


def _inputs(wb, device="cpu"):
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


@functools.cache
def _plain(policy, case):
    """(sim_engine_ref's planes as numpy, the batched engine's output)."""
    cluster, wb = _workloads(case)
    ref = sim_engine_ref(policy.balance, cluster, *_inputs(wb))
    batched = simulate_many(policy, cluster, wb, device="cpu",
                            backend="torch")
    return {k: v.numpy() for k, v in ref.items()}, batched


def _assert_bit_equal(planes, out):
    for plane, key in PLANES.items():
        want = getattr(out, plane)
        assert planes[key].dtype == want.dtype, plane
        np.testing.assert_array_equal(planes[key], want, err_msg=plane)


@pytest.mark.parametrize("case", ZOO_CASES)
@pytest.mark.parametrize("policy", ZOO, ids=lambda p: p.name)
def test_zoo_plain_version_matches_batched_engine(policy, case):
    cluster, wb = _workloads(case)
    ref = sim_engine_ref(policy.balance, cluster, *_inputs(wb))
    # the batched engine's own state dict: its final balancer state too
    run = _build_engine(policy, cluster, wb.n, wb.n_functions, wb.n_reps,
                        torch.device("cpu"), "torch")
    a, f, s, u, h = _inputs(wb)
    st = run(a, f.long(), s, u, h, LoopStats())
    for key in PLANES.values():
        want = st[key][:, :wb.n] if st[key].dim() == 2 else st[key]
        assert ref[key].dtype == want.dtype, key
        np.testing.assert_array_equal(ref[key].numpy(), want.numpy(),
                                      err_msg=key)
    lb = sorted(k for k in ref if k.startswith("lb_"))
    assert lb == sorted(k for k in st if k.startswith("lb_"))
    assert bool(lb) == (policy in (E_HIKU_PS, E_DD_PS, E_SWARM_PS))
    for key in lb:
        assert ref[key].dtype == st[key].dtype, key
        assert ref[key].numpy().tobytes() == st[key].numpy().tobytes(), key
    assert (ref["iters"] >= wb.n).all()
    if case == "overload":
        assert ref["rejected"].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_plain_version_matches_batched_engine(policy, case):
    planes, batched = _plain(policy, case)
    _assert_bit_equal(planes, batched)
    # every arrival advanced at least once, and the drain ran
    assert (planes["iters"] >= N).all()
    if case == "overload":
        assert planes["rejected"].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_plain_version_matches_jax_engine(reference, policy, case):
    planes, _ = _plain(policy, case)
    cluster, loads, gen, kw = CASES[case]
    jcl = rc.ClusterCfg(*cluster[:4])
    make = {"ms_trace": rc.ms_trace, "synth_workload": rc.synth_workload}[gen]
    ref = jax_simulate_many(rc.parse_policy(policy.name), jcl,
                            [make(jcl, load, N, seed=1, **kw)
                             for load in loads])
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(planes[PLANES[plane]],
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(planes["resp"], nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time"):
        np.testing.assert_allclose(planes[PLANES[plane]],
                                   getattr(ref, plane), **TOL,
                                   err_msg=plane)


ROUTES = [(p, "cuda", b, "sim_engine") for p in (*FUSED, *ZOO)
          for b in ("auto", "kernel")] + \
    [(p, "cuda", "torch", "batched") for p in (*FUSED, *ZOO)] + \
    [(p, "cpu", b, "batched") for p in (*FUSED, *ZOO)
     for b in ("auto", "kernel", "torch")] + \
    [(p, "cuda", b, "batched")
     for p in (E_LL_FCFS, E_LL_SRPT, HERMES._replace(sched="FCFS"),
               HERMES._replace(sched="SRPT"), LATE_BINDING,
               E_HIKU_PS._replace(sched="FCFS"),
               E_DD_PS._replace(sched="SRPT"))
     for b in ("auto", "kernel", "torch")]


@pytest.mark.parametrize("policy,device,backend,want", ROUTES,
                         ids=lambda x: getattr(x, "name", str(x)))
def test_routing_table(policy, device, backend, want):
    assert engine(policy, device, backend) == want
    assert engine(policy.name, torch.device(device), backend) == want


def test_routing_table_names_the_fused_policies():
    assert set(ENGINES) == {("E", balancer_name(p.balance), "PS")
                            for p in (*FUSED, *ZOO)}
    with pytest.raises(ValueError, match="unknown backend"):
        engine(HERMES, "cuda", "jax")


def test_cpu_launches_nothing():
    cluster, wb = _workloads("overload")
    before = (kernel.sim_engine.launches,
              hermes_kernel.hermes_select_batch.launches)
    stats = LoopStats()
    out = simulate_many(E_R_PS, cluster, wb, device="cpu", backend="kernel",
                        stats=stats)
    got = ops.sim_engine("R", cluster, *_inputs(wb))
    assert (kernel.sim_engine.launches,
            hermes_kernel.hermes_select_batch.launches) == before
    assert stats.host_syncs > 0      # the batched engine ran, not the kernel
    _assert_bit_equal({k: v.numpy() for k, v in got.items()}, out)


def test_wrapper_refuses_what_it_does_not_take():
    cluster, wb = _workloads("overload")
    args = _inputs(wb)
    for balance in ("E/H/PS", "E/HIKU/PS", "NOPE", "L"):
        with pytest.raises(NotPortedError):
            kernel.sim_engine(balance, cluster, *args)
        with pytest.raises(NotPortedError):
            sim_engine_ref(balance, cluster, *args)
    with pytest.raises(UnsupportedShapeError, match="W <="):
        kernel.sim_engine("H", cluster._replace(
            n_workers=kernel.MAX_WORKERS + 1), *args)
    # the kernel's wrapper refuses CPU tensors: no silent fallback
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.sim_engine("H", cluster, *args)
    # the kernel has a code for every balancer the policy table routes
    # to it, and takes the policy's enum as its name
    assert {b for _, b, _ in ENGINES} == set(BALANCER_CODES)
    assert [balancer_name(p.balance) for p in (*FUSED, *ZOO)] == \
        ["H", "LL", "LOC", "R", "JSQ2", "RR", "HIKU", "DD", "SWARM"]


def test_cuda_kernel_matches_batched_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for case in ("small-pen0.5", "overload"):
        cluster, wb = _workloads(case)
        for policy in (*FUSED, *ZOO):
            before = kernel.sim_engine.launches
            got = simulate_many(policy, cluster, wb, device="cuda")
            assert kernel.sim_engine.launches == before + 1
            plain = simulate_many(policy, cluster, wb, device="cuda",
                                  backend="torch")
            for plane in PLANES:
                np.testing.assert_array_equal(getattr(got, plane),
                                              getattr(plain, plane),
                                              err_msg=plane)
