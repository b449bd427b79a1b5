"""The policy zoo (JSQ2, RR and the carried-state HIKU, DD, SWARM) in the
port, on the CPU, against the reference.

* ``select`` and ``on_complete`` against the reference's ``np`` and
  ``jax`` backends, one replication at a time, over randomized ``[W]``
  states (slot-full and core-full rows among them) with the carried state
  threaded through random completion sequences: choices equal, the state
  equal in every entry (f64 bit for bit).
* HIKU's ready-ring and its busy-pop fallback, and DD's estimates driving
  dispatch, step by step (as ``tests/test_policy_zoo.py`` checks the
  reference).
* The engine: each zoo policy × {``ms_trace``, ``bimodal_exec``} on the
  paper's small cluster, N = 300, R = 2, and the mixed fig11 batch
  (``ms-trace``, ``azure-diurnal``, ``azure-bursty`` at load 0.7) under
  HIKU and DD, through the port's batched engine against JAX's
  ``simulate_many``: ``worker``, ``cold``, ``rejected`` equal, floats
  within rtol=atol=1e-6 (XLA contracts ``a - b*c`` into an FMA, the port
  does not: ROADMAP Queue 3).
* ``balancer_names()`` in the reference's order.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.simulator import simulate_many as jax_simulate_many
from repro.policy import balancer_names as ref_balancer_names
from repro.policy import resolve as ref_resolve
from repro.trace.replay import resample_workloads as ref_resample

from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_RR_PS,
                              E_SWARM_PS, PAPER_SMALL, WORKLOADS,
                              ZOO_POLICIES, ClusterCfg, bimodal_exec,
                              ms_trace, stack_workloads)
from repro_torch.core.simulator import simulate_many
from repro_torch.policy import balancer_names, resolve
from repro_torch.trace import resample_workloads

ZOO = (E_JSQ2_PS, E_RR_PS, E_HIKU_PS, E_DD_PS, E_SWARM_PS)
STATEFUL = ("HIKU", "DD", "SWARM")
R = 3
N = 300
TOL = dict(rtol=1e-6, atol=1e-6)
MIXED = ("ms-trace", "azure-diurnal", "azure-bursty")


@functools.cache
def _reference(name, backend, W, cores, cf):
    """The reference's (select, on_complete), jitted on the jax backend."""
    res = ref_resolve(f"E/{name}/PS", backend=backend,
                      cluster=rc.ClusterCfg(W, cores, cf))
    select, on_complete = res.select, res.on_complete
    if backend == "jax":
        select = jax.jit(select)
        on_complete = on_complete and jax.jit(on_complete)
    return res.init_state, select, on_complete


def _same_state(port, ref, r, what):
    for k, v in port.items():
        want = np.asarray(ref[k]).astype(v.numpy().dtype)
        got = v[r].numpy()
        # f64 entries bit for bit
        assert got.tobytes() == want.tobytes(), (what, k, got, want)


@pytest.mark.parametrize("backend", ["np", "jax"])
@pytest.mark.parametrize("W,cores,cf", [(3, 2, 2), (8, 12, 8), (5, 3, 1)])
@pytest.mark.parametrize("name", [p.balance for p in ZOO])
def test_select_and_on_complete_match_reference(name, backend, W, cores,
                                                cf):
    cluster = ClusterCfg(n_workers=W, cores=cores, capacity_factor=cf)
    S, F = cluster.slots, 4
    res = resolve(f"E/{name}/PS", cluster, device="cpu")
    init, ref_select, ref_complete = _reference(name, backend, W, cores, cf)
    rng = np.random.default_rng(W * 7 + cores)
    stateful = name in STATEFUL
    state = res.init_state(R, W, F, "cpu") if stateful else None
    refs = [init(W, F) for _ in range(R)] if stateful else None
    for step in range(300):
        active = rng.integers(0, S + 1, (R, W)).astype(np.int32)
        if step % 5 == 1:
            active[0] = S                              # every worker full
        if step % 5 == 2:
            active[1] = rng.integers(0, cores + 1, W)  # cores saturate
        if step % 7 == 3:
            active[2] = rng.integers(0, 2, W)          # mostly idle
        warm = rng.integers(0, 3, (R, W)).astype(np.int32)
        func = rng.integers(0, F, R)
        home = rng.integers(0, W, (R, F)).astype(np.int32)
        u = rng.uniform(size=R)
        args = (torch.as_tensor(active), torch.as_tensor(warm),
                torch.as_tensor(func), torch.as_tensor(home),
                torch.as_tensor(u), step)
        if stateful:
            got, state = res.select(state, *args)
        else:
            got = res.select(*args)
        assert got.dtype == torch.int32 and got.shape == (R,)
        for r in range(R):
            ref_args = (active[r], warm[r], int(func[r]), home[r],
                        float(u[r]), step)
            if stateful:
                w, refs[r] = ref_select(refs[r], *ref_args)
                _same_state(state, refs[r], r, f"select, step {step}")
            else:
                w = ref_select(*ref_args)
            assert int(got[r]) == int(w), (step, r)
        if not stateful:
            continue
        # a random completion in each replication: worker 0 takes most
        # of them, so its SWARM burn-in (128 completions) ends
        w_done = np.where(rng.uniform(size=R) < 0.6, 0,
                          rng.integers(0, W, R))
        f_done = rng.integers(0, F, R)
        svc = rng.lognormal(-0.5, 1.5, R)
        n_after = np.where(rng.uniform(size=R) < 0.4, 0,
                           rng.integers(1, S, R))
        state = res.on_complete(state, torch.as_tensor(w_done),
                                torch.as_tensor(f_done),
                                torch.as_tensor(svc),
                                torch.as_tensor(n_after))
        for r in range(R):
            refs[r] = ref_complete(refs[r], int(w_done[r]), int(f_done[r]),
                                   float(svc[r]), int(n_after[r]))
            _same_state(state, refs[r], r, f"on_complete, step {step}")
    if name == "SWARM":
        assert int(state["cnt"].max()) > 128      # past the burn-in


def _one(name, cores=2, slots=4, W=3, F=2):
    res = resolve(f"E/{name}/PS",
                  ClusterCfg(n_workers=W, cores=cores,
                             capacity_factor=slots // cores), device="cpu")
    return res, res.init_state(1, W, F, "cpu")


def _pick(res, state, active, func=0, idx=0):
    w, state = res.select(state, torch.tensor([active], dtype=torch.int32),
                          torch.zeros((1, len(active)), dtype=torch.int32),
                          torch.tensor([func]),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.tensor([0.5], dtype=torch.float64), idx)
    return int(w[0]), state


def _done(res, state, w, func, service, n_after):
    return res.on_complete(state, torch.tensor([w]), torch.tensor([func]),
                           torch.tensor([service], dtype=torch.float64),
                           torch.tensor([n_after]))


def test_hiku_ready_ring_semantics():
    """Pops drain the advertised ring in FIFO order, an empty ring falls
    back to least loaded, a completion that idles a worker re-advertises
    it exactly once, and a rejection keeps the state."""
    res, state = _one("HIKU")
    active = [1, 2, 1]
    for expect in (0, 1, 2):
        w, state = _pick(res, state, active)
        assert w == expect
    w, state = _pick(res, state, active)
    assert w == 0 and int(state["tail"]) == int(state["head"])
    state = _done(res, state, 1, 0, 1.0, 1)      # worker 1 still busy
    assert int(state["tail"]) == int(state["head"])
    state = _done(res, state, 1, 0, 1.0, 0)
    state = _done(res, state, 1, 0, 1.0, 0)      # already advertised
    assert int(state["tail"]) - int(state["head"]) == 1
    w, state = _pick(res, state, active)
    assert w == 1
    w, after = _pick(res, state, [4, 4, 4])      # every worker full
    assert w == -1
    for k in state:
        assert torch.equal(state[k], after[k]), k


def test_hiku_busy_pop_falls_back_to_least_loaded():
    """A slot-full ring head is popped all the same, and the arrival goes
    to the least-loaded worker; the next pop yields the next member."""
    res, state = _one("HIKU")
    w, state = _pick(res, state, [4, 3, 0])
    assert w == 2 and int(state["head"]) == 1
    assert state["in_ring"][0].tolist() == [0, 1, 1]
    w, state = _pick(res, state, [0, 0, 0], idx=1)
    assert w == 1


def test_dd_estimates_drive_dispatch():
    """DD learns per-function durations and places by expected work; a
    rejection charges nothing."""
    res, state = _one("DD", W=2)
    for _ in range(20):
        state = _done(res, state, 0, 0, 10.0, 0)
        state = _done(res, state, 1, 1, 0.1, 0)
    est = state["est"][0]
    assert est[0] > 5.0 > 1.0 > est[1]
    state = dict(state, ew=torch.zeros((1, 2), dtype=torch.float64))
    w, state = _pick(res, state, [0, 0], func=0)
    assert w == 0 and float(state["ew"][0, 0]) > 5.0
    w, state = _pick(res, state, [1, 0], func=1, idx=1)
    assert w == 1
    w, state = _pick(res, state, [1, 1], func=1, idx=2)
    assert w == 1
    w, after = _pick(res, state, [4, 4], func=0, idx=3)
    assert w == -1 and torch.equal(after["ew"], state["ew"])
    state = _done(res, state, 0, 0, 10.0, 0)
    assert float(state["ew"][0, 0]) < 5.0 and bool((state["ew"] >= 0).all())


def _compare(port, ref):
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(getattr(port, plane),
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(port.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time"):
        np.testing.assert_allclose(getattr(port, plane), getattr(ref, plane),
                                   **TOL, err_msg=plane)


GENERATORS = {"ms_trace": (ms_trace, rc.ms_trace),
              "bimodal_exec": (bimodal_exec, rc.bimodal_exec)}


@pytest.mark.parametrize("gen", GENERATORS)
@pytest.mark.parametrize("policy", ZOO, ids=lambda p: p.name)
def test_engine_matches_jax_engine(policy, gen):
    make, ref_make = GENERATORS[gen]
    loads = (0.7, 0.95)
    port = simulate_many(policy, PAPER_SMALL,
                         stack_workloads(make(PAPER_SMALL, load, N, seed=1)
                                         for load in loads), device="cpu")
    jcl = rc.ClusterCfg(*PAPER_SMALL[:4])
    ref = jax_simulate_many(rc.parse_policy(policy.name), jcl,
                            [ref_make(jcl, load, N, seed=1)
                             for load in loads])
    _compare(port, ref)


@pytest.mark.parametrize("policy", (E_HIKU_PS, E_DD_PS),
                         ids=lambda p: p.name)
def test_mixed_batch_matches_jax_engine(policy):
    wb = resample_workloads(WORKLOADS[name](PAPER_SMALL, 0.7, N, 0)
                            for name in MIXED)
    jcl = rc.ClusterCfg(*PAPER_SMALL[:4])
    ref_wb = ref_resample([rc.WORKLOADS[name](jcl, 0.7, N, 0)
                           for name in MIXED])
    np.testing.assert_array_equal(wb.arrival, ref_wb.arrival)
    port = simulate_many(policy, PAPER_SMALL, wb, device="cpu")
    ref = jax_simulate_many(rc.parse_policy(policy.name), jcl, ref_wb)
    _compare(port, ref)


def test_balancer_names_in_reference_order():
    assert balancer_names() == ref_balancer_names()
    assert balancer_names()[:4] == ("LOC", "R", "LL", "H")
    assert [p.name for p in ZOO_POLICIES] == \
        [p.name for p in rc.ZOO_POLICIES]
