"""The engines' telemetry and observation planes on the CPU.

* The batched engine (``backend="torch"``) under ``telemetry=`` against
  JAX's ``simulate_many`` for the nine E/<B>/PS policies, E/H/FCFS,
  E/LL/SRPT and L/LL/FCFS on an overloaded 4 × 3-core cluster: the
  integer planes of the telemetry equal (histograms, counters,
  decisions), its f64 integrals within 1e-9 relative (the reference's
  own np ≡ jax contract; XLA may contract them into FMAs), the ordinary
  planes as elsewhere (integers equal, floats within 1e-6); the eviction
  counts under a lifecycle budget.
* Telemetry changes no plane, in the batched engine and in
  ``sim_engine_ref``.
* ``sim_engine_ref``'s observation plane bit-equal to the batched engine
  in every plane, the telemetry and the autoscaler's state, for all nine
  balancers under telemetry, a ``two-gen`` fleet with telemetry, and
  ``TARGET_P99`` on a ``long-tail`` fleet under a lifecycle budget.
* The route (:func:`repro_torch.policy.engine`) under telemetry and
  fleets.

The last test holds the CUDA kernel against the batched engine under the
plane and runs only where a card is present.  Where JAX is not
installed, the reference-side tests skip.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import NotPortedError
from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_LL_PS,
                              E_LOC_PS, E_R_PS, E_RR_PS, E_SWARM_PS, HERMES,
                              LATE_BINDING, ClusterCfg, FleetCfg,
                              LifecycleCfg, WorkerSched, parse_policy,
                              stack_workloads, synth_workload)
from repro_torch.core.simulator import (LoopStats, _build_engine,
                                        simulate_many)
from repro_torch.kernels.hermes_select import kernel as hermes_kernel
from repro_torch.kernels.sim_engine import kernel, ops
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.policy import engine
from repro_torch.telemetry import N_BINS, TelemetryCfg

try:
    import repro.core as rc
    import repro.fleet as rf
    import repro.lifecycle as rl
    from repro.core.simulator import simulate_many as jax_simulate_many
    from repro.telemetry import TelemetryCfg as JaxTelemetryCfg
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

TINY = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                  cold_start_penalty=0.25)
N = 300
TOL = dict(rtol=1e-6, atol=1e-6)
TEL = TelemetryCfg()
FUSED = (HERMES, E_LL_PS, E_LOC_PS, E_R_PS, E_JSQ2_PS, E_RR_PS, E_HIKU_PS,
         E_DD_PS, E_SWARM_PS)
OTHERS = (HERMES._replace(sched=WorkerSched.FCFS),
          parse_policy("E/LL/SRPT"), LATE_BINDING)
PLANES = dict(response="resp", cold="cold", rejected="rejected",
              worker="worker_of", server_time="server_time",
              core_time="core_time", end_time="now")
INTEGER = ("slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict",
           "n_reject", "decisions")
INTEGRALS = ("busy_time", "depth_time", "qlen_time")
#: id -> (fleet, lifecycle) of the plain version's checks
OBS = {
    "telemetry": (None, None),
    "two-gen": (FleetCfg(preset="two-gen"), None),
    "target-p99": (FleetCfg(preset="long-tail", autoscale="TARGET_P99",
                            target_p99=8.0, cooldown_s=0.5, min_workers=2),
                   LifecycleCfg("FIXED_TTL", 2.0, 2, "aws-lambda")),
}


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _workloads(cluster, loads, seed=1):
    return stack_workloads(synth_workload(cluster, load, N, n_functions=5,
                                          hot_fraction=0.8, seed=seed)
                           for load in loads)


def _jax(policy, cluster, loads, seed=1):
    life, fl = cluster.lifecycle, cluster.fleet
    jcl = rc.ClusterCfg(
        *cluster[:4], lifecycle=None if life is None
        else rl.LifecycleCfg(*life), fleet=None if fl is None
        else rf.FleetCfg(*fl))
    return jax_simulate_many(
        rc.parse_policy(policy.name), jcl,
        [rc.synth_workload(jcl, load, N, n_functions=5, hot_fraction=0.8,
                           seed=seed) for load in loads],
        telemetry=JaxTelemetryCfg())


def _assert_telemetry_close(ours, theirs):
    for f in INTEGER:
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)
    for f in INTEGRALS:
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f),
                                   rtol=1e-9, atol=0.0, err_msg=f)


@pytest.mark.parametrize("policy", FUSED + OTHERS, ids=lambda p: p.name)
def test_batched_engine_telemetry_matches_jax(reference, policy):
    loads = (0.5, 0.9, 1.3)
    out = simulate_many(policy, TINY, _workloads(TINY, loads),
                        device="cpu", telemetry=TEL)
    ref = _jax(policy, TINY, loads)
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(getattr(out, plane),
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(out.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    _assert_telemetry_close(out.telemetry, ref.telemetry)
    assert out.telemetry.slow_hist.shape == (3, N_BINS)
    assert int(out.telemetry.n_reject.sum()) == int(out.rejected.sum())
    if policy == LATE_BINDING:
        assert (out.telemetry.qlen_time > 0).any()
    else:
        assert (out.telemetry.qlen_time == 0).all()


@pytest.mark.parametrize("policy", [HERMES, E_LL_PS], ids=lambda p: p.name)
def test_budget_evictions_match_jax(reference, policy):
    cl = TINY._replace(lifecycle=LifecycleCfg("FIXED_TTL", ttl_s=5.0,
                                              max_idle=2))
    loads = (0.9, 1.3)
    out = simulate_many(policy, cl, _workloads(cl, loads), device="cpu",
                        telemetry=TEL)
    _assert_telemetry_close(out.telemetry, _jax(policy, cl, loads).telemetry)
    assert out.telemetry.n_evict.sum() > 0


@pytest.mark.parametrize("policy", [HERMES, E_SWARM_PS, LATE_BINDING],
                         ids=lambda p: p.name)
def test_telemetry_does_not_perturb_results(policy):
    wb = _workloads(TINY, (0.9, 1.3), seed=2)
    base = simulate_many(policy, TINY, wb, device="cpu")
    tel = simulate_many(policy, TINY, wb, device="cpu", telemetry=TEL)
    for plane in PLANES:
        assert getattr(base, plane).tobytes() == \
            getattr(tel, plane).tobytes(), plane
    assert base.telemetry is None and tel.telemetry is not None
    if policy != LATE_BINDING:
        a = sim_engine_ref(policy.balance, TINY, *_inputs(wb))
        b = sim_engine_ref(policy.balance, TINY, *_inputs(wb), TEL)
        for key in PLANES.values():
            assert a[key].numpy().tobytes() == b[key].numpy().tobytes()


def _inputs(wb, device="cpu"):
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


@functools.cache
def _obs_case(name):
    fleet, life = OBS[name]
    cluster = TINY._replace(fleet=fleet, lifecycle=life)
    return cluster, _workloads(cluster, (0.7, 1.3, 3.0))


@pytest.mark.parametrize("obs", OBS)
@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_plain_version_matches_batched_engine(policy, obs):
    cluster, wb = _obs_case(obs)
    ref = sim_engine_ref(policy.balance, cluster, *_inputs(wb), TEL)
    run = _build_engine(policy, cluster, wb.n, wb.n_functions, wb.n_reps,
                        torch.device("cpu"), "torch", TEL)
    a, f, s, u, h = _inputs(wb)
    st = run(a, f.long(), s, u, h, LoopStats())
    for key in PLANES.values():
        want = st[key][:, :wb.n] if st[key].dim() == 2 else st[key]
        assert ref[key].dtype == want.dtype, key
        assert ref[key].numpy().tobytes() == \
            want.contiguous().numpy().tobytes(), key
    state = sorted(k for k in ref if k.startswith(("tel_", "fleet_",
                                                   "life_", "lb_")))
    assert state == sorted(k for k in st if k.startswith(
        ("tel_", "fleet_", "life_", "lb_")))
    for key in state:
        want = st[key]
        if key in ("tel_slow_hist", "tel_lat_hist"):
            want = want[:, :N_BINS]           # the dropped bin
        elif key == "life_idle_since":
            want = want[:, :, :wb.n_functions]
        assert ref[key].dtype == want.dtype, key
        assert ref[key].numpy().tobytes() == \
            want.contiguous().numpy().tobytes(), key
    assert ref["rejected"].any() and ref["tel_slow_hist"].sum() > 0
    if obs == "target-p99":
        # it scaled down: less than the whole fleet provisioned
        assert (ref["fleet_prov_time"] < 4 * ref["now"]).all()
        assert ref["tel_n_evict"].sum() > 0


def test_plane_outputs():
    """What the plain version returns: telemetry only when asked for, the
    autoscaler's state only under one, ``busy_iters`` whenever the plane
    is on; nothing of it without telemetry or a fleet."""
    cluster, wb = _obs_case("two-gen")
    plain = sim_engine_ref("H", TINY, *_inputs(wb))
    assert not any(k.startswith(("tel_", "fleet_")) or k == "busy_iters"
                   for k in plain)
    fleet_only = sim_engine_ref("H", cluster, *_inputs(wb))
    assert "busy_iters" in fleet_only and not any(
        k.startswith(("tel_", "fleet_")) for k in fleet_only)
    auto, wb2 = _obs_case("target-p99")
    both = sim_engine_ref("LL", auto, *_inputs(wb2), TEL)
    assert {k for k in both if k.startswith("fleet_")} == {
        "fleet_n_on", "fleet_cool_until", "fleet_prov_time", "fleet_snap"}
    assert both["fleet_snap"].shape == (3, N_BINS)
    # busy_iters counts the busy workers of each iteration with tau > 0
    assert (both["busy_iters"] > 0).all() and \
        (both["busy_iters"] <= 4 * both["iters"]).all()


@pytest.mark.parametrize("fleet", [FleetCfg(), FleetCfg(preset="uniform"),
                                   FleetCfg(speed=(1.0,) * 4)],
                         ids=("default", "uniform", "unit-vector"))
@pytest.mark.parametrize("balance", ("H", "SWARM"))
def test_static_unit_fleet_keeps_the_plane_off(balance, fleet):
    """A ``STATIC`` fleet of unit speeds without telemetry changes no
    output, so the plane stays off (the kernel's plane-off instantiation
    runs): the plain version returns exactly the no-fleet outputs."""
    from repro_torch.kernels.sim_engine.ref import obs_plane
    cluster = TINY._replace(fleet=fleet)
    assert obs_plane(cluster, None, 3, N, 4, "cpu") is None
    assert obs_plane(cluster, TEL, 3, N, 4, "cpu") is not None
    wb = _obs_case("two-gen")[1]
    off = sim_engine_ref(balance, TINY, *_inputs(wb))
    got = sim_engine_ref(balance, cluster, *_inputs(wb))
    assert sorted(got) == sorted(off)
    for key in off:
        assert got[key].numpy().tobytes() == off[key].numpy().tobytes(), key


def test_route_under_telemetry_and_fleets():
    from repro_torch.fleet import register_autoscaler, unregister_autoscaler
    fleets = [FleetCfg(), FleetCfg(preset="two-gen"),
              FleetCfg(preset="long-tail", autoscale="TARGET_P99"),
              FleetCfg(speed=(1.0, 0.5, 0.25, 2.0))]
    for policy in FUSED:
        for fl in fleets:
            cl = TINY._replace(fleet=fl)
            assert engine(policy, "cuda", "auto", cl) == "sim_engine"
            assert engine(policy, "cuda", "torch", cl) == "batched"
            assert engine(policy, "cpu", "auto", cl) == "batched"
        big = TINY._replace(n_workers=kernel.MAX_WORKERS + 1,
                            fleet=FleetCfg(preset="two-gen"))
        assert engine(policy, "cuda", "auto", big) == "batched"
    for policy in OTHERS:
        assert engine(policy, "cuda", "auto",
                      TINY._replace(fleet=fleets[1])) == "batched"
    register_autoscaler("NOOP", make_torch=lambda c, w, d: (
        lambda n_on, window: n_on))
    try:
        cl = TINY._replace(fleet=FleetCfg(autoscale="NOOP"))
        assert engine(HERMES, "cuda", "auto", cl) == "batched"
        with pytest.raises(NotPortedError, match="built-in autoscalers"):
            sim_engine_ref("H", cl, *_inputs(_workloads(cl, (0.5,))), TEL)
    finally:
        unregister_autoscaler("NOOP")


def test_cpu_under_the_plane_launches_nothing():
    cluster, wb = _obs_case("target-p99")
    before = (kernel.sim_engine.launches,
              hermes_kernel.hermes_select_batch.launches)
    out = simulate_many(HERMES, cluster, wb, device="cpu", backend="kernel",
                        telemetry=TEL)
    got = ops.sim_engine("H", cluster, *_inputs(wb), TEL)
    assert (kernel.sim_engine.launches,
            hermes_kernel.hermes_select_batch.launches) == before
    for plane, key in PLANES.items():
        np.testing.assert_array_equal(got[key].numpy(), getattr(out, plane))
    for f in INTEGER + INTEGRALS:
        assert got[f"tel_{f}"].numpy().tobytes() == \
            getattr(out.telemetry, f).tobytes(), f
    for k, v in out.fleet.items():
        assert got[f"fleet_{k}"].numpy().tobytes() == v.tobytes(), k


def test_cuda_kernel_matches_batched_engine_under_the_plane():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for name in OBS:
        cluster, wb = _obs_case(name)
        for policy in FUSED:
            before = kernel.sim_engine.launches
            got = simulate_many(policy, cluster, wb, device="cuda",
                                telemetry=TEL)
            assert kernel.sim_engine.launches == before + 1
            plain = simulate_many(policy, cluster, wb, device="cuda",
                                  backend="torch", telemetry=TEL)
            for plane in PLANES:
                assert getattr(got, plane).tobytes() == \
                    getattr(plain, plane).tobytes(), plane
            for f in INTEGER + INTEGRALS:
                assert getattr(got.telemetry, f).tobytes() == \
                    getattr(plain.telemetry, f).tobytes(), f
            assert (got.fleet is None) == (plain.fleet is None)
            for k, v in (plain.fleet or {}).items():
                assert got.fleet[k].tobytes() == v.tobytes(), k
