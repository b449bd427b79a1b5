"""The engines' timeline plane on the CPU.

* The batched engine (``backend="torch"``) under ``timeline=`` against
  JAX's ``simulate_many`` at fig15's parity shape (4 × 3 cores, capacity
  2, N = 240, loads and seeds (0.6, 0) and (1.0, 1), ``TimelineCfg(32,
  0.0, 96, 128)``, with telemetry) for E/LL/PS, E/H/PS (its mode flips),
  L/LL/FCFS, E/LL/SRPT and E/LL/PS on a ``two-gen`` fleet under
  ``TARGET_P99``: integer planes equal, f64 planes within 1e-9 (fig15's
  own np ≡ jax bound).
* A timeline changes no other plane (telemetry, the autoscaler's state
  and ``prov_core_s`` included), in the batched engine and in
  ``sim_engine_ref``.
* ``sim_engine_ref``'s timeline plane bit-equal to the batched engine for
  all nine balancers, with and without a lifecycle and telemetry, and
  under ``TARGET_P99``.
* The route (a timeline run of E/<B>/PS is the kernel's on the card) and
  fig15's decision lane at a reduced depth: the log replays ``n_on``.

The last test holds the CUDA kernel against the batched engine under the
plane and runs only where a card is present.  Where JAX is not installed,
the reference-side tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_LL_PS,
                              E_LOC_PS, E_R_PS, E_RR_PS, E_SWARM_PS, HERMES,
                              PAPER_TESTBED, WORKLOADS, ClusterCfg,
                              FleetCfg, LifecycleCfg, parse_policy,
                              stack_workloads, synth_workload)
from repro_torch.core.simulator import simulate_many
from repro_torch.kernels.hermes_select import kernel as hermes_kernel
from repro_torch.kernels.sim_engine import kernel, ops
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.policy import engine
from repro_torch.telemetry import TelemetryCfg, TimelineCfg

try:
    import repro.core as rc
    import repro.fleet as rf
    from repro.core.simulator import simulate_many as jax_simulate_many
    from repro.telemetry import TelemetryCfg as JaxTelemetryCfg
    from repro.telemetry import TimelineCfg as JaxTimelineCfg
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

PAR = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
PAR_N = 240
PAR_LOADS = ((0.6, 0), (1.0, 1))
PAR_TL = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
AUTO = FleetCfg(preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                target_p99=4.0, cooldown_s=2.0)
TEL = TelemetryCfg()
FUSED = (HERMES, E_LL_PS, E_LOC_PS, E_R_PS, E_JSQ2_PS, E_RR_PS, E_HIKU_PS,
         E_DD_PS, E_SWARM_PS)
#: fig15's parity stacks and E/LL/SRPT
STACKS = {
    "E/LL/PS": (E_LL_PS, PAR),
    "E/H/PS|mode-flips": (HERMES, PAR),
    "L/LL/FCFS": (parse_policy("L/LL/FCFS"), PAR),
    "E/LL/SRPT": (parse_policy("E/LL/SRPT"), PAR),
    "E/LL/PS|fleet|auto": (E_LL_PS, PAR._replace(fleet=AUTO)),
}
INTEGER = ("mode", "arrivals", "n_cold", "n_warm", "n_evict", "n_reject",
           "slow_hist", "lat_hist", "n_on", "ev_kind", "ev_val", "ev_count")
FLOATS = ("window_s", "busy_time", "qlen_time", "prov_core", "ev_t",
          "ev_p99")
PLANES = ("response", "cold", "rejected", "worker", "server_time",
          "core_time", "end_time", "prov_core_s")
#: the plain version's cases: a small overloaded cluster
TINY = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                  cold_start_penalty=0.25)
TINY_TL = TimelineCfg(n_windows=12, coarse_bins=48, max_events=6)
REF_CASES = {
    "plain": (TINY, None),
    "life+telemetry": (TINY._replace(lifecycle=LifecycleCfg(
        "HYBRID_HIST", 2.0, 2, "aws-lambda")), TEL),
    "target-p99": (TINY._replace(fleet=FleetCfg(
        preset="long-tail", autoscale="TARGET_P99", target_p99=4.0,
        cooldown_s=1.0, min_workers=2)), TEL),
}


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _parity(cluster):
    return stack_workloads(synth_workload(cluster, load, PAR_N,
                                          n_functions=5, seed=seed)
                           for load, seed in PAR_LOADS)


def _tiny(cluster, n=120):
    return stack_workloads(synth_workload(cluster, load, n, n_functions=5,
                                          hot_fraction=0.8, seed=1)
                           for load in (0.7, 2.0))


def _inputs(wb):
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


def _jax(policy, cluster):
    fl = cluster.fleet
    jcl = rc.ClusterCfg(*cluster[:4], fleet=None if fl is None
                        else rf.FleetCfg(*fl))
    return jax_simulate_many(
        rc.parse_policy(policy.name), jcl,
        [rc.synth_workload(jcl, load, PAR_N, n_functions=5, seed=seed)
         for load, seed in PAR_LOADS],
        telemetry=JaxTelemetryCfg(), timeline=JaxTimelineCfg(*PAR_TL))


def _assert_timeline_close(ours, theirs):
    for f in INTEGER:
        a, b = np.asarray(getattr(ours, f)), np.asarray(getattr(theirs, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f),
                                   rtol=1e-9, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("stack", STACKS)
def test_batched_engine_timeline_matches_jax(reference, stack):
    policy, cluster = STACKS[stack]
    out = simulate_many(policy, cluster, _parity(cluster), device="cpu",
                        telemetry=TEL, timeline=PAR_TL)
    ref = _jax(policy, cluster)
    _assert_timeline_close(out.timeline, ref.timeline)
    tl = out.timeline
    assert tl.arrivals.shape == (2, PAR_TL.n_windows)
    assert int(tl.arrivals.sum()) == 2 * PAR_N
    assert int(tl.n_reject.sum()) == int(out.rejected.sum())
    assert int(tl.slow_hist.sum()) == int((~out.rejected).sum())
    if stack.startswith("E/H"):
        assert int(tl.ev_count.sum()) > 0        # Hermes flipped its mode
    if stack.endswith("auto"):
        assert (tl.ev_kind[:, :1] == 0).all() and int(tl.ev_count.min()) > 0
    if stack.startswith("L/"):
        assert (tl.qlen_time > 0).any()


@pytest.mark.parametrize("stack", ["E/H/PS|mode-flips", "L/LL/FCFS",
                                   "E/LL/PS|fleet|auto"])
def test_timeline_changes_no_other_plane(stack):
    policy, cluster = STACKS[stack]
    wb = _parity(cluster)
    off = simulate_many(policy, cluster, wb, device="cpu", telemetry=TEL)
    on = simulate_many(policy, cluster, wb, device="cpu", telemetry=TEL,
                       timeline=PAR_TL)
    assert off.timeline is None and on.timeline is not None
    for p in PLANES:
        assert np.asarray(getattr(on, p)).tobytes() == \
            np.asarray(getattr(off, p)).tobytes(), p
    for f in ("slow_hist", "lat_hist", "busy_time", "depth_time",
              "decisions"):
        assert getattr(on.telemetry, f).tobytes() == \
            getattr(off.telemetry, f).tobytes(), f
    for k, v in (off.fleet or {}).items():
        assert on.fleet[k].tobytes() == v.tobytes(), k
    one = on.rep(1)
    assert one.timeline.arrivals.tobytes() == \
        on.timeline.arrivals[1].tobytes()
    assert on[1:].timeline.n_on.tobytes() == on.timeline.n_on[1:].tobytes()


@pytest.mark.parametrize("case", REF_CASES)
@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_plain_version_matches_the_batched_engine(case, policy):
    cluster, tel = REF_CASES[case]
    wb = _tiny(cluster)
    got = sim_engine_ref(policy.balance, cluster, *_inputs(wb), tel,
                         TINY_TL)
    out = simulate_many(policy, cluster, wb, device="cpu", backend="torch",
                        telemetry=tel, timeline=TINY_TL)
    assert np.array_equal(got["resp"].numpy(), out.response, equal_nan=True)
    tl = out.timeline
    keys = [k for k in got if k.startswith("tl_")]
    assert len(keys) == 18
    for k in keys:
        a, b = got[k].numpy(), np.asarray(getattr(tl, k[3:]))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    # the timeline changes nothing else in the plain version either (it
    # turns the observation plane on, whose busy_iters a bound reads)
    off = sim_engine_ref(policy.balance, cluster, *_inputs(wb), tel)
    rest = {k for k in got if not k.startswith("tl_")}
    assert set(off) <= rest and rest - set(off) <= {"busy_iters"}
    for k, v in off.items():
        assert v.numpy().tobytes() == got[k].numpy().tobytes(), k


def test_route_and_cpu_dispatch():
    # a timeline run of E/<B>/PS is the kernel's on the card; on the CPU
    # the plain version runs and nothing launches
    for policy in FUSED:
        for cluster in (PAR, PAR._replace(fleet=AUTO)):
            assert engine(policy, "cuda", "auto", cluster) == "sim_engine"
    assert engine(parse_policy("E/LL/SRPT"), "cuda", "auto", PAR) == \
        "batched"
    before = (kernel.sim_engine.launches,
              hermes_kernel.hermes_select_batch.launches)
    wb = _tiny(TINY, 60)
    got = ops.sim_engine("H", TINY, *_inputs(wb), None, TINY_TL)
    simulate_many(HERMES, TINY, wb, device="cpu", backend="kernel",
                  timeline=TINY_TL)
    assert (kernel.sim_engine.launches,
            hermes_kernel.hermes_select_batch.launches) == before
    assert "tl_n_on" in got and "tel_n_cold" not in got


def test_invalid_timeline_is_refused():
    wb = _tiny(TINY, 30)
    with pytest.raises(ValueError, match="coarse_bins"):
        simulate_many(HERMES, TINY, wb, device="cpu",
                      timeline=TimelineCfg(coarse_bins=7))
    with pytest.raises(ValueError, match="n_windows"):
        sim_engine_ref("H", TINY, *_inputs(wb), None,
                       TimelineCfg(n_windows=0))


def test_decision_lane_replays_n_on():
    # fig15's decision lane at a reduced depth: HERMES on a two-gen fleet
    # under TARGET_P99 (target 3.0, floor 2, cooldown 2 s), azure-diurnal
    cl = PAPER_TESTBED._replace(fleet=FleetCfg(
        preset="two-gen", autoscale="TARGET_P99", target_p99=3.0,
        min_workers=2, cooldown_s=2.0))
    wl = WORKLOADS["azure-diurnal"](PAPER_TESTBED, 0.85, 600, seed=1)
    cfg = TimelineCfg(max_events=512)
    out = simulate_many(HERMES, cl, [wl], device="cpu", telemetry=TEL,
                        timeline=cfg).rep(0)
    tl = out.timeline
    assert 0 < int(tl.ev_count) <= cfg.max_events
    has = tl.arrivals > 0
    assert np.array_equal(tl.replay_n_on(cl.n_workers)[has], tl.n_on[has])
    evs = tl.events()
    auto = [e for e in evs if e["kind"] == "autoscale"]
    assert auto and all(np.isfinite(e["sensor_p99"]) for e in auto)
    assert int(tl.n_on[has].min()) < cl.n_workers
    # the plain version of the kernel takes the same decisions
    got = sim_engine_ref("H", cl, *_inputs(stack_workloads([wl])), TEL,
                         cfg)
    for k in ("n_on", "ev_t", "ev_val", "ev_p99", "prov_core"):
        assert got[f"tl_{k}"][0].numpy().tobytes() == \
            np.asarray(getattr(tl, k)).tobytes(), k


def test_cuda_kernel_matches_batched_engine_under_the_timeline():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for case, (cluster, tel) in REF_CASES.items():
        wb = _tiny(cluster)
        for policy in FUSED:
            before = kernel.sim_engine.launches
            got = simulate_many(policy, cluster, wb, device="cuda",
                                telemetry=tel, timeline=TINY_TL)
            assert kernel.sim_engine.launches == before + 1
            plain = simulate_many(policy, cluster, wb, device="cpu",
                                  backend="torch", telemetry=tel,
                                  timeline=TINY_TL)
            for p in PLANES:
                assert np.asarray(getattr(got, p)).tobytes() == \
                    np.asarray(getattr(plain, p)).tobytes(), (case, p)
            for f in INTEGER + FLOATS:
                assert np.asarray(getattr(got.timeline, f)).tobytes() == \
                    np.asarray(getattr(plain.timeline, f)).tobytes(), \
                    (case, policy.name, f)
