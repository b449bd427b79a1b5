"""The port's engines on the CPU against the port's numpy oracle
(``repro_torch.core.sim_ref``), at the reference's own oracle tolerances
(``repro_torch.core.sim_ref.oracle_gaps``: ``worker``, ``cold`` and
``rejected`` equal; ``response`` and the end time within 1e-6 s, NaN at
the same places; server and core time within 1e-3 relative;
``prov_core_s`` within 1e-9 relative; the telemetry's and the timeline's
integer planes equal and their float planes within 1e-9).

* The batched engine (``backend="torch"``) for the policies and loads of
  ``tests/test_simulator.py:21``, and the eviction agreement of ``:88``
  with and without a lifecycle.
* ``sim_engine_ref`` (the fused kernel's plain version) for the nine
  balancers with the life, observation and timeline planes on.
* ``simulate_stream`` (the batched engine's chunks) and the kernel's chunk
  mode in plain torch (``sim_engine_chunk``'s CPU path), segment by
  segment against ``simulate_ref_chunks``, as ``tests/test_batch_sim.py:
  280`` holds the reference's stream.
* The completion at an arrival's edge (``tests/test_batch_sim.py:51``).
* ``ServingCluster`` on the CPU with zero platform overheads under a
  lifecycle, a fleet, telemetry and a carried-state balancer
  (``tests/test_lifecycle.py:325``, ``tests/test_fleet.py:389``,
  ``tests/test_telemetry.py:178``, ``tests/test_policy_zoo.py:315``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_LL_FCFS, E_LL_PS,
                              E_LL_SRPT, FIG2_POLICIES, HERMES, ClusterCfg,
                              FleetCfg, LifecycleCfg, Workload,
                              parse_policy, stack_workloads, synth_workload)
from repro_torch.core.sim_ref import (OracleMismatch, oracle_gaps,
                                      simulate_ref, simulate_ref_chunks,
                                      telemetry_gap)
from repro_torch.core.simulator import (BatchSimOutput, _prov_core_s,
                                        _tel_of, _tl_of, simulate_many)
from repro_torch.core.streaming import simulate_stream
from repro_torch.kernels.sim_engine import ops
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.policy import balancer_names
from repro_torch.serving.engine import ServeCfg, ServingCluster
from repro_torch.telemetry import (N_BINS, TelemetryCfg, TimelineCfg,
                                   TimelineResult, warmup_cutoff)
from repro_torch.telemetry import engine as tel_engine

CLUSTER = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
POLICIES = (*FIG2_POLICIES, HERMES, E_LL_SRPT)
LOADS = (0.4, 0.9, 1.3)
TEL = TelemetryCfg()
TL = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
AUTO = FleetCfg(preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                target_p99=4.0, cooldown_s=2.0)
#: every plane on: a budgeted adaptive keep-alive, an autoscaled
#: heterogeneous fleet (the observation plane), telemetry and a timeline
PLANES = CLUSTER._replace(
    lifecycle=LifecycleCfg("HYBRID_HIST", ttl_s=2.0, max_idle=3,
                           coldstart="paper-sim"), fleet=AUTO)


@pytest.fixture(autouse=True)
def one_thread():
    """Six xdist workers at the default thread count oversubscribe the
    host; the batched engine's ops are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wl(cluster, load, n=250, seed=0, **kw):
    kw = {"n_functions": 5, "hot_fraction": 0.8, **kw}
    return synth_workload(cluster, load, n, seed=seed, **kw)


def _held(policy, cluster, wls, out, telemetry=None, timeline=None):
    """Each replication of ``out`` held to the oracle's run of its
    workload; returns the largest gaps."""
    gaps = {}
    for r, wl in enumerate(wls):
        ref = simulate_ref(policy, cluster, wl, telemetry=telemetry,
                           timeline=timeline)
        for k, g in oracle_gaps(out.rep(r), ref, f"{policy.name} rep {r}"
                                ).items():
            gaps[k] = max(gaps.get(k, 0.0), g)
    return gaps


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_batched_engine_agrees_with_oracle(policy):
    wls = [_wl(CLUSTER, load) for load in LOADS]
    out = simulate_many(policy, CLUSTER, wls, device="cpu", backend="torch",
                        telemetry=TEL)
    gaps = _held(policy, CLUSTER, wls, out, telemetry=TEL)
    assert gaps["response"] <= 1e-6 and gaps["telemetry"] <= 1e-9


@pytest.mark.parametrize("life", [None, LifecycleCfg(ttl_s=4.0, max_idle=1)],
                         ids=["no-lifecycle", "FIXED_TTL"])
@pytest.mark.parametrize("policy", [HERMES, *(FIG2_POLICIES[i]
                                              for i in (0, 2, 4, 6))],
                         ids=lambda p: p.name)
def test_eviction_agreement_with_oracle(policy, life):
    base = ClusterCfg(n_workers=3, cores=2, capacity_factor=1,
                      cold_start_penalty=0.3)
    cl = base._replace(lifecycle=life)
    wls = [synth_workload(base, 1.1, 250, n_functions=8, hot_fraction=0.4,
                          seed=seed) for seed in range(3)]
    out = simulate_many(policy, cl, wls, device="cpu", backend="torch",
                        telemetry=TEL)
    _held(policy, cl, wls, out, telemetry=TEL)
    assert int(out.telemetry.n_evict.sum()) > 0


def _fused_output(balance, cluster, wb, telemetry, timeline):
    """``sim_engine_ref``'s run as ``simulate_many`` returns the fused
    engine's: its outputs made into a ``BatchSimOutput``."""
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
    st = sim_engine_ref(balance, cluster, put(wb.arrival, torch.float64),
                        put(wb.func, torch.int32),
                        put(wb.service, torch.float64),
                        put(wb.u_lb, torch.float64),
                        put(wb.func_home, torch.int32), telemetry, timeline)
    return BatchSimOutput(
        response=st["resp"].numpy(), cold=st["cold"].numpy(),
        rejected=st["rejected"].numpy(), worker=st["worker_of"].numpy(),
        server_time=st["server_time"].numpy(),
        core_time=st["core_time"].numpy(), end_time=st["now"].numpy(),
        telemetry=tel_engine.result_of(_tel_of(st), telemetry),
        prov_core_s=_prov_core_s(st, cluster),
        timeline=TimelineResult.from_state(_tl_of(st), cfg=timeline))


@pytest.mark.parametrize("balance", balancer_names())
def test_sim_engine_ref_agrees_with_oracle_every_plane(balance):
    policy = parse_policy(f"E/{balance}/PS")
    wls = [_wl(PLANES, load, n=240, seed=seed)
           for load, seed in ((0.6, 0), (1.3, 1))]
    out = _fused_output(balance, PLANES, stack_workloads(wls), TEL, TL)
    gaps = _held(policy, PLANES, wls, out, telemetry=TEL, timeline=TL)
    assert set(gaps) >= {"telemetry", "timeline", "prov_core_s"}
    assert float(out.prov_core_s.max()) < \
        float(out.end_time.max()) * PLANES.n_workers * PLANES.cores


def _tel_at(carry, r):
    """Replication ``r``'s telemetry in an engine's carry, numpy, the
    sketches without the batched engine's dropped bin."""
    tel = {k[4:]: v[r].numpy() for k, v in carry.items()
           if k.startswith("tel_")}
    for k in ("slow_hist", "lat_hist"):
        tel[k] = tel[k][:N_BINS]
    return tel


STREAMS = {"E/LL/PS": (E_LL_PS, CLUSTER), "E/H/PS": (HERMES, CLUSTER),
           "E/DD/PS|ka|auto": (E_DD_PS, PLANES)}


@pytest.mark.parametrize("chunk", [40, 96])
@pytest.mark.parametrize("stack", STREAMS)
def test_stream_per_segment_agrees_with_oracle(stack, chunk):
    policy, cl = STREAMS[stack]
    wls = [_wl(cl, 0.9, n=140, seed=4), _wl(cl, 1.2, n=140, seed=5)]
    seen = []
    out = simulate_stream(
        policy, cl, wls, chunk_size=chunk, device="cpu", telemetry=TEL,
        collect_outputs=True,
        chunk_callback=lambda c, st: seen.append(
            {k: v.clone() for k, v in st.items() if k.startswith("tel_")}))
    for r, wl in enumerate(wls):
        ref, snaps = simulate_ref_chunks(policy, cl, wl, chunk_size=chunk,
                                         telemetry=TEL)
        assert len(seen) == len(snaps) == -(-wl.n // chunk)
        for c, snap in enumerate(snaps):
            telemetry_gap(_tel_at(seen[c], r), snap,
                          f"{stack} rep {r} after chunk {c}")
        for name in ("worker", "cold", "rejected"):
            np.testing.assert_array_equal(getattr(out, name)[r],
                                          getattr(ref, name))
        telemetry_gap(out.telemetry.rep(r), ref.telemetry, f"rep {r}")
        assert abs(float(out.end_time[r]) - ref.end_time) <= 1e-6
        assert abs(float(out.prov_core_s[r]) - ref.prov_core_s) <= \
            1e-9 * ref.prov_core_s
        cut = warmup_cutoff(wl.n, TEL)
        obs = ~ref.rejected[cut:]
        assert int(out.n_observed[r]) == int(obs.sum())
        assert abs(float(out.resp_mean[r])
                   - float(ref.response[cut:][obs].mean())) <= 1e-6


@pytest.mark.parametrize("balance", ["LL", "H", "DD"])
def test_kernel_chunk_mode_per_segment_agrees_with_oracle(balance):
    """The kernel's chunk mode in plain torch (what ``sim_engine_chunk``
    runs on a CPU tensor), chunk by chunk, against the oracle's
    snapshots: the carry the card's chunk mode is held to."""
    policy = parse_policy(f"E/{balance}/PS")
    cl = PLANES if balance == "DD" else CLUSTER
    wls = [_wl(cl, 0.9, n=140, seed=4), _wl(cl, 1.2, n=140, seed=5)]
    wb, chunk = stack_workloads(wls), 40
    plan = ops.chunk_plan(balance, cl, wb.n_reps, wb.n_functions, "cpu",
                          TEL)
    home = torch.as_tensor(wb.func_home, dtype=torch.int32)
    carry, seen = None, []
    for g0 in range(0, wb.n, chunk):
        sl = slice(g0, min(g0 + chunk, wb.n))
        ins = [torch.as_tensor(np.ascontiguousarray(x[:, sl]), dtype=d)
               for x, d in ((wb.arrival, torch.float64),
                            (wb.func, torch.int32),
                            (wb.service, torch.float64),
                            (wb.u_lb, torch.float64))]
        carry, _ = ops.sim_engine_chunk(plan, carry, *ins, home, g0=g0,
                                        drain=False,
                                        cutoff=warmup_cutoff(wb.n, TEL))
        seen.append({k: v.clone() for k, v in carry.items()})
    for r, wl in enumerate(wls):
        _, snaps = simulate_ref_chunks(policy, cl, wl, chunk_size=chunk,
                                       telemetry=TEL)
        assert len(snaps) == len(seen)
        for c, snap in enumerate(snaps):
            telemetry_gap(_tel_at(seen[c], r), snap,
                          f"{balance} rep {r} after chunk {c}")


def test_completion_at_an_arrivals_edge():
    """A task finishing EPS-close past the next arrival completes in the
    pending drain, in every engine as in the oracle."""
    cl = ClusterCfg(n_workers=1, cores=2, capacity_factor=2)
    wl = Workload(arrival=np.array([0.0, 1.0]),
                  func=np.zeros(2, dtype=np.int32),
                  service=np.array([1.0 + 5e-10, 1.0]),
                  u_lb=np.zeros(2), func_home=np.zeros(1, dtype=np.int32),
                  n_functions=1, load=0.5, name="eps-edge")
    for policy in (E_LL_FCFS, E_LL_PS):
        ref = simulate_ref(policy, cl, wl)
        out = simulate_many(policy, cl, [wl, wl], device="cpu",
                            backend="torch")
        _held(policy, cl, [wl, wl], out)
    out = _fused_output("LL", cl, stack_workloads([wl, wl]), TEL, TL)
    _held(E_LL_PS, cl, [wl, wl], out, telemetry=TEL, timeline=TL)
    assert np.isfinite(ref.response).all()


def _serve(policy, cluster, wl, telemetry=None, timeline=None):
    """The platform on the CPU with zero platform overheads (the oracle's
    cold cost, no controller latency): the oracle's event loop."""
    cfg = ServeCfg(cluster=cluster, cold_start_s=cluster.cold_start_penalty,
                   ctrl_latency_s=0.0)
    return ServingCluster(cfg, policy, telemetry=telemetry,
                          timeline=timeline, device="cpu").run(wl)


@pytest.mark.parametrize("case", ["FIXED_TTL", "HYBRID_HIST", "two-gen",
                                  "long-tail", "TARGET_P99", "telemetry",
                                  "HIKU", "DD", "timeline"])
def test_serving_platform_agrees_with_oracle(case):
    base = CLUSTER._replace(cold_start_penalty=0.25)
    policy, cl, tel, tl = HERMES, base, None, None
    if case in ("FIXED_TTL", "HYBRID_HIST"):
        cl = base._replace(lifecycle=LifecycleCfg(
            case, ttl_s=3.0, max_idle=2, coldstart="aws-lambda"))
    elif case in ("two-gen", "long-tail"):
        cl = base._replace(fleet=FleetCfg(preset=case))
    elif case == "TARGET_P99":
        cl, tel = base._replace(fleet=AUTO), TEL
    elif case == "telemetry":
        tel = TEL
    elif case in ("HIKU", "DD"):
        policy = E_HIKU_PS if case == "HIKU" else E_DD_PS
    else:
        tel, tl = TEL, TL
    wl = _wl(base, 0.7, n=300, seed=3)
    sv = _serve(policy, cl, wl, tel, tl)
    ref = simulate_ref(policy, cl, wl, telemetry=tel, timeline=tl)
    gaps = oracle_gaps(sv, ref, f"platform {case}")
    assert gaps["response"] <= 1e-6


def test_oracle_gaps_names_the_plane():
    wl = _wl(CLUSTER, 0.9)
    out = simulate_many(HERMES, CLUSTER, [wl], device="cpu",
                        backend="torch", telemetry=TEL).rep(0)
    ref = simulate_ref(HERMES, CLUSTER, wl, telemetry=TEL)
    oracle_gaps(out, ref)
    bad = out.worker.copy()
    bad[7] = (bad[7] + 1) % CLUSTER.n_workers
    with pytest.raises(OracleMismatch, match="worker"):
        oracle_gaps(dataclasses.replace(out, worker=bad), ref)
    resp = out.response.copy()
    resp[3] += 2e-6
    with pytest.raises(OracleMismatch, match="response"):
        oracle_gaps(dataclasses.replace(out, response=resp), ref)
    with pytest.raises(OracleMismatch, match="telemetry"):
        oracle_gaps(dataclasses.replace(out, telemetry=None), ref)
