"""The port's numpy oracle (``repro_torch.core.sim_ref``) against the
reference's (``repro.core.sim_ref``), bit for bit, on the CPU.

Both are numpy with the same operations in the same order, so every field
of ``SimResult`` is equal: ``response`` (NaN at the same places),
``cold``, ``rejected``, ``worker``, the three times, ``prov_core_s`` and
every plane of ``telemetry`` and ``timeline`` (dtypes and bits).  The
cases:

* the fig2 policies, Hermes, E/LL/SRPT and the zoo at loads 0.4, 0.9 and
  1.3 on 4 × 3 cores, capacity factor 2, N = 250
  (``tests/test_simulator.py:10-21``);
* the eviction-pressure cluster of ``tests/test_simulator.py:88-110``
  without a lifecycle and under NONE, FIXED_TTL (with ``max_idle``) and
  HYBRID_HIST;
* fleets: ``two-gen`` static and under ``TARGET_P99`` with telemetry;
* timelines: Hermes' mode flips, the autoscaler's events, late binding,
  budget evictions;
* ``simulate_ref_chunks``' per-segment snapshots;
* the named errors of ``tests/test_fleet.py:273``.

Where JAX is not installed, the reference-side tests skip.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.core import (E_DD_PS, E_LL_PS, E_LL_SRPT, E_SWARM_PS,
                              FIG2_POLICIES, HERMES, LATE_BINDING,
                              ZOO_POLICIES, ClusterCfg, FleetCfg,
                              LifecycleCfg, parse_policy, synth_workload)
from repro_torch.core.sim_ref import (SimResult, simulate_ref,
                                      simulate_ref_chunks)
from repro_torch.telemetry import TelemetryCfg, TimelineCfg

try:
    import repro.core as rc
    import repro.fleet as rf
    import repro.lifecycle as rl
    import repro.telemetry as rt
    from repro.core import sim_ref as ref_oracle
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

CLUSTER = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
POLICIES = tuple({p.name: p for p in (*FIG2_POLICIES, HERMES, E_LL_SRPT,
                                      *ZOO_POLICIES)}.values())
EVICT = ClusterCfg(n_workers=3, cores=2, capacity_factor=1,
                   cold_start_penalty=0.3)
LIVES = {"none": None, "NONE": LifecycleCfg("NONE"),
         "FIXED_TTL": LifecycleCfg(ttl_s=4.0, max_idle=1),
         "HYBRID_HIST": LifecycleCfg("HYBRID_HIST", ttl_s=4.0, max_idle=1,
                                     coldstart="aws-lambda")}
TWO_GEN = FleetCfg(preset="two-gen")
AUTO = FleetCfg(preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                target_p99=4.0, cooldown_s=2.0)
TEL = TelemetryCfg()
TL = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)


@pytest.fixture(autouse=True)
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _wl(cluster, load, n=250, seed=0, **kw):
    kw = {"n_functions": 5, "hot_fraction": 0.8, **kw}
    return synth_workload(cluster, load, n, seed=seed, **kw)


def _ref_args(cluster, wl, telemetry, timeline):
    life, fl = cluster.lifecycle, cluster.fleet
    jcl = rc.ClusterCfg(*cluster[:4],
                        lifecycle=None if life is None
                        else rl.LifecycleCfg(*life),
                        fleet=None if fl is None else rf.FleetCfg(*fl))
    jwl = rc.Workload(**{f.name: getattr(wl, f.name)
                         for f in dataclasses.fields(wl)})
    return jcl, jwl, dict(
        telemetry=None if telemetry is None else rt.TelemetryCfg(*telemetry),
        timeline=None if timeline is None else rt.TimelineCfg(*timeline))


def _same_value(a, b, what):
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(b):
            _same_value(getattr(a, f.name), getattr(b, f.name),
                        f"{what}.{f.name}")
    elif isinstance(b, tuple):            # a config
        assert tuple(a) == tuple(b), what
    elif b is None or isinstance(b, (float, int)):
        assert type(a) is type(b) and (a == b or (a != a and b != b)), \
            (what, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what


def _both(policy, cluster, wl, telemetry=None, timeline=None):
    """The port's oracle and the reference's on the same inputs, held
    equal in every field; returns the port's result."""
    got = simulate_ref(policy, cluster, wl, telemetry=telemetry,
                       timeline=timeline)
    jcl, jwl, kw = _ref_args(cluster, wl, telemetry, timeline)
    want = ref_oracle.simulate_ref(rc.parse_policy(policy.name), jcl, jwl,
                                   **kw)
    assert isinstance(got, SimResult)
    _same_value(got, want, policy.name)
    return got


@pytest.mark.parametrize("load", [0.4, 0.9, 1.3])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_oracle_bit_equal(policy, load):
    out = _both(policy, CLUSTER, _wl(CLUSTER, load))
    assert np.isfinite(out.response[~out.rejected]).all()


@pytest.mark.parametrize("life", LIVES, ids=str)
@pytest.mark.parametrize("policy", [HERMES, *(FIG2_POLICIES[i]
                                              for i in (0, 2, 4, 6))],
                         ids=lambda p: p.name)
def test_oracle_bit_equal_under_eviction_pressure(policy, life):
    cl = EVICT._replace(lifecycle=LIVES[life])
    for seed in range(3):
        out = _both(policy, cl, _wl(EVICT, 1.1, n_functions=8,
                                    hot_fraction=0.4, seed=seed),
                    telemetry=TEL)
        assert out.telemetry.n_evict > 0 or life == "NONE"


@pytest.mark.parametrize("fleet", ["two-gen", "TARGET_P99"])
@pytest.mark.parametrize("policy", [HERMES, E_LL_PS, E_SWARM_PS, E_DD_PS],
                         ids=lambda p: p.name)
def test_oracle_bit_equal_under_a_fleet(policy, fleet):
    cl = CLUSTER._replace(fleet=TWO_GEN if fleet == "two-gen" else AUTO)
    out = _both(policy, cl, _wl(CLUSTER, 0.8, n=300, seed=3), telemetry=TEL)
    full = out.end_time * cl.n_workers * cl.cores
    if fleet == "two-gen":
        assert out.prov_core_s == full
    else:
        assert 0.0 < out.prov_core_s < full      # it scaled down


@pytest.mark.parametrize("case", ["E/H/PS mode flips", "E/LL/PS auto",
                                  "L/LL/FCFS", "E/DD/PS budget"])
def test_oracle_bit_equal_with_a_timeline(case):
    policy, cl = {
        "E/H/PS mode flips": (HERMES, CLUSTER),
        "E/LL/PS auto": (E_LL_PS, CLUSTER._replace(fleet=AUTO)),
        "L/LL/FCFS": (LATE_BINDING, CLUSTER),
        "E/DD/PS budget": (E_DD_PS, CLUSTER._replace(
            lifecycle=LifecycleCfg("HYBRID_HIST", 2.0, 2, "paper-sim"),
            fleet=AUTO))}[case]
    for load, seed in ((0.6, 0), (1.0, 1)):
        out = _both(policy, cl, _wl(cl, load, n=240, seed=seed),
                    telemetry=TEL, timeline=TL)
        assert int(out.timeline.arrivals.sum()) == 240
    if case == "E/H/PS mode flips":
        assert int(out.timeline.ev_count) > 0


@pytest.mark.parametrize("chunk", [40, 96])
@pytest.mark.parametrize("policy,cluster", [
    (E_LL_PS, CLUSTER), (HERMES, CLUSTER),
    (E_DD_PS, CLUSTER._replace(
        lifecycle=LifecycleCfg("HYBRID_HIST", 2.0, 3, "paper-sim"),
        fleet=AUTO))], ids=["E/LL/PS", "E/H/PS", "E/DD/PS|ka|auto"])
def test_chunk_snapshots_bit_equal(policy, cluster, chunk):
    wl = _wl(cluster, 0.9, n=240, seed=4)
    got, snaps = simulate_ref_chunks(policy, cluster, wl, chunk_size=chunk,
                                     telemetry=TEL)
    jcl, jwl, kw = _ref_args(cluster, wl, TEL, None)
    want, ref_snaps = ref_oracle.simulate_ref_chunks(
        rc.parse_policy(policy.name), jcl, jwl, chunk_size=chunk,
        telemetry=kw["telemetry"])
    _same_value(got, want, policy.name)
    assert len(snaps) == len(ref_snaps) == -(-wl.n // chunk)
    for c, (a, b) in enumerate(zip(snaps, ref_snaps)):
        assert sorted(a) == sorted(b)
        for k in b:
            _same_value(a[k], b[k], f"chunk {c} {k}")
    # the last snapshot is taken before the drain: fewer completions
    assert int(snaps[-1]["slow_hist"].sum()) <= \
        int(got.telemetry.slow_hist.sum())
    # without telemetry the hook sees None
    _, none = simulate_ref_chunks(policy, cluster._replace(fleet=None), wl,
                                  chunk_size=chunk)
    assert none == [None] * len(snaps)


def test_named_errors_match_the_reference():
    cl = CLUSTER._replace(fleet=AUTO)
    wl = _wl(CLUSTER, 0.5, n=100)
    jcl, jwl, _ = _ref_args(cl, wl, None, None)
    for policy, tel, match in ((LATE_BINDING, TEL, "requires early binding"),
                               (HERMES, None, "telemetry")):
        with pytest.raises(ValueError, match=match) as mine:
            simulate_ref(policy, cl, wl, telemetry=tel)
        with pytest.raises(ValueError, match=match) as theirs:
            ref_oracle.simulate_ref(
                rc.parse_policy(policy.name), jcl, jwl,
                telemetry=None if tel is None else rt.TelemetryCfg())
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown load balancer"):
        simulate_ref("E/NOPE/PS", CLUSTER, wl)
    with pytest.raises(ValueError, match="n_windows"):
        simulate_ref(HERMES, CLUSTER, wl, timeline=TimelineCfg(n_windows=0))


def test_policy_text_and_spec_agree():
    wl = _wl(CLUSTER, 0.9, seed=2)
    a = simulate_ref("E/HIKU/PS", CLUSTER, wl)
    b = simulate_ref(parse_policy("E/HIKU/PS"), CLUSTER, wl)
    _same_value(a, b, "E/HIKU/PS")
