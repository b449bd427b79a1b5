"""The port's streaming engine (``repro_torch.core.streaming``) against the
reference's ``simulate_stream`` (``backend="jax"``) on the CPU.

fig14's equivalence shape (``benchmarks/fig14_stream.py``: 4 × 3 cores,
capacity 2, N = 240, loads and seeds (0.6, 0) and (1.0, 1), R = 2) for
E/H/PS, E/HIKU/PS, E/LL/PS under HYBRID_HIST, the full DD + HYBRID_HIST +
``two-gen`` + ``TARGET_P99`` stack and E/LL/SRPT (the batched engine's
stream), at chunks 96 (which does not divide 240) and 80: the counters and
every integer plane equal (the collected per-arrival planes, the sketches'
bins, the slot matrices, the warm pools, the balancer's, life and fleet
state), the means, clocks, integrals and the rest of the float carry
within 1e-6 (ROADMAP Queue 3's FMA divergence).  For two stacks the carry
is held to JAX's at every chunk boundary.  The refusals (late binding,
``chunk_size < 1``) carry the reference's messages, and one built chunk
program serves two horizons.  The timeline rides the carry: for fig15's
three early-binding parity stacks (``fig15_timeline.py:104-116``) the
stream's ``TimelineResult`` (chunk 96) is the monolithic run's, bit for
bit.  Where JAX is not installed, the reference-side tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_LL_PS, HERMES,
                              LATE_BINDING, ClusterCfg, FleetCfg,
                              LifecycleCfg, parse_policy, stack_workloads,
                              synth_workload)
from repro_torch.core.simulator import simulate_many
from repro_torch.core.streaming import (clear_stream_cache,
                                        final_states_equal,
                                        monolithic_state, simulate_stream,
                                        stream_cache_stats)
from repro_torch.telemetry import N_BINS, TelemetryCfg, TimelineCfg

try:
    import jax

    import repro.core as rc
    import repro.fleet as rf
    import repro.lifecycle as rl
    from repro.core.streaming import simulate_stream as jax_simulate_stream
    from repro.telemetry import TelemetryCfg as JaxTelemetryCfg
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

EQ = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
EQ_N = 240
EQ_LOADS = ((0.6, 0), (1.0, 1))
FULL = EQ._replace(
    lifecycle=LifecycleCfg(keepalive="HYBRID_HIST", ttl_s=2.0, max_idle=3,
                           coldstart="paper-sim"),
    fleet=FleetCfg(preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                   target_p99=4.0, cooldown_s=2.0))
STACKS = {
    "E/H/PS": (HERMES, EQ),
    "E/HIKU/PS": (E_HIKU_PS, EQ),
    "E/LL/PS|ka=HYBRID_HIST": (E_LL_PS, EQ._replace(
        lifecycle=LifecycleCfg(keepalive="HYBRID_HIST"))),
    "E/DD/PS|ka=HYBRID_HIST|fleet|auto": (E_DD_PS, FULL),
    "E/LL/SRPT": (parse_policy("E/LL/SRPT"), EQ),
}
CHUNKS = (96, 80)
TEL_INT = ("slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict",
           "n_reject", "decisions")
TEL_F64 = ("busy_time", "depth_time", "qlen_time")
TOL = dict(rtol=1e-6, atol=1e-6)
PAR_TL = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
#: fig15's early-binding parity stacks
PARITY = {
    "E/LL/PS": (E_LL_PS, EQ),
    "E/H/PS|mode-flips": (HERMES, EQ),
    "E/LL/PS|fleet|auto": (E_LL_PS, EQ._replace(fleet=FleetCfg(
        preset="two-gen", autoscale="TARGET_P99", min_workers=2,
        target_p99=4.0, cooldown_s=2.0))),
}
TL_PLANES = ("window_s", "mode", "arrivals", "n_cold", "n_warm", "n_evict",
             "n_reject", "slow_hist", "lat_hist", "busy_time", "qlen_time",
             "prov_core", "n_on", "ev_t", "ev_kind", "ev_val", "ev_p99",
             "ev_count")


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _batch(cluster):
    return stack_workloads(synth_workload(cluster, load, EQ_N, n_functions=5,
                                          seed=seed)
                           for load, seed in EQ_LOADS)


def _jax_cluster(cluster):
    life, fl = cluster.lifecycle, cluster.fleet
    return rc.ClusterCfg(
        *cluster[:4], lifecycle=None if life is None
        else rl.LifecycleCfg(*life), fleet=None if fl is None
        else rf.FleetCfg(*fl))


def _jax_stream(policy, cluster, chunk, **kw):
    jcl = _jax_cluster(cluster)
    return jax_simulate_stream(
        rc.parse_policy(policy.name), jcl,
        [rc.synth_workload(jcl, load, EQ_N, n_functions=5, seed=seed)
         for load, seed in EQ_LOADS],
        chunk_size=chunk, backend="jax", telemetry=JaxTelemetryCfg(), **kw)


def _jax_carry(st) -> dict:
    """The reference's carry under the port's keys, numpy."""
    out = {}
    for name in st._fields:
        v = getattr(st, name)
        if isinstance(v, dict):
            for k, x in v.items():
                if isinstance(x, dict):          # the keep-alive's state
                    out.update({f"{name}_{kk}": np.asarray(xx)
                                for kk, xx in x.items()})
                else:
                    out[f"{name}_{k}"] = np.asarray(x)
        elif not isinstance(v, tuple):
            out[name] = np.asarray(v)
    return {k.replace("life_ka_", "life_"): v for k, v in out.items()}


def _port_carry(st: dict) -> dict:
    """The port's carry, numpy, the histograms' dropped bin sliced off."""
    out = {k: v.cpu().numpy() for k, v in st.items()}
    for k in ("tel_slow_hist", "tel_lat_hist"):
        out[k] = out[k][:, :N_BINS]
    return out


def _assert_carry_close(ours: dict, theirs: dict, what: str):
    shared = sorted(set(ours) & set(theirs))
    assert {"remaining", "task_idx", "warm", "now", "tel_slow_hist",
            "task_fn", "stream_n_done"} <= set(shared), shared
    for k in shared:
        a, b = ours[k], theirs[k]
        assert a.shape == b.shape, (what, k)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, equal_nan=True, err_msg=k,
                                       **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda k: f"k{k}")
@pytest.mark.parametrize("stack", STACKS)
def test_stream_matches_jax(reference, stack, chunk):
    policy, cluster = STACKS[stack]
    ours = simulate_stream(policy, cluster, _batch(cluster), chunk_size=chunk,
                           device="cpu", collect_outputs=True,
                           keep_final_state=True)
    theirs = _jax_stream(policy, cluster, chunk, collect_outputs=True,
                         keep_final_state=True)
    assert ours.n_chunks == theirs.n_chunks == -(-EQ_N // chunk)
    np.testing.assert_array_equal(ours.n_done, theirs.n_done)
    np.testing.assert_array_equal(ours.n_observed, theirs.n_observed)
    for f in ("resp_mean", "slow_mean", "server_time", "core_time",
              "end_time", "prov_core_s"):
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f),
                                   err_msg=f, **TOL)
    for f in ("cold", "rejected", "worker"):
        np.testing.assert_array_equal(getattr(ours, f),
                                      np.asarray(getattr(theirs, f)),
                                      err_msg=f)
    for f in TEL_INT:
        np.testing.assert_array_equal(getattr(ours.telemetry, f),
                                      getattr(theirs.telemetry, f),
                                      err_msg=f)
    for f in TEL_F64:
        np.testing.assert_allclose(getattr(ours.telemetry, f),
                                   getattr(theirs.telemetry, f), err_msg=f,
                                   **TOL)
    assert int(ours.n_done.sum()) > 0 and (ours.slow_mean >= 1.0).all()
    _assert_carry_close(_port_carry(ours.final_state),
                        _jax_carry(theirs.final_state), stack)


@pytest.mark.parametrize("stack", ["E/H/PS",
                                   "E/DD/PS|ka=HYBRID_HIST|fleet|auto"])
def test_carry_matches_jax_at_every_boundary(reference, stack):
    policy, cluster = STACKS[stack]
    ours, theirs = [], []
    simulate_stream(policy, cluster, _batch(cluster), chunk_size=96,
                    device="cpu", chunk_callback=lambda c, st: ours.append(
                        _port_carry(st)))
    _jax_stream(policy, cluster, 96, chunk_callback=lambda c, st: theirs.append(
        _jax_carry(jax.tree_util.tree_map(np.copy, st))))
    assert len(ours) == len(theirs) == 3
    for c, (a, b) in enumerate(zip(ours, theirs)):
        _assert_carry_close(a, b, f"{stack}, after chunk {c}")


def test_late_binding_and_a_bad_chunk_are_refused():
    wb = _batch(EQ)
    with pytest.raises(ValueError, match="early binding"):
        simulate_stream(LATE_BINDING, EQ, wb, chunk_size=16, device="cpu")
    with pytest.raises(ValueError, match="early binding"):
        simulate_stream("L/LL/FCFS", EQ, wb, chunk_size=16, device="cpu")
    for bad in (0, -3):
        with pytest.raises(ValueError, match="chunk_size must be >= 1"):
            simulate_stream(E_LL_PS, EQ, wb, chunk_size=bad, device="cpu")


def test_refusals_carry_the_reference_messages(reference):
    wb = _batch(EQ)
    jcl = _jax_cluster(EQ)
    jwl = [rc.synth_workload(jcl, 0.6, 50, n_functions=5, seed=0)]
    for (theirs, ours), chunk in (((rc.LATE_BINDING, LATE_BINDING), 16),
                                  ((rc.E_LL_PS, E_LL_PS), 0)):
        with pytest.raises(ValueError) as want:
            jax_simulate_stream(theirs, jcl, jwl, chunk_size=chunk,
                                backend="jax", telemetry=JaxTelemetryCfg())
        with pytest.raises(ValueError) as got:
            simulate_stream(ours, EQ, wb, chunk_size=chunk, device="cpu")
        assert str(got.value) == str(want.value)


def test_one_chunk_program_serves_two_horizons():
    clear_stream_cache()
    short = synth_workload(EQ, 0.7, 64, n_functions=5, seed=0)
    long = synth_workload(EQ, 0.7, 200, n_functions=5, seed=0)
    a = simulate_stream(E_LL_PS, EQ, short, chunk_size=32, device="cpu")
    assert stream_cache_stats()["misses"] == 1
    b = simulate_stream(E_LL_PS, EQ, long, chunk_size=32, device="cpu")
    stats = stream_cache_stats()
    assert (stats["entries"], stats["hits"], stats["misses"]) == (1, 1, 1)
    assert (a.n_chunks, b.n_chunks) == (2, 7)
    assert (int(a.n_done[0]), int(b.n_done[0])) == (64, 200)
    simulate_stream(E_LL_PS, EQ, long, chunk_size=64, device="cpu")
    assert stream_cache_stats()["entries"] == 2


def test_outputs_are_host_arrays_of_the_horizon():
    wb = _batch(EQ)
    out = simulate_stream(E_LL_PS, EQ, wb, chunk_size=100, device="cpu")
    assert out.cold is None and out.final_state is None
    assert out.n_reps == 2 and out.n_arrivals == EQ_N
    assert out.telemetry.slow_hist.shape == (2, N_BINS)
    assert isinstance(out.resp_mean, np.ndarray)
    assert out.resp_mean.dtype == np.float64
    # no plane of the horizon's length in the carry
    kept = simulate_stream(E_LL_PS, EQ, wb, chunk_size=100, device="cpu",
                           keep_final_state=True).final_state
    assert all(EQ_N not in v.shape for v in kept.values()), \
        {k: tuple(v.shape) for k, v in kept.items()}
    assert isinstance(kept["remaining"], torch.Tensor)


@pytest.mark.parametrize("stack", PARITY)
def test_timeline_rides_the_carry(stack):
    policy, cluster = PARITY[stack]
    wb = _batch(cluster)
    tel = TelemetryCfg()
    mono = simulate_many(policy, cluster, wb, device="cpu", telemetry=tel,
                         timeline=PAR_TL)
    out = simulate_stream(policy, cluster, wb, chunk_size=96, device="cpu",
                          timeline=PAR_TL, keep_final_state=True)
    for f in TL_PLANES:
        a, b = np.asarray(getattr(out.timeline, f)), \
            np.asarray(getattr(mono.timeline, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    state = monolithic_state(policy, cluster, wb, device="cpu",
                             telemetry=tel, timeline=PAR_TL)
    ok, bad = final_states_equal(out.final_state, state)
    assert ok, bad
    assert int(out.timeline.arrivals.sum()) == 2 * EQ_N
    if stack.startswith("E/H"):
        assert int(out.timeline.ev_count.sum()) > 0
    if stack.endswith("auto"):
        assert int(out.timeline.ev_count.min()) > 0
