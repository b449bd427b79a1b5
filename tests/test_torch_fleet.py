"""``repro_torch.fleet`` against ``repro.fleet`` on the CPU.

* Presets and speeds bit-equal to the reference's; ``resolve_fleet``;
  ``fleet_from_flags``; the registry's contract; the named errors of
  ``ClusterCfg.validate``.
* ``TARGET_P99``'s decide: MIAD semantics, and the port's numpy and torch
  decides equal to the reference's ``np`` and ``jax`` ones on random
  windows, a window of one completion, all mass in the first or the last
  bin, and empty windows.
* The engines: a ``uniform`` fleet bit-identical to no fleet (the batched
  engine and ``sim_engine_ref``); heterogeneous runs (``two-gen``,
  ``long-tail``, an explicit vector) for H, LL, SWARM, DD and late
  binding against JAX's ``simulate_many`` (integer planes equal, floats
  within 1e-6); SWARM learning the speed skew; ``TARGET_P99`` against
  JAX with ``prov_core_s`` within 1e-9; the two named errors; a custom
  autoscaler registered on both sides, end to end.

Where JAX is not installed, the reference-side tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (E_DD_PS, E_LL_PS, E_SWARM_PS, HERMES,
                              LATE_BINDING, ClusterCfg, FleetCfg,
                              stack_workloads, synth_workload)
from repro_torch.core.simulator import simulate, simulate_many
from repro_torch.fleet import (BUILTIN_PRESETS, fleet_from_flags,
                               get_autoscaler, is_builtin, parse_autoscale,
                               parse_fleet_preset, preset_is_builtin,
                               register_autoscaler, register_fleet_preset,
                               resolve_fleet, speeds_for,
                               unregister_autoscaler)
from repro_torch.fleet.config import FLEET_PRESETS
from repro_torch.fleet.registry import AUTOSCALERS
from repro_torch.kernels.sim_engine import ops
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.telemetry import N_BINS, TelemetryCfg, hist_edges

try:
    import repro.core as rc
    import repro.fleet as rf
    from repro.core.simulator import simulate_many as jax_simulate_many
    from repro.telemetry import TelemetryCfg as JaxTelemetryCfg
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

CLUSTER = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                     cold_start_penalty=0.25)
N = 300
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _fleet(preset="two-gen", **kw):
    return CLUSTER._replace(fleet=FleetCfg(preset=preset, **kw))


def _auto_cluster(**kw):
    base = dict(preset="uniform", autoscale="TARGET_P99", target_p99=4.0,
                min_workers=1, cooldown_s=1.0)
    base.update(kw)
    return CLUSTER._replace(fleet=FleetCfg(**base))


def _workloads(cluster, loads, seed=7):
    return stack_workloads(synth_workload(cluster, load, N, n_functions=5,
                                          hot_fraction=0.8, seed=seed)
                           for load in loads)


def _jax(policy, cluster, loads, seed=7, telemetry=False):
    fl = cluster.fleet
    jcl = rc.ClusterCfg(*cluster[:4],
                        fleet=None if fl is None else rf.FleetCfg(*fl))
    return jax_simulate_many(
        rc.parse_policy(policy.name), jcl,
        [rc.synth_workload(jcl, load, N, n_functions=5, hot_fraction=0.8,
                           seed=seed) for load in loads],
        telemetry=JaxTelemetryCfg() if telemetry else None)


def _assert_close_to_jax(out, ref):
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(getattr(out, plane),
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(out.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time"):
        np.testing.assert_allclose(getattr(out, plane), getattr(ref, plane),
                                   **TOL, err_msg=plane)
    np.testing.assert_allclose(out.prov_core_s, ref.prov_core_s, rtol=1e-9)


def _inputs(wb):
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


# -- presets, registry, config ----------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 5, 8, 100])
@pytest.mark.parametrize("preset", ["uniform", "two-gen", "long-tail"])
def test_presets_bit_equal(reference, preset, W):
    ours = speeds_for(FleetCfg(preset=preset), W)
    theirs = rf.speeds_for(rf.FleetCfg(preset=preset), W)
    assert ours.dtype == np.float64 and ours.tobytes() == theirs.tobytes()
    assert rf.mem_for(rf.FleetCfg(), W).tobytes() == \
        resolve_fleet(ClusterCfg(n_workers=W, fleet=FleetCfg(
            preset=preset))).mem.tobytes()


def test_fleet_presets_and_resolve():
    assert parse_fleet_preset("TWO-GEN") == "two-gen"
    np.testing.assert_array_equal(
        speeds_for(FleetCfg(preset="two-gen"), 5), [1.0, 1.0, 1.0, 0.5, 0.5])
    tail = speeds_for(FleetCfg(preset="long-tail"), 4)
    assert tail[0] == 1.0 and np.all(np.diff(tail) < 0) and tail[-1] > 0
    assert resolve_fleet(CLUSTER) is None
    res = resolve_fleet(_fleet("two-gen"), backend="np")
    assert not res.auto_on and not res.uniform and res.speeds.shape == (4,)
    assert resolve_fleet(_fleet("uniform"), backend="torch").uniform
    res = resolve_fleet(_auto_cluster(), backend="torch", device="cpu")
    assert res.auto_on and callable(res.decide)
    assert get_autoscaler("STATIC").needs_telemetry is False
    assert get_autoscaler("TARGET_P99").needs_telemetry is True
    with pytest.raises(ValueError, match="unknown fleet backend"):
        resolve_fleet(_fleet(), backend="jax")
    with pytest.raises(ValueError, match="speed has 2 entries"):
        speeds_for(FleetCfg(speed=(1.0, 0.5)), 4)


def test_registry_contract():
    with pytest.raises(ValueError, match="invalid autoscale policy name"):
        register_autoscaler("A/B", make_np=lambda c, w: None)
    with pytest.raises(ValueError, match="needs an np or torch backend"):
        register_autoscaler("EMPTY")
    with pytest.raises(ValueError, match="already registered"):
        register_autoscaler("TARGET_P99", make_np=lambda c, w: None)
    with pytest.raises(ValueError, match="unknown autoscale policy"):
        parse_autoscale("magic")
    assert is_builtin("target_p99") and is_builtin("STATIC")
    original = get_autoscaler("STATIC")
    register_autoscaler("STATIC", make_torch=original.make_torch,
                        needs_telemetry=False, overwrite=True)
    try:
        assert not is_builtin("STATIC")     # a user's record now
    finally:
        AUTOSCALERS["STATIC"] = original
    assert is_builtin("STATIC")
    register_autoscaler("ONLY_NP", make_np=lambda c, w: None)
    try:
        with pytest.raises(ValueError, match="has no torch backend"):
            resolve_fleet(_auto_cluster(autoscale="ONLY_NP"),
                          backend="torch")
    finally:
        unregister_autoscaler("ONLY_NP")
    assert preset_is_builtin(FleetCfg(preset="long-tail"))
    assert preset_is_builtin(FleetCfg(preset="nope", speed=(1.0,)))
    assert set(BUILTIN_PRESETS) == {"uniform", "two-gen", "long-tail"}


def test_cluster_validate_named_errors():
    wl = synth_workload(CLUSTER, 0.5, 50, seed=0)
    with pytest.raises(ValueError, match="n_workers must be positive"):
        ClusterCfg(n_workers=0).validate()
    with pytest.raises(ValueError, match="cores must be positive"):
        ClusterCfg(cores=0).validate()
    with pytest.raises(ValueError, match="capacity_factor must be"):
        ClusterCfg(capacity_factor=-1).validate()
    with pytest.raises(ValueError,
                       match="speed has 2 entries for n_workers=4"):
        CLUSTER._replace(fleet=FleetCfg(speed=(1.0, 0.5))).validate()
    with pytest.raises(ValueError, match="entries must be positive"):
        CLUSTER._replace(
            fleet=FleetCfg(speed=(1.0, 0.0, 1.0, 1.0))).validate()
    with pytest.raises(ValueError, match="mem has 1 entries"):
        CLUSTER._replace(fleet=FleetCfg(mem=(1.0,))).validate()
    with pytest.raises(ValueError, match="min_workers must be in"):
        CLUSTER._replace(fleet=FleetCfg(min_workers=9)).validate()
    with pytest.raises(ValueError, match="unknown fleet preset"):
        CLUSTER._replace(fleet=FleetCfg(preset="turbo")).validate()
    with pytest.raises(ValueError, match="unknown autoscale policy"):
        CLUSTER._replace(fleet=FleetCfg(autoscale="MAGIC")).validate()
    bad = CLUSTER._replace(fleet=FleetCfg(speed=(1.0, 0.5)))
    with pytest.raises(ValueError, match="speed has 2 entries"):
        simulate(HERMES, bad, wl, device="cpu")
    # an explicit vector needs no preset name
    CLUSTER._replace(fleet=FleetCfg(preset="turbo",
                                    speed=(1.0,) * 4)).validate()


def test_fleet_from_flags_cli_semantics():
    assert fleet_from_flags() is None
    assert fleet_from_flags(preset="two-gen") == FleetCfg(preset="two-gen")
    assert fleet_from_flags(speed=[1.0, 0.5]).speed == (1.0, 0.5)
    fl = fleet_from_flags(autoscale="target_p99", target_p99=3.0,
                          min_workers=2, cooldown_s=2.0)
    assert fl.preset == "uniform" and fl.autoscale == "TARGET_P99"
    assert (fl.target_p99, fl.min_workers, fl.cooldown_s) == (3.0, 2, 2.0)
    with pytest.raises(ValueError, match="unknown fleet preset"):
        fleet_from_flags(preset="NOPE")
    with pytest.raises(ValueError, match="unknown autoscale policy"):
        fleet_from_flags(autoscale="NOPE")


def test_fleet_from_flags_matches_reference(reference):
    for kw in ({}, {"preset": "long-tail"}, {"speed": [1.0, 2.0]},
               {"autoscale": "TARGET_P99", "target_p99": 2.5,
                "min_workers": 3, "cooldown_s": 5.0, "hysteresis": 0.2}):
        ours, theirs = fleet_from_flags(**kw), rf.fleet_from_flags(**kw)
        assert (ours is None and theirs is None) or \
            tuple(ours) == tuple(theirs)


# -- TARGET_P99's decide ------------------------------------------------------

def _window_at(value, count=100):
    w = np.zeros(N_BINS, dtype=np.int64)
    w[int(np.searchsorted(hist_edges(), value, side="right")) - 1] = count
    return w


def test_target_p99_miad_semantics():
    cfg = FleetCfg(autoscale="TARGET_P99", target_p99=4.0, min_workers=2,
                   hysteresis=0.1)
    pol = get_autoscaler("TARGET_P99")
    d_np = pol.make_np(cfg, 8)
    d_t = pol.make_torch(cfg, 8, "cpu")

    def both(n_on, window):
        got = int(d_t(torch.tensor([n_on], dtype=torch.int32),
                      torch.tensor(window[None]))[0])
        assert got == d_np(n_on, window)
        return got

    hot, cold, mid = _window_at(50.0), _window_at(1.0), _window_at(2.0)
    assert both(4, hot) == 6
    assert both(1, hot) == 2
    assert both(7, hot) == 8
    assert both(8, hot) == 8
    assert both(6, cold) == 5
    assert both(2, cold) == 2
    assert both(5, mid) == 5
    assert both(5, np.zeros_like(hot)) == 5


def _windows(rng):
    yield np.zeros(N_BINS, dtype=np.int64)
    for b in (0, N_BINS - 1, 700):
        one = np.zeros(N_BINS, dtype=np.int64)
        one[b] = 1                              # total = 1
        yield one
        yield one * 57
    for _ in range(60):
        w = np.zeros(N_BINS, dtype=np.int64)
        idx = rng.integers(0, N_BINS, size=rng.integers(1, 8))
        w[idx] = rng.integers(1, 60, size=idx.size)
        yield w


@pytest.mark.parametrize("cfg", [
    dict(target_p99=3.0, min_workers=1, hysteresis=0.15),
    dict(target_p99=4.0, min_workers=2, hysteresis=0.1),
    dict(target_p99=1e-3, min_workers=3, hysteresis=0.0)],
    ids=["t3", "t4", "tiny"])
def test_decide_parity_with_reference(reference, cfg):
    import jax.numpy as jnp
    W = 7
    ours_cfg = FleetCfg(autoscale="TARGET_P99", **cfg)
    theirs_cfg = rf.FleetCfg(autoscale="TARGET_P99", **cfg)
    pol, jpol = get_autoscaler("TARGET_P99"), rf.get_autoscaler("TARGET_P99")
    d_np, d_t = pol.make_np(ours_cfg, W), pol.make_torch(ours_cfg, W, "cpu")
    r_np, r_jax = jpol.make_np(theirs_cfg, W), jpol.make_jax(theirs_cfg, W)
    rng = np.random.default_rng(0)
    windows = list(_windows(rng))
    n_ons = rng.integers(cfg["min_workers"], W + 1, len(windows))
    batched = d_t(torch.tensor(n_ons, dtype=torch.int32),
                  torch.tensor(np.stack(windows)))
    assert batched.dtype == torch.int32
    for w, n_on, got_t in zip(windows, n_ons, batched.tolist()):
        want = r_np(int(n_on), w)
        assert d_np(int(n_on), w) == want
        assert got_t == want
        assert int(r_jax(jnp.asarray(n_on, dtype=jnp.int32),
                         jnp.asarray(w))) == want


# -- the engines -------------------------------------------------------------

@pytest.mark.parametrize("policy", [HERMES, E_SWARM_PS],
                         ids=lambda p: p.name)
def test_uniform_fleet_bitwise_homogeneous(policy):
    wb = _workloads(CLUSTER, (0.9, 1.3))
    uni = _fleet("uniform")
    base = simulate_many(policy, CLUSTER, wb, device="cpu")
    out = simulate_many(policy, uni, wb, device="cpu")
    for plane in ("response", "worker", "cold", "server_time", "core_time"):
        assert getattr(base, plane).tobytes() == getattr(out, plane).tobytes()
    ref_base = sim_engine_ref(policy.balance, CLUSTER, *_inputs(wb))
    ref_uni = sim_engine_ref(policy.balance, uni, *_inputs(wb))
    for key in ("resp", "worker_of", "cold", "server_time", "now"):
        assert ref_base[key].numpy().tobytes() == \
            ref_uni[key].numpy().tobytes(), key


def test_heterogeneity_changes_results():
    wb = _workloads(CLUSTER, (0.9,))
    base = simulate_many(HERMES, CLUSTER, wb, device="cpu")
    slow = simulate_many(HERMES, _fleet("two-gen"), wb, device="cpu")
    assert float(np.nansum(slow.response)) > float(np.nansum(base.response))


@pytest.mark.parametrize("preset", ["two-gen", "long-tail"])
@pytest.mark.parametrize("policy",
                         [HERMES, E_LL_PS, E_SWARM_PS, E_DD_PS, LATE_BINDING],
                         ids=lambda p: p.name)
def test_heterogeneous_engine_matches_jax(reference, policy, preset):
    cl = _fleet(preset)
    loads = (0.5, 0.9)
    out = simulate_many(policy, cl, _workloads(cl, loads, seed=1),
                        device="cpu")
    _assert_close_to_jax(out, _jax(policy, cl, loads, seed=1))


def test_explicit_speed_vector_matches_jax(reference):
    cl = CLUSTER._replace(fleet=FleetCfg(speed=(1.0, 1.0, 1.0, 0.125)))
    loads = (0.9,)
    out = simulate_many(HERMES, cl, _workloads(cl, loads), device="cpu")
    _assert_close_to_jax(out, _jax(HERMES, cl, loads))
    base = simulate_many(HERMES, CLUSTER, _workloads(CLUSTER, loads),
                         device="cpu")
    assert float(np.nansum(out.response)) > float(np.nansum(base.response))


def test_swarm_learns_speed_skew():
    cl = _fleet("two-gen")
    wl = synth_workload(CLUSTER, 0.9, 600, n_functions=5, hot_fraction=0.8,
                        seed=11)
    out = simulate(E_SWARM_PS, cl, wl, device="cpu")
    placed = out.worker[out.worker >= 0]
    assert int((placed < 2).sum()) > int((placed >= 2).sum())
    ll = simulate(E_LL_PS, cl, wl, device="cpu")
    assert np.nanpercentile(out.response, 99) <= \
        np.nanpercentile(ll.response, 99) * 1.05


@pytest.mark.parametrize("policy", [HERMES, E_LL_PS, E_SWARM_PS],
                         ids=lambda p: p.name)
def test_autoscale_matches_jax(reference, policy):
    cl = _auto_cluster()
    loads = (0.7, 0.4)
    out = simulate_many(policy, cl, _workloads(cl, loads, seed=3),
                        device="cpu", telemetry=TelemetryCfg())
    ref = _jax(policy, cl, loads, seed=3, telemetry=True)
    _assert_close_to_jax(out, ref)
    for f in ("slow_hist", "lat_hist", "n_cold", "n_warm", "decisions"):
        np.testing.assert_array_equal(getattr(out.telemetry, f),
                                      getattr(ref.telemetry, f), err_msg=f)
    static = out.end_time * CLUSTER.n_workers * CLUSTER.cores
    assert np.all(out.prov_core_s > 0) and np.any(out.prov_core_s < static)
    assert out.fleet["n_on"].shape == (2,) and \
        out.fleet["snap"].shape == (2, N_BINS)
    assert out.rep(1).fleet["prov_time"] * CLUSTER.cores == \
        out.prov_core_s[1]


def test_fixed_fleet_prov_core_s():
    wb = _workloads(CLUSTER, (0.9,))
    for cl in (CLUSTER, _fleet("two-gen")):
        out = simulate_many(HERMES, cl, wb, device="cpu")
        assert out.fleet is None
        assert out.prov_core_s[0] == \
            out.end_time[0] * CLUSTER.n_workers * CLUSTER.cores


def test_autoscale_requires_early_binding_and_telemetry():
    wb = _workloads(CLUSTER, (0.5,))
    cl = _auto_cluster()
    with pytest.raises(ValueError, match="requires early binding"):
        simulate_many(LATE_BINDING, cl, wb, device="cpu",
                      telemetry=TelemetryCfg())
    with pytest.raises(ValueError, match="telemetry"):
        simulate_many(HERMES, cl, wb, device="cpu")
    # on the card's route too, before any launch
    with pytest.raises(ValueError, match="telemetry"):
        simulate_many(HERMES, cl, wb, device="cpu", backend="kernel")
    with pytest.raises(ValueError, match="telemetry"):
        ops.sim_engine("H", cl, *_inputs(wb))
    # a fixed fleet needs neither
    simulate_many(LATE_BINDING, _fleet("two-gen"), wb, device="cpu")


def test_custom_autoscaler_end_to_end(reference):
    """A fixed-step controller registered on both sides drives both
    engines alike; on the card it takes the batched engine."""
    import jax.numpy as jnp
    from repro_torch.policy import engine

    def make_torch(cfg, n_workers, device):
        def decide(n_on, window):
            return torch.clamp(n_on - 1, min=int(cfg.min_workers)).to(
                torch.int32)
        return decide

    def make_np(cfg, n_workers):
        return lambda n_on, window: max(int(cfg.min_workers), int(n_on) - 1)

    def make_jax(cfg, n_workers):
        def decide(n_on, window):
            return jnp.maximum(int(cfg.min_workers),
                               n_on.astype(jnp.int32) - 1).astype(jnp.int32)
        return decide

    register_autoscaler("SHED", make_np=make_np, make_torch=make_torch)
    rf.register_autoscaler("SHED", make_np=make_np, make_jax=make_jax)
    try:
        assert parse_autoscale("shed") == "SHED" and not is_builtin("SHED")
        cl = _auto_cluster(autoscale="SHED", min_workers=2)
        assert engine(HERMES, "cuda", "auto", cl) == "batched"
        loads = (0.5, 0.8)
        out = simulate_many(HERMES, cl, _workloads(cl, loads, seed=2),
                            device="cpu", telemetry=TelemetryCfg())
        _assert_close_to_jax(out, _jax(HERMES, cl, loads, seed=2,
                                       telemetry=True))
        assert np.all(out.prov_core_s <
                      out.end_time * CLUSTER.n_workers * CLUSTER.cores)
        assert out.worker.max() <= 3
        assert out.fleet["n_on"].tolist() == [2, 2]
    finally:
        unregister_autoscaler("SHED")
        rf.unregister_autoscaler("SHED")


def test_custom_preset_takes_the_batched_engine():
    from repro_torch.policy import engine
    register_fleet_preset("halves", lambda W: np.full(W, 0.5))
    try:
        cl = _fleet("halves")
        assert engine(HERMES, "cuda", "auto", cl) == "batched"
        assert engine(HERMES, "cuda", "auto", _fleet("two-gen")) == \
            "sim_engine"
        out = simulate_many(HERMES, cl, _workloads(cl, (0.5,)), device="cpu")
        assert np.isfinite(out.end_time).all()
    finally:
        FLEET_PRESETS.pop("halves")
