"""The life plane of the port's engines on the CPU.

* The batched engine (``backend="torch"``) against JAX's
  ``simulate_many`` under NONE, FIXED_TTL (with and without a
  ``max_idle`` budget, with a per-function cold-start preset) and
  HYBRID_HIST, for E/H/PS, E/LL/PS, E/LOC/PS, E/HIKU/PS (a carried-state
  balancer), E/H/FCFS and late binding, on an overloaded 4 × 3-core
  cluster at loads 0.5/0.9/1.3: integer planes equal, floats within
  rtol=atol=1e-6 (the known FMA divergence, ROADMAP Queue 3); and a
  custom keep-alive registered on both sides.
* The fused engine's plain version ``sim_engine_ref`` bit-equal to the
  batched engine in every plane and in the final life state (and
  balancer state), for all nine balancers under FIXED_TTL with
  ``max_idle = 2`` and an ``aws-lambda`` preset, under HYBRID_HIST with
  ``max_idle = 2``, and under NONE, at loads 1.3/3.0/6.0, where
  slot-pressure and budget evictions, stale pools and rejections occur.
* ``lifecycle=None`` leaves the engines as they were (``life`` is None;
  the other test files hold their planes); the reference's own
  expectations of how each lifecycle moves the cold starts.
* The route: a cluster beyond ``MAX_WORKERS``/``MAX_SLOTS`` and a custom
  keep-alive take the batched engine on ``cuda``; a built-in keep-alive
  takes ``sim_engine``; the three-argument calls keep their answers.

The last test holds the CUDA kernel against the batched engine under a
lifecycle and runs only where a card is present.  Where JAX is not
installed, the reference-side tests skip.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import NotPortedError
from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_LL_PS,
                              E_LOC_PS, E_R_PS, E_RR_PS, E_SWARM_PS, HERMES,
                              LATE_BINDING, ClusterCfg, LifecycleCfg,
                              WorkerSched, stack_workloads, synth_workload)
from repro_torch.core.simulator import (LoopStats, _build_engine,
                                        simulate_many)
from repro_torch.kernels.hermes_select import kernel as hermes_kernel
from repro_torch.kernels.sim_engine import kernel, ops
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.lifecycle import register_keepalive, unregister_keepalive
from repro_torch.policy import engine

try:
    import repro.core as rc
    import repro.lifecycle as rl
    from repro.core.simulator import simulate_many as jax_simulate_many
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

TINY = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                  cold_start_penalty=0.25)
N = 300
TOL = dict(rtol=1e-6, atol=1e-6)
#: id -> lifecycle of the JAX comparison
LIFECYCLES = {
    "none": LifecycleCfg("NONE", coldstart="openwhisk"),
    "ttl": LifecycleCfg("FIXED_TTL", ttl_s=3.0),
    "ttl-budget": LifecycleCfg("FIXED_TTL", ttl_s=3.0, max_idle=2,
                               coldstart="aws-lambda"),
    "hist-budget": LifecycleCfg("HYBRID_HIST", ttl_s=3.0, max_idle=2,
                                coldstart="openwhisk"),
}
#: id -> lifecycle of the fused engine's checks (ttl 2 s: stale pools,
#: budget and slot-pressure evictions all occur at loads 1.3-6.0)
FUSED_LIFECYCLES = {
    "ttl-budget": LifecycleCfg("FIXED_TTL", ttl_s=2.0, max_idle=2,
                               coldstart="aws-lambda"),
    "hist-budget": LifecycleCfg("HYBRID_HIST", ttl_s=2.0, max_idle=2),
    "none": LifecycleCfg("NONE"),
}
POLICIES = (HERMES, E_LL_PS, E_LOC_PS, E_HIKU_PS,
            HERMES._replace(sched=WorkerSched.FCFS), LATE_BINDING)
FUSED = (HERMES, E_LL_PS, E_LOC_PS, E_R_PS, E_JSQ2_PS, E_RR_PS, E_HIKU_PS,
         E_DD_PS, E_SWARM_PS)
PLANES = dict(response="resp", cold="cold", rejected="rejected",
              worker="worker_of", server_time="server_time",
              core_time="core_time", end_time="now")


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _workloads(cluster, loads, seed=1):
    return stack_workloads(synth_workload(cluster, load, N, n_functions=5,
                                          hot_fraction=0.8, seed=seed)
                           for load in loads)


def _jax(policy, cluster, loads, seed=1):
    jcl = rc.ClusterCfg(*cluster[:4], lifecycle=rl.LifecycleCfg(
        *cluster.lifecycle))
    return jax_simulate_many(
        rc.parse_policy(policy.name), jcl,
        [rc.synth_workload(jcl, load, N, n_functions=5, hot_fraction=0.8,
                           seed=seed) for load in loads])


def _assert_close_to_jax(out, ref):
    for plane in ("worker", "cold", "rejected"):
        np.testing.assert_array_equal(getattr(out, plane),
                                      getattr(ref, plane), err_msg=plane)
    np.testing.assert_allclose(np.nan_to_num(out.response, nan=-1.0),
                               np.nan_to_num(ref.response, nan=-1.0), **TOL)
    for plane in ("server_time", "core_time", "end_time"):
        np.testing.assert_allclose(getattr(out, plane), getattr(ref, plane),
                                   **TOL, err_msg=plane)


@pytest.mark.parametrize("life", LIFECYCLES)
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_batched_engine_matches_jax(reference, policy, life):
    cluster = TINY._replace(lifecycle=LIFECYCLES[life])
    loads = (0.5, 0.9, 1.3)
    out = simulate_many(policy, cluster, _workloads(cluster, loads),
                        device="cpu")
    _assert_close_to_jax(out, _jax(policy, cluster, loads))
    if life == "none" and policy != LATE_BINDING:
        # late binding dispatches a queued task at its completion's
        # instant, when the pool's age 0 lies inside NONE's window
        assert out.cold[~out.rejected].all()
    assert out.life["idle_since"].shape == (3, 4, 5)
    assert out.life["pre"].shape == out.life["keep"].shape == (3, 5)
    assert ("hist" in out.life) == (life == "hist-budget")


def test_custom_keepalive_matches_jax(reference):
    """A tiered TTL registered on both sides runs through the batched
    engine as through JAX's."""
    def make_torch(cfg, n_functions, device):
        even = torch.arange(n_functions, device=device) % 2 == 0
        keep = torch.where(even, 2.0 * cfg.ttl_s, 0.25 * cfg.ttl_s
                           ).to(torch.float64)
        pre = torch.zeros(n_functions, dtype=torch.float64, device=device)
        return (lambda state: (pre, keep)), None

    def make_np(cfg, n_functions):
        keep = np.where(np.arange(n_functions) % 2 == 0, 2.0 * cfg.ttl_s,
                        0.25 * cfg.ttl_s)
        pre = np.zeros(n_functions)
        return (lambda state: (pre, keep)), None

    def make_jax(cfg, n_functions):
        import jax.numpy as jnp
        keep = jnp.where(jnp.arange(n_functions) % 2 == 0, 2.0 * cfg.ttl_s,
                         0.25 * cfg.ttl_s)
        pre = jnp.zeros(n_functions)
        return (lambda state: (pre, keep)), None

    register_keepalive("TIERED", make_torch=make_torch)
    rl.register_keepalive("TIERED", make_np=make_np, make_jax=make_jax)
    try:
        cluster = TINY._replace(lifecycle=LifecycleCfg("TIERED", ttl_s=2.0))
        loads = (0.8, 1.3)
        wb = _workloads(cluster, loads, seed=5)
        out = simulate_many(HERMES, cluster, wb, device="cpu")
        _assert_close_to_jax(out, _jax(HERMES, cluster, loads, seed=5))
        even = wb.func % 2 == 0
        assert out.cold[even].mean() < out.cold[~even].mean()
    finally:
        unregister_keepalive("TIERED")
        rl.unregister_keepalive("TIERED")


def test_infinite_window_from_flags_matches_jax(reference):
    """A preset alone turns the lifecycle on with an infinite FIXED_TTL
    window (``lifecycle_from_flags``): the engines agree on it."""
    from repro_torch.lifecycle import lifecycle_from_flags
    cluster = TINY._replace(lifecycle=lifecycle_from_flags(
        coldstart="openwhisk"))
    loads = (0.8, 1.3)
    out = simulate_many(HERMES, cluster, _workloads(cluster, loads),
                        device="cpu")
    _assert_close_to_jax(out, _jax(HERMES, cluster, loads))
    assert (out.life["keep"] == np.inf).all()


def test_lifecycle_configs_change_results():
    """The reference's own expectations (tests/test_lifecycle.py) of the
    batched engine: a finite window and a budget add cold starts, NONE
    makes every arrival cold, HYBRID_HIST differs from FIXED_TTL, and a
    dearer preset lengthens the responses."""
    wb = _workloads(TINY, (0.9,), seed=7)

    def run(**kw):
        cl = TINY if not kw else TINY._replace(lifecycle=LifecycleCfg(**kw))
        return simulate_many(HERMES, cl, wb, device="cpu")
    base, ttl = run(), run(ttl_s=3.0)
    none, hyb = run(keepalive="NONE"), run(keepalive="HYBRID_HIST",
                                           ttl_s=3.0)
    assert int(ttl.cold.sum()) > int(base.cold.sum())
    assert int(none.cold.sum()) == wb.n
    assert int(hyb.cold.sum()) > int(base.cold.sum())
    assert not np.array_equal(ttl.cold, hyb.cold)
    assert int(run(ttl_s=50.0, max_idle=1).cold.sum()) > \
        int(run(ttl_s=50.0).cold.sum())
    cheap = run(ttl_s=2.0, coldstart="paper-sim")
    dear = run(ttl_s=2.0, coldstart="openwhisk")
    assert np.nansum(dear.response) > np.nansum(cheap.response)


def _inputs(wb, device="cpu"):
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


@functools.cache
def _fused_case(life):
    cluster = TINY._replace(lifecycle=FUSED_LIFECYCLES[life])
    return cluster, _workloads(cluster, (1.3, 3.0, 6.0))


@pytest.mark.parametrize("life", FUSED_LIFECYCLES)
@pytest.mark.parametrize("policy", FUSED, ids=lambda p: p.name)
def test_plain_version_matches_batched_engine(policy, life):
    cluster, wb = _fused_case(life)
    ref = sim_engine_ref(policy.balance, cluster, *_inputs(wb))
    # the batched engine's own state dict: its final life state too
    run = _build_engine(policy, cluster, wb.n, wb.n_functions, wb.n_reps,
                        torch.device("cpu"), "torch")
    a, f, s, u, h = _inputs(wb)
    st = run(a, f.long(), s, u, h, LoopStats())
    for key in PLANES.values():
        want = st[key][:, :wb.n] if st[key].dim() == 2 else st[key]
        assert ref[key].dtype == want.dtype, key
        np.testing.assert_array_equal(ref[key].numpy(), want.numpy(),
                                      err_msg=key)
    state = sorted(k for k in ref if k.startswith(("life_", "lb_")))
    assert state == sorted(k for k in st if k.startswith(("life_", "lb_")))
    for key in state:
        want = st[key][:, :, :wb.n_functions] if key == "life_idle_since" \
            else st[key]
        assert ref[key].dtype == want.dtype, key
        assert ref[key].numpy().tobytes() == \
            want.contiguous().numpy().tobytes(), key
    assert ref["rejected"].any()
    if life == "hist-budget":
        assert (ref["life_n_obs"] > 0).any() and \
            (ref["life_keep"] != 2.0).any()


def test_lifecycle_changes_the_fused_results():
    """The life plane is live in the plain version: a budget and a finite
    window add cold starts to the legacy model's, NONE makes every
    accepted arrival cold."""
    base = TINY._replace(lifecycle=None)
    wb = _workloads(base, (1.3, 3.0, 6.0))
    cold = {}
    lives = {"legacy": None, "long": LifecycleCfg("FIXED_TTL", ttl_s=1e6),
             "budget": LifecycleCfg("FIXED_TTL", ttl_s=1e6, max_idle=1),
             **FUSED_LIFECYCLES}
    for name, life in lives.items():
        out = sim_engine_ref("H", base._replace(lifecycle=life),
                             *_inputs(wb))
        cold[name] = int(out["cold"].sum())
        if name == "none":
            assert bool(out["cold"][~out["rejected"]].all())
        assert ("life_pre" in out) == (life is not None)
    assert cold["budget"] > cold["long"]
    assert cold["ttl-budget"] > cold["legacy"]


def test_lifecycle_none_leaves_no_life_state():
    wb = _workloads(TINY, (0.9,))
    out = simulate_many(HERMES, TINY, wb, device="cpu")
    assert out.life is None and out.rep(0).life is None
    cl = TINY._replace(lifecycle=LifecycleCfg("HYBRID_HIST", ttl_s=2.0))
    out = simulate_many(HERMES, cl, wb, device="cpu")
    assert out[0:1].life["hist"].shape == (1, 5, 32)
    assert out.rep(0).life["pre"].shape == (5,)


def test_cpu_under_a_lifecycle_launches_nothing():
    cluster, wb = _fused_case("hist-budget")
    before = (kernel.sim_engine.launches,
              hermes_kernel.hermes_select_batch.launches)
    out = simulate_many(HERMES, cluster, wb, device="cpu", backend="kernel")
    got = ops.sim_engine("H", cluster, *_inputs(wb))
    assert (kernel.sim_engine.launches,
            hermes_kernel.hermes_select_batch.launches) == before
    for plane, key in PLANES.items():
        np.testing.assert_array_equal(got[key].numpy(), getattr(out, plane))
    for key, want in out.life.items():
        assert got[f"life_{key}"].numpy().tobytes() == want.tobytes(), key


def _tiered(cfg, n_functions, device):
    keep = torch.full((n_functions,), 2.0 * cfg.ttl_s, dtype=torch.float64,
                      device=device)
    pre = torch.zeros(n_functions, dtype=torch.float64, device=device)
    return (lambda state: (pre, keep)), None


def test_route_by_cluster():
    fused = (*FUSED,)
    big = {
        "W": TINY._replace(n_workers=kernel.MAX_WORKERS + 1),
        "S": ClusterCfg(n_workers=8, cores=256),      # 2048 slots
    }
    assert big["S"].slots == kernel.MAX_SLOTS + 1
    edge = ClusterCfg(n_workers=kernel.MAX_WORKERS, cores=1,
                      capacity_factor=kernel.MAX_SLOTS)
    for policy in fused:
        for device in ("cuda", torch.device("cuda")):
            # the three-argument call and cluster=None keep their answers
            assert engine(policy, device) == "sim_engine"
            assert engine(policy, device, "auto", None) == "sim_engine"
            assert engine(policy.name, device, "kernel", edge) == \
                "sim_engine"
            for cl in big.values():
                assert engine(policy, device, "auto", cl) == "batched"
                assert engine(policy, device, "kernel", cl) == "batched"
            for life in (*LIFECYCLES.values(), *FUSED_LIFECYCLES.values()):
                assert engine(policy, device, "auto",
                              TINY._replace(lifecycle=life)) == "sim_engine"
        assert engine(policy, "cpu", "auto", big["S"]) == "batched"
        assert engine(policy, "cuda", "torch", TINY) == "batched"
    register_keepalive("TIERED", make_torch=_tiered)
    try:
        custom = TINY._replace(lifecycle=LifecycleCfg("TIERED"))
        for policy in fused:
            assert engine(policy, "cuda", "auto", custom) == "batched"
        # neither the kernel's wrapper nor its plain version takes it
        wb = _workloads(custom, (0.9,))
        with pytest.raises(NotPortedError, match="built-in keep-alives"):
            sim_engine_ref("H", custom, *_inputs(wb))
        with pytest.raises(NotPortedError, match="built-in keep-alives"):
            ops.sim_engine("LL", custom, *_inputs(wb))
        # the batched engine runs it, on the CPU here
        out = simulate_many(HERMES, custom, wb, device="cpu")
        assert out.life["keep"].tolist() == [[120.0] * 5]
    finally:
        unregister_keepalive("TIERED")
    # policies outside the table stay batched whatever the cluster
    for policy in (LATE_BINDING, HERMES._replace(sched=WorkerSched.SRPT)):
        assert engine(policy, "cuda", "auto", TINY) == "batched"


def test_route_at_s_2048_runs_the_batched_engine_on_the_cpu():
    """The repaired fault's cluster (S = 2048) gives the batched engine's
    output through the default route (on the CPU here; phase 14 of
    ``chip_smoke.py`` runs it on the card)."""
    cluster = ClusterCfg(n_workers=8, cores=256)
    wb = stack_workloads(synth_workload(cluster, 0.9, 60, n_functions=5,
                                        seed=2) for _ in range(2))
    stats = LoopStats()
    out = simulate_many(HERMES, cluster, wb, device="cpu", stats=stats)
    plain = simulate_many(HERMES, cluster, wb, device="cpu",
                          backend="torch")
    assert stats.host_syncs > 0
    for plane in PLANES:
        np.testing.assert_array_equal(getattr(out, plane),
                                      getattr(plain, plane))


def test_cuda_kernel_matches_batched_engine_under_a_lifecycle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for life in FUSED_LIFECYCLES:
        cluster, wb = _fused_case(life)
        for policy in FUSED:
            before = kernel.sim_engine.launches
            got = simulate_many(policy, cluster, wb, device="cuda")
            assert kernel.sim_engine.launches == before + 1
            plain = simulate_many(policy, cluster, wb, device="cuda",
                                  backend="torch")
            for plane in PLANES:
                np.testing.assert_array_equal(getattr(got, plane),
                                              getattr(plain, plane),
                                              err_msg=plane)
            for key, want in plain.life.items():
                assert got.life[key].tobytes() == want.tobytes(), key
