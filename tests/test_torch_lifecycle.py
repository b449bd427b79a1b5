"""The port's container lifecycle (``repro_torch.lifecycle``) against the
reference's ``repro.lifecycle`` on the CPU.

* Cold-start presets: every preset's costs bit-equal at F ∈ {1, 7, 60}.
* HYBRID_HIST: ``observe``/``windows`` batched over replications, threaded
  through a few hundred random gaps (a numpy seed; some replications
  masked out at each step), ``pre``/``keep`` and the histograms bit for
  bit against the reference's ``np`` and ``jax`` backends after every
  step.
* ``LifecycleRuntime``: the port's against the reference's, op for op, on
  a random event stream (completions, placements, queries).
* The registry's named errors, ``resolve_lifecycle``, ``is_builtin``,
  ``lifecycle_from_flags``, ``ClusterCfg.validate``; the reference's own
  cases of ``tests/test_lifecycle.py`` that concern these modules.

Where JAX is not installed, the reference-side tests skip.
"""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ClusterCfg, LifecycleCfg
from repro_torch.lifecycle import (LifecycleRuntime, cold_costs_for,
                                   cold_preset_names, get_keepalive,
                                   is_builtin, keepalive_names,
                                   lifecycle_from_flags, parse_cold_preset,
                                   parse_keepalive, register_keepalive,
                                   resolve_lifecycle, unregister_keepalive)
from repro_torch.lifecycle.policies import HIST_BINS

try:
    import repro.core.simulator  # noqa: F401  (turns on JAX's float64)
    import repro.lifecycle as rl
except ImportError:     # no JAX installed: the reference tests skip
    rl = None

REPO = Path(__file__).resolve().parents[1]
CLUSTER = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                     cold_start_penalty=0.25)
KEEPALIVES = ("NONE", "FIXED_TTL", "HYBRID_HIST")


@pytest.fixture
def reference():
    if rl is None:
        pytest.skip("the JAX reference package is not installed here")


def _life(keepalive="FIXED_TTL", **kw):
    return CLUSTER._replace(lifecycle=LifecycleCfg(keepalive=keepalive,
                                                   **kw))


def _ref_cluster(cluster):
    """The reference's ClusterCfg for a port cluster."""
    import repro.core as rc
    return rc.ClusterCfg(*cluster[:4], lifecycle=None if cluster.lifecycle
                         is None else rl.LifecycleCfg(*cluster.lifecycle))


# ------------------------------------------------------ cold-start presets


@pytest.mark.parametrize("F", (1, 7, 60))
@pytest.mark.parametrize("preset", ("scalar", "paper-sim", "openwhisk",
                                    "aws-lambda", "azure-functions"))
def test_preset_costs_bit_equal(reference, preset, F):
    got, want = cold_costs_for(preset, F), rl.cold_costs_for(preset, F)
    if preset == "scalar":
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float64 and got.shape == (F,)
    assert got.tobytes() == want.tobytes()


def test_preset_names_and_golden_draws():
    assert cold_preset_names() == ("scalar", "paper-sim", "openwhisk",
                                   "aws-lambda", "azure-functions")
    # the reference's locked draws (tests/test_lifecycle.py)
    golden = {
        "aws-lambda": [0.26241618965687286, 0.4676961322876191,
                       0.9339690225462384, 0.1162548297360505,
                       0.14245870186250864, 0.2965521275249738],
        "azure-functions": [0.09681418277487916, 0.7245567309094818,
                            1.5524833470747126, 0.11443851318457184,
                            0.4532842308332041, 0.13544235566618817],
    }
    for preset, want in golden.items():
        np.testing.assert_allclose(cold_costs_for(preset, 6), want,
                                   rtol=1e-12)
        np.testing.assert_allclose(cold_costs_for(preset, 12)[:6], want,
                                   rtol=1e-12)
    np.testing.assert_array_equal(cold_costs_for("openwhisk", 6),
                                  np.full(6, 0.5))
    np.testing.assert_array_equal(cold_costs_for("paper-sim", 4),
                                  np.zeros(4))
    assert cold_costs_for("scalar", 16) is None
    a = cold_costs_for("aws-lambda", 16)
    assert len(np.unique(a)) > 1 and (a > 0).all()


# ------------------------------------------------- HYBRID_HIST, bit for bit


@pytest.mark.parametrize("ttl", (0.5, 4.0, 10.0))
def test_hybrid_hist_windows_match_both_backends(reference, ttl):
    """R replications of the port's batched state against R states of
    each reference backend, one random observation per step (masked out
    in some rows), every window and histogram bit for bit."""
    import jax.numpy as jnp
    R, F = 3, 4
    cfg = LifecycleCfg(keepalive="HYBRID_HIST", ttl_s=ttl)
    ka = get_keepalive("HYBRID_HIST")
    windows, observe = ka.make_torch(cfg, F, torch.device("cpu"))
    state = ka.init_state(cfg, R, 2, F, torch.device("cpu"))
    rka = rl.get_keepalive("HYBRID_HIST")
    rcfg = rl.LifecycleCfg(*cfg)
    wn, on = rka.make_np(rcfg, F)
    wj, oj = rka.make_jax(rcfg, F)
    s_np = [rka.init_state(rcfg, 2, F) for _ in range(R)]
    s_jax = [{k: jnp.asarray(v) for k, v in rka.init_state(rcfg, 2,
                                                           F).items()}
             for _ in range(R)]
    rng = np.random.default_rng(0)
    for _ in range(300):
        f = rng.integers(0, F, size=R)
        # gaps around the histogram's span, some beyond its last bin
        gap = rng.exponential(1.5 * ttl, size=R)
        mask = rng.random(R) < 0.8
        state = observe(state, torch.as_tensor(f), torch.as_tensor(gap),
                        torch.as_tensor(mask))
        pre, keep = windows(state)
        for r in range(R):
            if mask[r]:
                s_np[r] = on(s_np[r], int(f[r]), float(gap[r]))
                s_jax[r] = oj(s_jax[r], int(f[r]), float(gap[r]))
            for w_ref, s in ((wn, s_np[r]), (wj, s_jax[r])):
                pre_r, keep_r = (np.asarray(x) for x in w_ref(s))
                assert pre[r].numpy().tobytes() == pre_r.tobytes()
                assert keep[r].numpy().tobytes() == keep_r.tobytes()
    for r in range(R):
        assert state["hist"][r].numpy().tobytes() == \
            s_np[r]["hist"].tobytes() == \
            np.asarray(s_jax[r]["hist"]).tobytes()
        np.testing.assert_array_equal(state["n_obs"][r].numpy(),
                                      s_np[r]["n_obs"])
    # the windows learned something: pre-warm and keep both moved
    assert (pre > 0).any() and (keep != ttl).any()


def test_hybrid_hist_bins_clamp_and_fallback():
    cfg = LifecycleCfg(keepalive="HYBRID_HIST", ttl_s=8.0)
    ka = get_keepalive("HYBRID_HIST")
    windows, observe = ka.make_torch(cfg, 2, "cpu")
    state = ka.init_state(cfg, 1, 1, 2, "cpu")
    pre, keep = windows(state)
    # fewer than HIST_MIN_OBS gaps: the fixed TTL
    assert pre.tolist() == [[0.0, 0.0]] and keep.tolist() == [[8.0, 8.0]]
    one = torch.ones(1, dtype=torch.bool)
    for gap in (1e9, -3.0, 2.5):      # beyond the span, negative, bin 2
        state = observe(state, torch.tensor([1]), torch.tensor([gap],
                                                              dtype=torch.float64), one)
    hist = state["hist"][0, 1]
    assert hist[HIST_BINS - 1] == 1 and hist[0] == 1 and hist[2] == 1
    assert state["n_obs"].tolist() == [[0.0, 3.0]]
    pre, keep = windows(state)
    assert pre[0, 0] == 0.0 and keep[0, 0] == 8.0 and keep[0, 1] != 8.0


# ------------------------------------------------------ LifecycleRuntime


def _stream(rng, W, F, n):
    """A random event stream: (kind, worker, function, time)."""
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(0.7))
        yield (("complete", "place", "query")[int(rng.integers(0, 3))],
               int(rng.integers(0, W)), int(rng.integers(0, F)), t)


@pytest.mark.parametrize("max_idle", (0, 2))
@pytest.mark.parametrize("keepalive", KEEPALIVES)
def test_runtime_matches_reference_op_for_op(reference, keepalive,
                                             max_idle):
    W, F = 3, 5
    cl = _life(keepalive, ttl_s=2.0, max_idle=max_idle,
               coldstart="aws-lambda")
    port = LifecycleRuntime(resolve_lifecycle(cl, F, "cpu"), W, F)
    ref = rl.LifecycleRuntime(rl.resolve_lifecycle(
        _ref_cluster(cl), backend="np", n_functions=F), W, F)
    warm_p = np.zeros((W, F), dtype=np.int64)
    warm_r = np.zeros((W, F), dtype=np.int64)
    rng = np.random.default_rng(3)
    evicted = 0
    for kind, w, f, t in _stream(rng, W, F, 400):
        if kind == "complete":
            got = port.on_complete(warm_p, w, f, t)
            assert got == ref.on_complete(warm_r, w, f, t)
            evicted += got
        elif kind == "place":
            hit_p = port.materialized_col(warm_p[:, f], f, t)[w]
            assert hit_p == ref.materialized_at(w, f, warm_r[w, f], t)
            if hit_p:
                warm_p[w, f] -= 1
                warm_r[w, f] -= 1
            port.observe_place(w, f, t)
            ref.observe_place(w, f, t)
        else:
            np.testing.assert_array_equal(
                port.materialized_col(warm_p[:, f], f, t),
                ref.materialized_col(warm_r[:, f], f, t))
            eff = port.eff_row(warm_p[w], w, t)
            np.testing.assert_array_equal(eff, ref.eff_row(warm_r[w], w, t))
            if eff.sum() > 0:
                assert port.evict_victim(warm_p[w], w, t) == \
                    ref.evict_victim(warm_r[w], w, t)
        np.testing.assert_array_equal(warm_p, warm_r)
        assert port.idle_since.tobytes() == ref.idle_since.tobytes()
        assert port.pre.tobytes() == np.asarray(ref.pre, dtype=np.float64
                                                ).tobytes()
        assert port.keep.tobytes() == np.asarray(ref.keep, dtype=np.float64
                                                 ).tobytes()
    assert port.res.cold_costs.tobytes() == ref.res.cold_costs.tobytes()
    assert (evicted > 0) == (max_idle > 0 and keepalive != "NONE")


def test_max_idle_budget_enforced_lru():
    cl = ClusterCfg(n_workers=2, cores=2, capacity_factor=4,
                    lifecycle=LifecycleCfg(ttl_s=100.0, max_idle=2))
    res = resolve_lifecycle(cl, 5, "cpu")
    rt = LifecycleRuntime(res, 2, 5)
    warm = np.zeros((2, 5), dtype=np.int64)
    for f, t in ((0, 1.0), (1, 2.0), (2, 3.0)):
        rt.on_complete(warm, 0, f, t)
    # budget 2: the third completion evicted function 0, the oldest
    assert warm[0].tolist() == [0, 1, 1, 0, 0]
    # equal idle_since: the lowest function id goes
    rt2 = LifecycleRuntime(res, 2, 5)
    warm2 = np.zeros((2, 5), dtype=np.int64)
    rt2.idle_since[1, 3] = rt2.idle_since[1, 4] = 5.0
    warm2[1, 3] = warm2[1, 4] = 1
    assert rt2.evict_victim(warm2[1], 1, 6.0) == 3


# ---------------------------------------- registry, flags and validation


def test_registry_named_errors():
    with pytest.raises(ValueError, match="unknown keep-alive.*FIXED_TTL"):
        parse_keepalive("NOPE")
    with pytest.raises(ValueError, match="unknown cold-start preset"):
        parse_cold_preset("NOPE")
    assert parse_cold_preset("scalar") == "scalar"
    assert parse_keepalive("hybrid_hist") == "HYBRID_HIST"
    assert keepalive_names() == KEEPALIVES
    assert get_keepalive("HYBRID_HIST").stateful
    assert not get_keepalive("FIXED_TTL").stateful
    with pytest.raises(ValueError, match="already registered"):
        register_keepalive("FIXED_TTL", make_torch=lambda c, F, d: None)
    with pytest.raises(ValueError, match="needs a make_torch"):
        register_keepalive("EMPTY")
    with pytest.raises(ValueError, match="invalid keep-alive"):
        register_keepalive("A/B", make_torch=lambda c, F, d: None)
    with pytest.raises(ValueError, match="unknown keep-alive"):
        resolve_lifecycle(_life("GHOST"), 4, "cpu")


def test_resolved_lifecycle_shape():
    res = resolve_lifecycle(_life(ttl_s=9.0, max_idle=3,
                                  coldstart="aws-lambda"), 6, "cpu")
    assert res.max_idle == 3 and res.cold_costs.shape == (6,)
    assert res.observe is None and res.init_policy_state(2, 4, 6) is None
    pre, keep = res.windows(None)
    assert (pre == 0.0).all() and (keep == 9.0).all()
    assert pre.dtype == keep.dtype == torch.float64
    assert resolve_lifecycle(CLUSTER, 6, "cpu") is None
    hyb = resolve_lifecycle(_life("HYBRID_HIST"), 6, "cpu")
    state = hyb.init_policy_state(2, 4, 6)
    assert state["hist"].shape == (2, 6, HIST_BINS)
    assert state["n_obs"].shape == (2, 6)


def test_custom_keepalive_registers_and_is_not_builtin():
    def make_torch(cfg, n_functions, device):
        even = torch.arange(n_functions, device=device) % 2 == 0
        keep = torch.where(even, 2.0 * cfg.ttl_s, 0.25 * cfg.ttl_s
                           ).to(torch.float64)
        pre = torch.zeros(n_functions, dtype=torch.float64, device=device)
        return (lambda state: (pre, keep)), None

    assert all(is_builtin(k) for k in KEEPALIVES)
    register_keepalive("TIERED", make_torch=make_torch)
    try:
        assert parse_keepalive("tiered") == "TIERED"
        assert not is_builtin("TIERED")
        _life("TIERED").validate()
        pre, keep = resolve_lifecycle(_life("TIERED", ttl_s=2.0), 4,
                                      "cpu").windows(None)
        assert keep.tolist() == [4.0, 0.5, 4.0, 0.5]
    finally:
        unregister_keepalive("TIERED")
    # a policy registered over a built-in's name is not the built-in
    orig = get_keepalive("NONE")
    register_keepalive("NONE", make_torch=make_torch, overwrite=True)
    try:
        assert not is_builtin("NONE")
    finally:
        register_keepalive("NONE", make_torch=orig.make_torch,
                           overwrite=True)
        from repro_torch.lifecycle import registry
        registry.KEEPALIVES["NONE"] = registry.BUILTINS["NONE"]
    assert is_builtin("NONE") and not is_builtin("GHOST")


def test_early_builtin_name_collision_fails_fast():
    """Registering a built-in's name as the first touch of the registry
    fails at the call, and leaves the built-ins loadable (a fresh
    interpreter: in this one they are loaded already)."""
    code = (
        "from repro_torch.lifecycle import register_keepalive, "
        "keepalive_names\n"
        "try:\n"
        "    register_keepalive('FIXED_TTL',\n"
        "                       make_torch=lambda cfg, F, d: (None, None))\n"
        "except ValueError as e:\n"
        "    assert 'already registered' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('collision not detected')\n"
        "assert keepalive_names() == ('NONE', 'FIXED_TTL', 'HYBRID_HIST')\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO),
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_lifecycle_from_flags_semantics():
    assert lifecycle_from_flags() is None
    lc = lifecycle_from_flags(coldstart="openwhisk")
    assert lc.keepalive == "FIXED_TTL" and lc.ttl_s == math.inf
    lc = lifecycle_from_flags(max_idle=4)
    assert lc.ttl_s == math.inf and lc.max_idle == 4
    lc = lifecycle_from_flags("hybrid_hist", 30.0, 2, "aws-lambda")
    assert lc == LifecycleCfg("HYBRID_HIST", 30.0, 2, "aws-lambda")
    with pytest.raises(ValueError, match="unknown keep-alive"):
        lifecycle_from_flags("NOPE")
    with pytest.raises(ValueError, match="unknown cold-start preset"):
        lifecycle_from_flags(coldstart="NOPE")


@pytest.mark.parametrize("flags", [
    {}, dict(coldstart="openwhisk"), dict(max_idle=4),
    dict(keepalive="hybrid_hist", ttl_s=30.0, max_idle=2,
         coldstart="aws-lambda"),
    dict(keepalive="none", coldstart="azure-functions")])
def test_lifecycle_from_flags_matches_reference(reference, flags):
    got, want = lifecycle_from_flags(**flags), \
        rl.lifecycle_from_flags(**flags)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)


def test_cluster_validate_named_errors():
    _life("HYBRID_HIST", ttl_s=3.0, max_idle=2,
          coldstart="aws-lambda").validate()
    with pytest.raises(ValueError, match="unknown keep-alive"):
        _life("GHOST").validate()
    with pytest.raises(ValueError, match="unknown cold-start preset"):
        _life(coldstart="nope").validate()
    with pytest.raises(ValueError, match="max_idle must be >= 0"):
        _life(max_idle=-1).validate()
    with pytest.raises(ValueError, match="ttl_s must be >= 0"):
        _life(ttl_s=float("nan")).validate()
    with pytest.raises(ValueError, match="must be a LifecycleCfg"):
        CLUSTER._replace(lifecycle=("FIXED_TTL", 1.0, 0, "x")).validate()
    with pytest.raises(ValueError, match="fleet must be a FleetCfg"):
        CLUSTER._replace(fleet=object()).validate()
