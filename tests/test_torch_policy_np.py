"""The port's numpy backends (the oracle's) against the reference's ``np``
backends, bit for bit, on the CPU.

* The nine balancers' selects on seeded random states (the reference's
  ``_random_state`` of ``tests/test_policies.py``, with the slot-full and
  core-full corners): the same worker, and for HIKU, DD and SWARM the same
  state in every entry.
* HIKU, DD and SWARM with their state threaded through random selections
  and completions, as ``tests/test_torch_policy_zoo.py`` does for the
  torch backend: every entry bit for bit after each step.
* The three schedulers' rates on random task lists, ties among them.
* ``hermes_score_np`` and ``select_worker_np``; the stateless shims
  refusing a stateful balancer; ``make_select_worker_torch`` on the CPU
  against ``make_select_worker_jax``.
* The lifecycle's ``np`` backend: the three keep-alives' windows and
  HYBRID_HIST's ``observe`` over random gaps, and ``LifecycleRuntime``
  over a numpy resolution, op for op against the reference's.
* ``resolve(..., backend="np")`` and ``resolve_lifecycle(...,
  backend="np")`` with no device and without touching one, and the
  engines' named refusal of ``backend="np"``.

Where JAX is not installed, the reference-side tests skip.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.device
from repro_torch.core import (ClusterCfg, LifecycleCfg, PAPER_SMALL,
                              ms_trace, parse_policy)
from repro_torch.core.policies import (hermes_score_np,
                                       make_select_worker_torch,
                                       select_worker_np)
from repro_torch.core.simulator import simulate, simulate_many
from repro_torch.core.streaming import monolithic_state, simulate_stream
from repro_torch.lifecycle import LifecycleRuntime, resolve_lifecycle
from repro_torch.policy import (INIT_STATE_NP, balancer_names, engine,
                                np_rates, np_select, resolve)

try:
    import repro.core as rc
    import repro.lifecycle as rl
    from repro.core import policies as ref_policies
    from repro.policy import resolve as ref_resolve
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

STATEFUL = ("HIKU", "DD", "SWARM")
KEEPALIVES = ("NONE", "FIXED_TTL", "HYBRID_HIST")


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _random_state(seed):
    """``tests/test_policies.py``'s seeded cluster state."""
    rng = np.random.default_rng(seed)
    W = int(rng.integers(2, 17))
    cores = int(rng.integers(1, 17))
    capf = int(rng.integers(1, 13))
    slots = cores * capf
    active = np.minimum(rng.integers(0, 101, W).astype(np.int64), slots)
    warm = rng.integers(0, 4, W).astype(np.int64)
    return active, warm, cores, slots


def _ref_np(name, cores, slots):
    """The reference's np resolution of E/<name>/PS for a cluster shape."""
    return ref_resolve(rc.parse_policy(f"E/{name}/PS"), backend="np",
                       cluster=rc.ClusterCfg(1, cores, slots // cores))


def _same_state(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (what, k)


# ------------------------------------------------------------ balancers


@pytest.mark.parametrize("seed", range(30))
def test_selects_bit_equal_on_random_states(reference, seed):
    active, warm_f, cores, slots = _random_state(seed)
    rng = np.random.default_rng(1000 + seed)
    W, F = len(active), 4
    homes = rng.integers(0, W, F).astype(np.int32)
    u, idx = float(rng.uniform()), int(rng.integers(0, 1000))
    # the state as given, every worker slot-full, every core taken
    corners = (active, np.full_like(active, slots),
               np.maximum(active, min(cores, slots - 1)))
    for name in balancer_names():
        ref = _ref_np(name, cores, slots)
        res = resolve(f"E/{name}/PS", ClusterCfg(W, cores, slots // cores),
                      backend="np")
        for act in corners:
            args = (act, warm_f, int(idx % F), homes, u, idx)
            if name in STATEFUL:
                w, s = res.select(res.init_state(W, F), *args)
                w_ref, s_ref = ref.select(ref.init_state(W, F), *args)
                _same_state(s, s_ref, (name, seed))
            else:
                w, w_ref = res.select(*args), ref.select(*args)
            assert type(w) is int and w == w_ref, (name, seed, act)


@pytest.mark.parametrize("W,cores,cf", [(3, 2, 2), (8, 12, 8), (5, 3, 1)])
@pytest.mark.parametrize("name", STATEFUL)
def test_carried_state_threaded_bit_equal(reference, name, W, cores, cf):
    cluster = ClusterCfg(n_workers=W, cores=cores, capacity_factor=cf)
    S, F = cluster.slots, 4
    res = resolve(f"E/{name}/PS", cluster, backend="np")
    ref = _ref_np(name, cores, S)
    state, want = res.init_state(W, F), ref.init_state(W, F)
    _same_state(state, want, "init")
    rng = np.random.default_rng(W * 7 + cores)
    for step in range(300):
        active = rng.integers(0, S + 1, W)
        if step % 5 == 1:
            active[:] = S                          # every worker full
        if step % 5 == 2:
            active = rng.integers(0, cores + 1, W)  # cores saturate
        args = (active, rng.integers(0, 3, W), int(rng.integers(0, F)),
                rng.integers(0, W, F).astype(np.int32), float(rng.uniform()),
                step)
        w, state = res.select(state, *args)
        w_ref, want = ref.select(want, *args)
        assert w == w_ref, (name, step)
        _same_state(state, want, f"select, step {step}")
        # a random completion: worker 0 takes most, so that SWARM's
        # burn-in of 128 completions ends
        done = (0 if rng.uniform() < 0.6 else int(rng.integers(0, W)),
                int(rng.integers(0, F)), float(rng.lognormal(-0.5, 1.5)),
                0 if rng.uniform() < 0.4 else int(rng.integers(1, S)))
        state = res.on_complete(state, *done)
        want = ref.on_complete(want, *done)
        _same_state(state, want, f"on_complete, step {step}")
    if name == "SWARM":
        assert int(state["cnt"].max()) > 128


# ----------------------------------------------------------- schedulers


@pytest.mark.parametrize("cores", [1, 3, 12])
@pytest.mark.parametrize("sched", ["PS", "FCFS", "SRPT"])
def test_rates_bit_equal(reference, sched, cores):
    mine = np_rates(sched, cores)
    ref = ref_resolve(rc.parse_policy(f"E/LL/{sched}"), backend="np",
                      cluster=rc.ClusterCfg(1, cores, 2)).rates
    assert np_rates(sched.lower(), cores)([1.0] * 3, [0, 1, 2]) == \
        mine([1.0] * 3, [0, 1, 2])
    rng = np.random.default_rng(cores)
    for n in (0, 1, 2, 5, 17, 40):
        for _ in range(5):
            # a few remaining works drawn from a small set: SRPT's ties
            # break by arrival sequence
            remaining = list(rng.choice([0.5, 1.0, 1.0, 2.5],
                                        n) * rng.uniform(0.9, 1.1))
            seqs = list(rng.permutation(1000)[:n])
            got, want = mine(remaining, seqs), ref(remaining, seqs)
            assert [type(r) for r in got] == [type(r) for r in want]
            assert got == want


# ------------------------------------------------- the compat shims


@pytest.mark.parametrize("seed", range(20))
def test_hermes_score_and_select_worker_np(reference, seed):
    active, warm_f, cores, slots = _random_state(seed)
    for act in (active, np.full_like(active, slots)):
        score, low = hermes_score_np(act, warm_f, cores, slots)
        s_ref, low_ref = ref_policies.hermes_score_np(act, warm_f, cores,
                                                      slots)
        assert low == low_ref and score.dtype == s_ref.dtype
        assert score.tobytes() == s_ref.tobytes()
    rng = np.random.default_rng(seed)
    W, F = len(active), 5
    warm = rng.integers(0, 3, (W, F))
    homes = rng.integers(0, W, F).astype(np.int32)
    for name in ("LOC", "R", "LL", "H", "JSQ2", "RR"):
        for f in range(F):
            u, idx = float(rng.uniform()), int(rng.integers(0, 100))
            args = (name, active, warm, f, homes, u, cores, slots)
            assert select_worker_np(*args, idx=idx) == \
                ref_policies.select_worker_np(*args, idx=idx), (name, f)


def test_stateless_shims_refuse_stateful_balancers():
    active = np.zeros(3, dtype=np.int64)
    warm = np.zeros((3, 2), dtype=np.int64)
    homes = np.zeros(2, dtype=np.int32)
    for name in STATEFUL:
        with pytest.raises(ValueError, match="carries state"):
            select_worker_np(name, active, warm, 0, homes, 0.5, 2, 4)
        with pytest.raises(ValueError, match="carries state"):
            make_select_worker_torch(name, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown load balancer"):
        select_worker_np("NOPE", active, warm, 0, homes, 0.5, 2, 4)


@pytest.mark.parametrize("name", ["LOC", "R", "LL", "H", "JSQ2", "RR"])
def test_make_select_worker_torch_matches_jax(reference, name):
    import jax
    rng = np.random.default_rng(len(name))
    W, F, cores, slots = 6, 4, 3, 9
    mine = make_select_worker_torch(name, cores, slots, device="cpu")
    with jax.enable_x64(True):
        theirs = ref_policies.make_select_worker_jax(name, cores, slots)
        for step in range(25):
            active = rng.integers(0, slots + 1, W).astype(np.int32)
            if step % 6 == 1:
                active[:] = slots
            warm_col = rng.integers(0, 3, W).astype(np.int32)
            func = int(rng.integers(0, F))
            homes = rng.integers(0, W, F).astype(np.int32)
            u = float(rng.uniform())
            got = mine(active, warm_col, func, homes, u, step)
            want = theirs(active, warm_col, func, homes, u, step)
            assert got.dtype == torch.int32 and got.shape == ()
            assert int(got) == int(want), (name, step)
            # idx defaults to 0 on both
            assert int(mine(active, warm_col, func, homes, u)) == \
                int(theirs(active, warm_col, func, homes, u))


def test_make_select_worker_torch_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(repro_torch.device.NoCudaDeviceError):
        make_select_worker_torch("LL", 2, 4)


# ------------------------------------------------------------ lifecycle


def _life_cluster(keepalive, **kw):
    return ClusterCfg(4, 3, 2, 0.25, lifecycle=LifecycleCfg(keepalive, **kw))


def _ref_life(cluster, F):
    jcl = rc.ClusterCfg(*cluster[:4],
                        lifecycle=rl.LifecycleCfg(*cluster.lifecycle))
    return rl.resolve_lifecycle(jcl, backend="np", n_functions=F)


@pytest.mark.parametrize("ttl", [0.7, 10.0])
@pytest.mark.parametrize("keepalive", KEEPALIVES)
def test_lifecycle_np_windows_and_observe(reference, keepalive, ttl):
    F = 7
    cl = _life_cluster(keepalive, ttl_s=ttl, max_idle=2,
                       coldstart="aws-lambda")
    mine, ref = resolve_lifecycle(cl, F, backend="np"), _ref_life(cl, F)
    assert mine.backend == "np" and mine.device is None
    assert mine.cold_costs.tobytes() == ref.cold_costs.tobytes()
    assert mine.max_idle == ref.max_idle == 2
    state = mine.init_policy_state(1, 4, F)
    want = ref.init_policy_state(4, F)
    assert (state is None) == (want is None) == (keepalive != "HYBRID_HIST")
    rng = np.random.default_rng(F)
    for step in range(200):
        (pre, keep), (p_ref, k_ref) = mine.windows(state), ref.windows(want)
        assert pre.dtype == p_ref.dtype and pre.tobytes() == p_ref.tobytes()
        assert keep.tobytes() == k_ref.tobytes(), step
        if state is None:
            break
        f = int(rng.integers(0, F))
        gap = float(rng.exponential(ttl)) if step % 9 else -0.5
        state, want = mine.observe(state, f, gap), ref.observe(want, f, gap)
        _same_state(state, want, f"observe, step {step}")


@pytest.mark.parametrize("keepalive", KEEPALIVES)
def test_lifecycle_runtime_on_np_op_for_op(reference, keepalive):
    W, F = 4, 5
    cl = _life_cluster(keepalive, ttl_s=2.0, max_idle=3,
                       coldstart="openwhisk")
    mine = LifecycleRuntime(resolve_lifecycle(cl, F, backend="np"), W, F)
    ref = rl.LifecycleRuntime(_ref_life(cl, F), W, F)
    warm, warm_ref = np.zeros((W, F), np.int64), np.zeros((W, F), np.int64)
    rng = np.random.default_rng(3)
    now = 0.0
    for step in range(400):
        now += float(rng.exponential(0.4))
        w, f = int(rng.integers(0, W)), int(rng.integers(0, F))
        if rng.uniform() < 0.5:
            assert mine.on_complete(warm, w, f, now) == \
                ref.on_complete(warm_ref, w, f, now)
        else:
            assert mine.materialized_at(w, f, warm[w, f], now) == \
                ref.materialized_at(w, f, warm_ref[w, f], now)
            mine.observe_place(w, f, now)
            ref.observe_place(w, f, now)
        assert warm.tobytes() == warm_ref.tobytes(), step
        for a, b in ((mine.materialized_col(warm[:, f], f, now),
                      ref.materialized_col(warm_ref[:, f], f, now)),
                     (mine.materialized_all(warm, now),
                      ref.materialized_all(warm_ref, now)),
                     (mine.eff_row(warm[w], w, now),
                      ref.eff_row(warm_ref[w], w, now)),
                     (mine.pre, ref.pre), (mine.keep, ref.keep),
                     (mine.idle_since, ref.idle_since)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), step
        if (mine.eff_row(warm[w], w, now) > 0).any():
            assert mine.evict_victim(warm[w], w, now) == \
                ref.evict_victim(warm_ref[w], w, now)
    assert mine.cold_cost(2, 0.25) == ref.cold_cost(2, 0.25)


def test_lifecycle_np_needs_an_np_backend():
    from repro_torch.lifecycle import register_keepalive, unregister_keepalive
    register_keepalive("TORCH_ONLY", make_torch=lambda cfg, F, dev: (
        lambda s: (torch.zeros(F, dtype=torch.float64),) * 2, None))
    try:
        with pytest.raises(ValueError, match="has no np backend"):
            resolve_lifecycle(_life_cluster("TORCH_ONLY"), 3, backend="np")
    finally:
        unregister_keepalive("TORCH_ONLY")
    with pytest.raises(ValueError, match="takes no device"):
        resolve_lifecycle(_life_cluster("NONE"), 3, "cpu", backend="np")
    with pytest.raises(ValueError, match="unknown lifecycle backend"):
        resolve_lifecycle(_life_cluster("NONE"), 3, backend="jax")
    assert resolve_lifecycle(ClusterCfg(), 3, backend="np") is None


# ------------------------------------------ the np backend needs no card


def test_np_backends_touch_no_device(monkeypatch):
    def no_device(device=None):
        raise AssertionError("the np backend asked for a device")
    for mod in ("repro_torch.policy.registry",
                "repro_torch.lifecycle.registry"):
        monkeypatch.setattr(f"{mod}.resolve_device", no_device)
    cl = ClusterCfg(4, 3, 2)
    for name in balancer_names():
        res = resolve(f"E/{name}/PS", cl, backend="np")
        assert res.backend == "np" and not res.late
        assert res.stateful == (name in STATEFUL)
        assert res.init_state is INIT_STATE_NP.get(name)
        sel = res.select if name not in STATEFUL else \
            (lambda *a, _s=res.select, _st=res.init_state(4, 3): _s(_st,
                                                                    *a)[0])
        w = sel(np.array([3, 1, 2, 0]), np.zeros(4, np.int64), 0,
                np.zeros(3, np.int32), 0.3, 5)
        assert 0 <= w < 4
    late = resolve("L/LL/FCFS", cl, backend="np")
    assert late.late and late.select is None and late.rates is None
    assert np_select("ll", 3, 6)(np.array([6, 2, 1]), None, 0, None, 0.5,
                                 0) == 2
    life = resolve_lifecycle(_life_cluster("HYBRID_HIST"), 3, backend="np")
    assert isinstance(life.windows(life.init_policy_state(1, 4, 3))[0],
                      np.ndarray)
    with pytest.raises(ValueError, match="takes no device"):
        resolve("E/LL/PS", cl, device="cpu", backend="np")


def test_engines_refuse_the_np_backend_by_name():
    wl = ms_trace(PAPER_SMALL, 0.5, 20, seed=0)
    pol = parse_policy("E/LL/PS")
    for call in (lambda: simulate_many(pol, PAPER_SMALL, [wl],
                                       device="cpu", backend="np"),
                 lambda: simulate(pol, PAPER_SMALL, wl, device="cpu",
                                  backend="np"),
                 lambda: simulate_stream(pol, PAPER_SMALL, wl, chunk_size=8,
                                         device="cpu", backend="np"),
                 lambda: monolithic_state(pol, PAPER_SMALL, wl,
                                          device="cpu", backend="np"),
                 lambda: engine(pol, "cpu", "np")):
        with pytest.raises(ValueError, match="simulate_ref"):
            call()
    # without a device either: the refusal comes before the device
    with pytest.raises(ValueError, match="numpy oracle"):
        simulate_many(pol, PAPER_SMALL, [wl], backend="np")
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        simulate_many(pol, PAPER_SMALL, [wl], device="cpu", backend="jax")
    # the present backends are unchanged
    assert engine(pol, "cpu", "auto") == engine(pol, "cpu", "torch") \
        == "batched"
    assert engine(pol, "cuda", "kernel") == "sim_engine"
    assert dataclasses.is_dataclass(resolve(pol, PAPER_SMALL,
                                            device="cpu"))
