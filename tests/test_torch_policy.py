"""Port balancers and schedulers, step by step, against the reference's
numpy backend (``repro.policy.resolve(..., backend="np")``) over
randomized cluster states.  Selections and rates must be equal; rates
must be f64."""
import numpy as np
import pytest
import torch

from repro.core import ClusterCfg as JaxClusterCfg
from repro.core import parse_policy as jax_parse_policy
from repro.policy import resolve as jax_resolve

from repro_torch.core import ClusterCfg, parse_policy
from repro_torch.policy import resolve

R = 3


def _states(rng, W, F, slots, n_steps=40):
    """Random per-replication states, including slot-full and core-full
    rows, as the engine hands them to ``select``."""
    for step in range(n_steps):
        hi = slots + 1
        active = rng.integers(0, hi, (R, W))
        if step % 5 == 1:
            active[0] = slots                      # every worker full
        if step % 5 == 2:
            active[1] = rng.integers(slots // 8, slots + 1, W)
        warm_col = rng.integers(0, 3, (R, W))
        func = rng.integers(0, F, R)
        home = rng.integers(0, W, (R, F))
        u = rng.uniform(size=R)
        yield (active.astype(np.int32), warm_col.astype(np.int32), func,
               home.astype(np.int32), u, step)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("balancer", ["LOC", "R", "LL", "H", "JSQ2", "RR"])
@pytest.mark.parametrize("W,cores,cf", [(4, 3, 2), (8, 12, 8), (5, 2, 1)])
def test_select_matches_numpy_backend(balancer, backend, W, cores, cf):
    policy = f"E/{balancer}/PS"
    cluster = ClusterCfg(n_workers=W, cores=cores, capacity_factor=cf)
    ref = jax_resolve(jax_parse_policy(policy), backend="np",
                      cluster=JaxClusterCfg(W, cores, cf))
    res = resolve(policy, cluster, device="cpu", backend=backend)
    rng = np.random.default_rng(W * 31 + cores)
    for active, warm_col, func, home, u, idx in _states(
            rng, W, 6, cluster.slots):
        got = res.select(torch.as_tensor(active), torch.as_tensor(warm_col),
                         torch.as_tensor(func), torch.as_tensor(home),
                         torch.as_tensor(u), idx)
        assert got.dtype == torch.int32 and got.shape == (R,)
        want = [ref.select(active[r], warm_col[r], int(func[r]), home[r],
                           float(u[r]), idx) for r in range(R)]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _slot_matrix(rng, W, S, fill):
    """A [W, S] slot matrix: unique arrival ids where occupied, else -1."""
    occupied = rng.uniform(size=(W, S)) < fill
    ids = rng.permutation(W * S).reshape(W, S).astype(np.int32)
    task_idx = np.where(occupied, ids, -1).astype(np.int32)
    remaining = np.where(occupied, rng.exponential(2.0, (W, S)), np.inf)
    return task_idx, remaining


@pytest.mark.parametrize("sched", ["PS", "FCFS", "SRPT"])
@pytest.mark.parametrize("cores", [1, 3, 12])
def test_rates_match_numpy_backend(sched, cores):
    policy = f"E/LL/{sched}"
    W, S = 5, 40
    cluster = ClusterCfg(n_workers=W, cores=cores, capacity_factor=8)
    ref = jax_resolve(jax_parse_policy(policy), backend="np",
                      cluster=JaxClusterCfg(W, cores, 8))
    res = resolve(policy, cluster, device="cpu")
    rng = np.random.default_rng(cores)
    for fill in (0.0, 0.05, 0.3, 0.9, 1.0):
        task_idx, remaining = _slot_matrix(rng, W, S, fill)
        got = res.rates(torch.as_tensor(task_idx)[None],
                        torch.as_tensor(remaining)[None])[0]
        assert got.dtype == torch.float64 and got.shape == (W, S)
        want = np.zeros((W, S))
        for w in range(W):
            occ = np.nonzero(task_idx[w] >= 0)[0]
            if len(occ):
                want[w, occ] = ref.rates(list(remaining[w, occ]),
                                         list(task_idx[w, occ]))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["JSQ2", "RR", "HIKU", "DD", "SWARM"])
def test_zoo_balancer_resolves_on_cpu(name):
    res = resolve(parse_policy(f"E/{name}/PS"), ClusterCfg(), device="cpu")
    assert not res.late and callable(res.select) and res.backend == "torch"
    assert res.stateful == (name in ("HIKU", "DD", "SWARM"))
    assert (res.on_complete is not None) == res.stateful


def test_named_errors_and_late_binding():
    with pytest.raises(ValueError, match="unknown load balancer 'XX'"):
        parse_policy("E/XX/PS")
    with pytest.raises(ValueError, match="unknown worker scheduler"):
        parse_policy("E/LL/YY")
    with pytest.raises(ValueError, match="T/LB/S"):
        parse_policy("E/LL")
    assert parse_policy("L/*/*").name == "L/LL/FCFS"
    res = resolve("L/LL/FCFS", ClusterCfg(), device="cpu")
    assert res.late and res.select is None and res.rates is None
    assert resolve("E/H/PS", ClusterCfg(), device="cpu").backend == "kernel"
    assert resolve("E/LL/PS", ClusterCfg(), device="cpu").backend == "torch"
    # the lifecycle is ported: what is not a LifecycleCfg is refused
    with pytest.raises(ValueError, match="lifecycle must be a LifecycleCfg"):
        ClusterCfg(lifecycle=object()).validate()
