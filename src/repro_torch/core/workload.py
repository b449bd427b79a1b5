"""Workload generation (counterpart of ``repro/core/workload.py``).

Host-side numpy float64, seeded with ``numpy.random.default_rng(seed)``
and drawing in the reference's exact call order, so every array is
bit-equal to the reference's for the same arguments.  Open-loop Poisson
arrivals at ``λ = load × total_cores / mean(service)``; Log-normal
(Azure-shaped, ``μ=-0.38, σ=2.36``) or exponential execution times; one
hot function carrying ``hot_fraction`` of the invocations.  Per-arrival
uniforms ``u_lb`` are pre-drawn so that every engine consumes the same
randomness.  The trace-replay scenarios (``azure-*``) live in
:mod:`repro_torch.trace` and join :data:`WORKLOADS` in
:mod:`repro_torch.core`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .cluster import ClusterCfg

# Azure trace Log-normal parameters (paper Fig. 2 caption).
AZURE_MU = -0.38
AZURE_SIGMA = 2.36


def lognormal_mean(mu: float = AZURE_MU, sigma: float = AZURE_SIGMA) -> float:
    return math.exp(mu + sigma * sigma / 2.0)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A concrete trace of function invocations, sorted by arrival time."""

    arrival: np.ndarray     # (N,) float64, seconds, non-decreasing
    func: np.ndarray        # (N,) int32 function id in [0, n_functions)
    service: np.ndarray     # (N,) float64 execution time, seconds
    u_lb: np.ndarray        # (N,) float64 uniform(0,1) — LB randomness
    func_home: np.ndarray   # (F,) int32 sticky-hash home worker (LOC)
    n_functions: int
    load: float             # offered load as fraction of cluster capacity
    name: str = "workload"

    @property
    def n(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def horizon(self) -> float:
        return float(self.arrival[-1]) if self.n else 0.0


@dataclasses.dataclass(frozen=True)
class WorkloadBatch:
    """``R`` stacked replications sharing one ``(N, F)`` shape."""

    arrival: np.ndarray     # (R, N) float64
    func: np.ndarray        # (R, N) int32
    service: np.ndarray     # (R, N) float64
    u_lb: np.ndarray        # (R, N) float64
    func_home: np.ndarray   # (R, F) int32
    n_functions: int
    loads: tuple            # (R,) offered load per replication
    names: tuple            # (R,) workload names

    @property
    def n_reps(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def n(self) -> int:
        return int(self.arrival.shape[1])

    def rep(self, r: int) -> Workload:
        """The ``r``-th replication as a plain :class:`Workload`."""
        return Workload(
            arrival=self.arrival[r], func=self.func[r],
            service=self.service[r], u_lb=self.u_lb[r],
            func_home=self.func_home[r], n_functions=self.n_functions,
            load=self.loads[r], name=self.names[r])

    def __getitem__(self, sl: slice) -> "WorkloadBatch":
        """A sub-batch over a slice of the replication axis."""
        return WorkloadBatch(
            arrival=self.arrival[sl], func=self.func[sl],
            service=self.service[sl], u_lb=self.u_lb[sl],
            func_home=self.func_home[sl], n_functions=self.n_functions,
            loads=self.loads[sl], names=self.names[sl])


def validate_workload(wl: Workload) -> None:
    """Check a workload's internal shape consistency; raise ``ValueError``."""
    n = wl.arrival.shape[0] if wl.arrival.ndim == 1 else -1
    for field in ("arrival", "func", "service", "u_lb"):
        a = getattr(wl, field)
        if a.ndim != 1 or a.shape[0] != n:
            raise ValueError(
                f"workload {wl.name!r}: {field} must be 1-D of length "
                f"{max(n, 0)} (matching arrival); got shape {a.shape}")
    if wl.func_home.ndim != 1 or wl.func_home.shape[0] != wl.n_functions:
        raise ValueError(
            f"workload {wl.name!r}: func_home must be 1-D of length "
            f"n_functions={wl.n_functions}; got shape {wl.func_home.shape}")
    if n and (int(wl.func.min()) < 0
              or int(wl.func.max()) >= wl.n_functions):
        raise ValueError(
            f"workload {wl.name!r}: func ids must lie in "
            f"[0, {wl.n_functions}); got range "
            f"[{int(wl.func.min())}, {int(wl.func.max())}]")
    if n > 1 and not (np.diff(wl.arrival) >= 0).all():
        raise ValueError(
            f"workload {wl.name!r}: arrival times must be "
            f"non-decreasing (the simulators scan arrivals in order)")


def stack_workloads(wls) -> WorkloadBatch:
    """Stack validated workloads with a shared ``(N, F)`` into a batch."""
    wls = list(wls)
    if not wls:
        raise ValueError("stack_workloads needs at least one workload")
    for wl in wls:
        validate_workload(wl)
    n, f = wls[0].n, wls[0].n_functions
    for wl in wls[1:]:
        if wl.n != n or wl.n_functions != f:
            raise ValueError(
                f"all replications must share (N, F)=({n}, {f}); got "
                f"({wl.n}, {wl.n_functions}) for {wl.name!r}")
    return WorkloadBatch(
        arrival=np.stack([wl.arrival for wl in wls]),
        func=np.stack([wl.func for wl in wls]),
        service=np.stack([wl.service for wl in wls]),
        u_lb=np.stack([wl.u_lb for wl in wls]),
        func_home=np.stack([wl.func_home for wl in wls]),
        n_functions=f,
        loads=tuple(wl.load for wl in wls),
        names=tuple(wl.name for wl in wls))


def replicate_workload(workload_fn, cluster: ClusterCfg, loads, n_arrivals,
                       *, seeds=(0,)) -> WorkloadBatch:
    """The ``loads × seeds`` grid of replications, load-major, as a batch."""
    return stack_workloads(
        workload_fn(cluster, load, n_arrivals, seed)
        for load in loads for seed in seeds)


def _function_mix(rng: np.random.Generator, n: int, n_functions: int,
                  hot_fraction: float) -> np.ndarray:
    """Draw per-invocation function ids with a single hot function."""
    if n_functions == 1:
        return np.zeros(n, dtype=np.int32)
    p = np.full(n_functions, (1.0 - hot_fraction) / (n_functions - 1))
    p[0] = hot_fraction
    return rng.choice(n_functions, size=n, p=p).astype(np.int32)


def synth_workload(
    cluster: ClusterCfg,
    load: float,
    n_arrivals: int,
    *,
    n_functions: int = 50,
    hot_fraction: float = 0.98,
    exec_dist: str = "lognormal",
    mu: float = AZURE_MU,
    sigma: float = AZURE_SIGMA,
    exp_mean: float | None = None,
    max_service: float = 600.0,
    seed: int = 0,
    name: str | None = None,
) -> Workload:
    """Generate a synthetic workload in the paper's style.

    ``exec_dist`` is ``"lognormal"`` (default) or ``"exponential"``;
    ``max_service`` truncates execution times at the platform timeout.
    λ is calibrated against this trace's empirical mean service.
    """
    rng = np.random.default_rng(seed)
    if exec_dist == "lognormal":
        service = rng.lognormal(mean=mu, sigma=sigma, size=n_arrivals)
        service = np.minimum(service, max_service)
    elif exec_dist == "exponential":
        m = exp_mean if exp_mean is not None else lognormal_mean(mu, sigma)
        service = rng.exponential(scale=m, size=n_arrivals)
    else:
        raise ValueError(f"unknown exec_dist {exec_dist!r}")
    mean_service = float(service.mean())
    lam = load * cluster.total_cores / mean_service  # arrivals per second
    inter = rng.exponential(scale=1.0 / lam, size=n_arrivals)
    arrival = np.cumsum(inter)

    func = _function_mix(rng, n_arrivals, n_functions, hot_fraction)
    u_lb = rng.uniform(size=n_arrivals)
    func_home = rng.integers(0, cluster.n_workers,
                             size=n_functions).astype(np.int32)
    return Workload(
        arrival=arrival.astype(np.float64),
        func=func,
        service=service.astype(np.float64),
        u_lb=u_lb,
        func_home=func_home,
        n_functions=n_functions,
        load=load,
        name=name or f"synth-{exec_dist}-load{load:.2f}",
    )


# --- The five evaluation workloads of §6.1, parameterized by load. ---

def ms_trace(cluster: ClusterCfg, load: float, n: int, seed: int = 0
             ) -> Workload:
    """Azure-trace-derived: 50 fns, extreme skew, Log-normal exec."""
    return synth_workload(cluster, load, n, n_functions=50,
                          hot_fraction=0.98, seed=seed, name="ms-trace")


def ms_representative(cluster: ClusterCfg, load: float, n: int, seed: int = 0
                      ) -> Workload:
    """Poisson arrivals, 1 fn = 90 % of load, 49 fns share 10 %."""
    return synth_workload(cluster, load, n, n_functions=50,
                          hot_fraction=0.90, seed=seed,
                          name="ms-representative")


def single_function(cluster: ClusterCfg, load: float, n: int, seed: int = 0
                    ) -> Workload:
    """All invocations belong to one function (analytics-style, max skew)."""
    return synth_workload(cluster, load, n, n_functions=1, hot_fraction=1.0,
                          seed=seed, name="single-function")


def multi_balanced(cluster: ClusterCfg, load: float, n: int, seed: int = 0
                   ) -> Workload:
    """50 functions, each contributing equally (zero skew)."""
    return synth_workload(cluster, load, n, n_functions=50,
                          hot_fraction=1.0 / 50, seed=seed,
                          name="multi-balanced")


def homogeneous_exec(cluster: ClusterCfg, load: float, n: int, seed: int = 0
                     ) -> Workload:
    """MS-trace skew but light-tailed exponential exec times (§6.5)."""
    return synth_workload(cluster, load, n, n_functions=50,
                          hot_fraction=0.98, exec_dist="exponential",
                          exp_mean=8.9, seed=seed, name="homogeneous-exec")


# Bimodal class means (seconds).
BIMODAL_SHORT_S = 0.3
BIMODAL_LONG_S = 12.0


def bimodal_exec(cluster: ClusterCfg, load: float, n: int, seed: int = 0,
                 *, n_functions: int = 20, sigma: float = 0.25) -> Workload:
    """Bimodal per-function durations: even fns short, odd fns long."""
    rng = np.random.default_rng(seed)
    func = rng.integers(0, n_functions, size=n).astype(np.int32)
    base = np.where(func % 2 == 0, BIMODAL_SHORT_S, BIMODAL_LONG_S)
    service = base * rng.lognormal(mean=0.0, sigma=sigma, size=n)
    lam = load * cluster.total_cores / float(service.mean())
    arrival = np.cumsum(rng.exponential(scale=1.0 / lam, size=n))
    u_lb = rng.uniform(size=n)
    func_home = rng.integers(0, cluster.n_workers,
                             size=n_functions).astype(np.int32)
    return Workload(
        arrival=arrival.astype(np.float64), func=func,
        service=service.astype(np.float64), u_lb=u_lb,
        func_home=func_home, n_functions=n_functions, load=load,
        name="bimodal-exec")


WORKLOADS = {
    "ms-trace": ms_trace,
    "ms-representative": ms_representative,
    "single-function": single_function,
    "multi-balanced": multi_balanced,
    "homogeneous-exec": homogeneous_exec,
    "bimodal-exec": bimodal_exec,
}
