"""Trace → ``Workload`` reconstruction for the simulator (counterpart of
``repro/trace/replay.py``).

Two reconstruction halves (both deterministic in ``seed``):

* **Arrivals** are *per-minute-count-exact*: every function's invocation
  count in every minute of the trace is honored exactly — each of the
  ``c`` invocations of function ``f`` in minute ``m`` lands uniformly at
  random inside ``[60m, 60(m+1))``.  Non-stationarity (diurnal cycles,
  bursts, flash crowds) is therefore preserved by construction, unlike
  the stationary Poisson generators in :mod:`repro_torch.core.workload`.
* **Durations** are sampled from a per-function Log-normal fitted by
  least squares in log space to the trace's ``percentile_Average_*``
  columns (the 1/25/50/75/99 points; 0/100 are sample min/max and are
  excluded), truncated at the platform timeout like
  :func:`repro_torch.core.workload.synth_workload`.

Offered-load targeting uses *time compression*: scaling every arrival
time by ``α`` leaves the count-per-(scaled)-minute structure and the
shape of the non-stationarity intact while sweeping the offered-load
fraction — the trace analogue of the paper's "scale the number of
invocations to produce different load levels" (§6.1).  Traces shorter
than the requested ``n_arrivals`` are tiled whole-trace-at-a-time with
fresh per-repeat randomness.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.cluster import ClusterCfg
from repro_torch.core.workload import (Workload, WorkloadBatch,
                                       stack_workloads)

from .schema import AZURE_MU, AZURE_SIGMA, AzureTrace, norm_ppf

MINUTE_S = 60.0

# Fit on the interior percentiles only: 0/100 are the min/max of a
# finite sample, not distribution quantiles.
_FIT_PERCENTILES = (1, 25, 50, 75, 99)
_FIT_Z = np.array([norm_ppf(p / 100.0) for p in _FIT_PERCENTILES])


def fit_lognormal_from_percentiles(duration_ms: dict) -> tuple[float, float]:
    """Least-squares Log-normal fit ``(mu, sigma)`` (log-space, seconds).

    Solves ``ln(p_q) = mu + sigma * z_q`` over the interior percentile
    points.  Degenerate inputs (constant or non-positive percentiles)
    collapse to ``sigma = 0`` around the median.
    """
    pts = [(z, duration_ms.get(p)) for z, p in zip(_FIT_Z, _FIT_PERCENTILES)]
    pts = [(z, v) for z, v in pts if v is not None and v > 0]
    if not pts:
        raise ValueError(
            f"no positive interior percentiles to fit: {duration_ms}")
    z = np.array([p[0] for p in pts])
    y = np.log(np.array([p[1] for p in pts]) / 1000.0)
    if len(pts) == 1 or np.allclose(y, y[0]):
        return float(y.mean()), 0.0
    zc = z - z.mean()
    sigma = float((zc * (y - y.mean())).sum() / (zc * zc).sum())
    sigma = max(sigma, 0.0)
    mu = float(y.mean() - sigma * z.mean())
    return mu, sigma


def _minute_exact_arrivals(counts: np.ndarray, rng: np.random.Generator,
                           t_offset_minutes: int) -> tuple:
    """Sorted arrival times + function ids honoring ``(F, T)`` counts."""
    f_ids, m_ids = np.nonzero(counts)
    c = counts[f_ids, m_ids]
    f_rep = np.repeat(f_ids, c).astype(np.int32)
    m_rep = np.repeat(m_ids, c)
    t = (m_rep + t_offset_minutes) * MINUTE_S \
        + rng.uniform(0.0, MINUTE_S, size=int(c.sum()))
    order = np.argsort(t, kind="stable")
    return t[order], f_rep[order]


def replay_trace(trace: AzureTrace, cluster: ClusterCfg, *,
                 load: float | None = None, n_arrivals: int | None = None,
                 seed: int = 0, max_service: float = 600.0,
                 name: str | None = None) -> Workload:
    """Reconstruct a :class:`~repro_torch.core.workload.Workload` from a
    trace.

    ``load`` — target offered-load fraction of cluster capacity, reached
    by uniformly compressing/stretching arrival times (``None`` keeps
    real time: one trace minute = 60 s, and ``Workload.load`` records the
    realized fraction).  ``n_arrivals`` — exact invocation count to emit;
    the trace is tiled whole-trace-at-a-time when shorter and truncated
    when longer (``None`` replays the trace once, verbatim).
    """
    counts = trace.counts_matrix()
    total = int(counts.sum())
    if total == 0:
        raise ValueError("trace has zero invocations; nothing to replay")
    F = trace.n_functions
    rng = np.random.default_rng(seed)

    need = total if n_arrivals is None else int(n_arrivals)
    if need < 1:
        raise ValueError(f"n_arrivals must be >= 1, got {n_arrivals}")
    t_chunks, f_chunks, produced, rep = [], [], 0, 0
    while produced < need:
        t, f = _minute_exact_arrivals(counts, rng, rep * trace.minutes)
        t_chunks.append(t)
        f_chunks.append(f)
        produced += len(t)
        rep += 1
    arrival = np.concatenate(t_chunks)[:need]
    func = np.concatenate(f_chunks)[:need]

    mus = np.empty(F)
    sigmas = np.empty(F)
    for i, fn in enumerate(trace.functions):
        try:
            mus[i], sigmas[i] = \
                fit_lognormal_from_percentiles(fn.duration_ms)
        except ValueError:
            # real Azure rows can be all-zero (Count=0 / sub-ms
            # functions); fall back to the trace-wide default, as
            # load_trace does for missing duration rows
            mus[i], sigmas[i] = AZURE_MU, AZURE_SIGMA
    service = np.exp(mus[func] + sigmas[func] * rng.standard_normal(need))
    service = np.minimum(service, max_service)

    horizon = float(arrival[-1])
    if horizon <= 0.0:
        raise ValueError("degenerate trace: all arrivals at t=0")
    realized = float(service.sum()) / (horizon * cluster.total_cores)
    if load is not None:
        if load <= 0:
            raise ValueError(f"load must be positive, got {load}")
        arrival = arrival * (realized / load)
    return Workload(
        arrival=arrival.astype(np.float64),
        func=func,
        service=service.astype(np.float64),
        u_lb=rng.uniform(size=need),
        func_home=rng.integers(0, cluster.n_workers,
                               size=F).astype(np.int32),
        n_functions=F,
        load=float(load) if load is not None else realized,
        name=name or "trace-replay",
    )


def per_minute_counts(wl: Workload, n_functions: int, minutes: int, *,
                      minute_s: float = MINUTE_S) -> np.ndarray:
    """Histogram a workload back into an ``(F, T)`` count matrix.

    The inverse of the arrival half of :func:`replay_trace` (with
    ``load=None`` and no tiling/truncation it reproduces
    ``trace.counts_matrix()`` exactly).  Arrivals past ``minutes`` fold
    back modulo the trace length, undoing whole-trace tiling.
    """
    m = np.floor(wl.arrival / minute_s).astype(np.int64) % minutes
    out = np.zeros((n_functions, minutes), dtype=np.int64)
    np.add.at(out, (wl.func, m), 1)
    return out


def resample_workloads(wls, *, n: int | None = None) -> WorkloadBatch:
    """Resample heterogeneous workloads onto one ``(N, F)`` batch shape.

    Trace replays of different scenarios/files rarely agree on arrival
    count or function count, but :func:`repro_torch.core.simulator
    .simulate_many` needs one ``(N, F)`` shape per batch.  This truncates
    every workload to ``n`` arrivals (default: the smallest ``N`` in the
    set — truncation only, never padding: padded phantom arrivals would
    perturb the schedule) and widens ``n_functions`` to the largest ``F``
    (absent function ids never occur in ``func``, so their padded sticky
    homes — worker 0 — are inert).
    """
    wls = list(wls)
    if not wls:
        raise ValueError("resample_workloads needs at least one workload")
    n_min = min(wl.n for wl in wls)
    n = n_min if n is None else int(n)
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    if n > n_min:
        raise ValueError(
            f"cannot resample up: requested n={n} but the shortest "
            f"workload ({min(wls, key=lambda w: w.n).name!r}) has only "
            f"{n_min} arrivals")
    F = max(wl.n_functions for wl in wls)
    out = []
    for wl in wls:
        home = wl.func_home
        if wl.n_functions < F:
            home = np.concatenate([
                home, np.zeros(F - wl.n_functions, dtype=np.int32)])
        out.append(dataclasses.replace(
            wl, arrival=wl.arrival[:n], func=wl.func[:n],
            service=wl.service[:n], u_lb=wl.u_lb[:n],
            func_home=home, n_functions=F))
    return stack_workloads(out)
