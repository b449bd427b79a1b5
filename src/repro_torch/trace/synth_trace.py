"""Deterministic generator of trace files in the Azure schema
(counterpart of ``repro/trace/synth_trace.py``, drawing in its exact
order).

The released Azure Functions 2019 dataset is >1 GB and cannot ship with
the repo, so scenario traces are *synthesized in the dataset's own
schema* — per-function per-minute invocation counts plus per-function
duration percentiles — and round-trip through exactly the same
:mod:`repro_torch.trace.schema` / :mod:`repro_torch.trace.replay` path a
real dataset slice would.  Four presets cover the non-stationary regimes
the stationary Poisson generators in :mod:`repro_torch.core.workload`
cannot express:

``diurnal``
    Zipf-weighted functions riding a sinusoidal daily cycle with
    per-function phase offsets — the dominant shape of the real trace
    (Shahrad et al. §3.3).
``bursty``
    Low Poisson baseline with per-function on/off burst windows at
    ~12× the base rate (MMPP-style), stressing reactive balancing.
``cold-heavy``
    80 % of functions invoked rarely (well below keep-alive periods) so
    most arrivals cold-start; 20 % carry the bulk of the load.
``flash-crowd``
    Flat background plus one function spiking ~40× for a short window
    mid-trace — the worst case for locality-first placement.

Counts are Poisson draws around the scenario intensity profile,
normalized so the expected total invocation count hits
``total_invocations``; everything is a pure function of ``seed``.
Durations are per-function Log-normals whose percentile columns are
materialized analytically (:func:`repro_torch.trace.schema
.lognormal_percentiles_ms`), so :func:`repro_torch.trace.replay
.fit_lognormal_from_percentiles` recovers the parameters exactly.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import os

import numpy as np

from .schema import (AzureTrace, DURATION_COLUMNS, DURATION_PERCENTILES,
                     INVOCATION_FIXED_COLUMNS, TraceFunction,
                     lognormal_percentiles_ms)

_TRIGGERS = ("http", "timer", "queue", "event", "storage")


@dataclasses.dataclass(frozen=True)
class ScenarioCfg:
    """Preset defaults for one synthetic-trace scenario."""

    name: str
    description: str
    n_functions: int = 40
    minutes: int = 180


SCENARIOS = {
    "diurnal": ScenarioCfg(
        "diurnal", "Zipf skew on a sinusoidal daily cycle"),
    "bursty": ScenarioCfg(
        "bursty", "low baseline with ~12x on/off burst windows"),
    "cold-heavy": ScenarioCfg(
        "cold-heavy", "80% of functions too rare to stay warm",
        n_functions=60),
    "flash-crowd": ScenarioCfg(
        "flash-crowd", "flat background + one ~40x mid-trace spike"),
}


def _zipf_weights(n: int, s: float = 1.1) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def _intensity(scenario: str, n_functions: int, minutes: int,
               rng: np.random.Generator) -> np.ndarray:
    """Unnormalized ``(F, T)`` mean-invocation-rate profile."""
    F, T = n_functions, minutes
    m = np.arange(T)
    if scenario == "diurnal":
        w = _zipf_weights(F)
        period = min(T, 1440)
        phase = rng.uniform(0, 2 * math.pi, size=F)
        cycle = 1.0 + 0.8 * np.sin(
            2 * math.pi * m[None, :] / period + phase[:, None])
        return w[:, None] * cycle
    if scenario == "bursty":
        base = _zipf_weights(F, s=0.7)[:, None] * np.ones(T)[None, :]
        burst = np.zeros((F, T))
        for f in range(F):
            n_bursts = rng.integers(1, 4)
            for _ in range(n_bursts):
                start = int(rng.integers(0, T))
                width = int(rng.integers(max(2, T // 60), max(3, T // 12)))
                burst[f, start:start + width] = 1.0
        return base * (1.0 + 11.0 * burst)
    if scenario == "cold-heavy":
        n_hot = max(1, F // 5)
        w = np.full(F, 0.2 / max(F - n_hot, 1))
        w[:n_hot] = 0.8 / n_hot
        jitter = rng.uniform(0.5, 1.5, size=(F, T))
        return w[:, None] * jitter
    if scenario == "flash-crowd":
        w = _zipf_weights(F, s=0.5)
        prof = w[:, None] * np.ones(T)[None, :]
        start = int(0.45 * T)
        width = max(2, T // 20)
        spike_f = min(2, F - 1)  # a mid-rank function goes viral
        prof[spike_f, start:start + width] *= 40.0
        return prof
    raise ValueError(
        f"unknown scenario {scenario!r}; expected one of "
        f"{sorted(SCENARIOS)}")


def synthesize_trace(scenario: str, *, n_functions: int | None = None,
                     minutes: int | None = None,
                     total_invocations: int = 20000,
                     seed: int = 0) -> AzureTrace:
    """Generate an :class:`AzureTrace` for a named scenario preset.

    Deterministic in ``(scenario, n_functions, minutes,
    total_invocations, seed)``.  ``total_invocations`` is the *expected*
    total count (realized counts are Poisson).
    """
    cfg = SCENARIOS.get(scenario)
    if cfg is None:
        raise ValueError(
            f"unknown scenario {scenario!r}; expected one of "
            f"{sorted(SCENARIOS)}")
    F = n_functions if n_functions is not None else cfg.n_functions
    T = minutes if minutes is not None else cfg.minutes
    if F < 1 or T < 1:
        raise ValueError(f"need n_functions, minutes >= 1; got ({F}, {T})")
    rng = np.random.default_rng(seed)
    intensity = _intensity(scenario, F, T, rng)
    intensity = intensity * (total_invocations / max(intensity.sum(), 1e-12))
    counts = rng.poisson(intensity).astype(np.int64)

    # Per-function Log-normal duration parameters (log-space, seconds).
    # sigma capped well below the trace-wide 2.36 so per-function p99
    # stays under the 10-min platform timeout and replayed percentiles
    # are statistically recoverable from a few thousand samples.
    mu = rng.normal(-0.4, 0.8, size=F)
    sigma = rng.uniform(0.4, 1.5, size=F)

    funcs = []
    for f in range(F):
        pct = lognormal_percentiles_ms(float(mu[f]), float(sigma[f]))
        funcs.append(TraceFunction(
            owner=f"owner{seed:04d}", app=f"app{f // 8:03d}",
            func=f"fn{f:04d}-{scenario}",
            trigger=_TRIGGERS[f % len(_TRIGGERS)],
            counts=counts[f],
            duration_ms=pct,
            average_ms=1000.0 * math.exp(
                float(mu[f]) + float(sigma[f]) ** 2 / 2),
            count=int(counts[f].sum()),
            minimum_ms=pct[0], maximum_ms=pct[100]))
    return AzureTrace(functions=tuple(funcs), minutes=T)


def write_trace_csvs(trace: AzureTrace, invocations_csv: str,
                     durations_csv: str) -> None:
    """Emit a trace as the two Azure-schema CSV files.

    Floats are written with ``repr`` so parse → write → parse is exact.
    """
    for path in (invocations_csv, durations_csv):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    with open(invocations_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(list(INVOCATION_FIXED_COLUMNS)
                   + [str(i + 1) for i in range(trace.minutes)])
        for fn in trace.functions:
            w.writerow([fn.owner, fn.app, fn.func, fn.trigger]
                       + [int(c) for c in fn.counts])
    with open(durations_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(list(DURATION_COLUMNS))
        for fn in trace.functions:
            w.writerow([fn.owner, fn.app, fn.func,
                        repr(fn.average_ms), fn.count,
                        repr(fn.minimum_ms), repr(fn.maximum_ms)]
                       + [repr(fn.duration_ms[p])
                          for p in DURATION_PERCENTILES])


def write_fixture(out_dir: str, *, scenario: str = "diurnal",
                  n_functions: int = 12, minutes: int = 60,
                  total_invocations: int = 2500, seed: int = 2019) -> tuple:
    """(Re)generate the bundled fixture slice under
``repro_torch/trace/data``."""
    inv = os.path.join(out_dir, "azure_fixture_invocations.csv")
    dur = os.path.join(out_dir, "azure_fixture_durations.csv")
    trace = synthesize_trace(scenario, n_functions=n_functions,
                             minutes=minutes,
                             total_invocations=total_invocations, seed=seed)
    write_trace_csvs(trace, inv, dur)
    return inv, dur


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(__file__), "data")
    paths = write_fixture(out)
    print("\n".join(paths))
