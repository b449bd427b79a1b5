"""Azure Functions 2019 trace schema: CSV parsing + validation
(counterpart of ``repro/trace/schema.py``).

The released dataset (Shahrad et al., ATC'20 — the trace behind the
paper's §3/§6 evaluation) ships two per-day CSV families this package
consumes:

* ``invocations_per_function_md.anon.dXX.csv`` — one row per function,
  key columns ``HashOwner,HashApp,HashFunction,Trigger`` followed by
  ``1..1440`` integer invocation counts, one per minute of the day.
* ``function_durations_percentiles.anon.dXX.csv`` — one row per
  function: ``Average,Count,Minimum,Maximum`` plus
  ``percentile_Average_{0,1,25,50,75,99,100}`` execution durations in
  **milliseconds**.

This module is numpy-only, and its single ``repro_torch.core``
dependency is the paper's Log-normal constants (``repro_torch.core``
never imports the simulator at package level, so nothing heavy is
dragged in).  Everything is
validated up front — header layout, contiguous minute columns,
non-negative integer counts, percentile monotonicity, key joins — so a
malformed file fails with a named ``ValueError`` instead of a downstream
shape error.
"""
from __future__ import annotations

import csv
import dataclasses
import math

import numpy as np

HASH_COLUMNS = ("HashOwner", "HashApp", "HashFunction")
INVOCATION_FIXED_COLUMNS = HASH_COLUMNS + ("Trigger",)
DURATION_PERCENTILES = (0, 1, 25, 50, 75, 99, 100)
DURATION_COLUMNS = HASH_COLUMNS + ("Average", "Count", "Minimum", "Maximum") \
    + tuple(f"percentile_Average_{p}" for p in DURATION_PERCENTILES)

# Azure-trace Log-normal parameters (paper Fig. 2 caption) — the default
# duration distribution for functions missing a durations row.  Single
# source of truth is repro_torch.core.workload; re-exported here for
# trace-side consumers.
from repro_torch.core.workload import AZURE_MU, AZURE_SIGMA  # noqa: E402,F401


def norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    |relative error| < 1.15e-9 over (0, 1); keeps the package scipy-free.
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"norm_ppf needs p in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
            * r + 1)


# z-scores used to materialize the Azure percentile columns from a
# Log-normal.  p0/p100 are the *observed* min/max of a finite sample —
# modeled at the ±(1 - 1e-3) quantile rather than ±inf.
_PCTL_Z = {0: norm_ppf(1e-3), 1: norm_ppf(0.01), 25: norm_ppf(0.25),
           50: 0.0, 75: norm_ppf(0.75), 99: norm_ppf(0.99),
           100: norm_ppf(1 - 1e-3)}


def lognormal_percentiles_ms(mu: float, sigma: float) -> dict[int, float]:
    """Azure ``percentile_Average_*`` columns (ms) of a Log-normal whose
    log-space parameters ``mu, sigma`` are in *seconds*."""
    return {p: 1000.0 * math.exp(mu + sigma * z)
            for p, z in _PCTL_Z.items()}


@dataclasses.dataclass(frozen=True)
class TraceFunction:
    """One function of an Azure-schema trace (joined across both files)."""

    owner: str
    app: str
    func: str
    trigger: str
    counts: np.ndarray          # (T,) int64 invocations per minute
    duration_ms: dict           # percentile (int) -> duration in ms
    average_ms: float
    count: int                  # dataset-reported execution count
    minimum_ms: float
    maximum_ms: float

    @property
    def total_invocations(self) -> int:
        return int(self.counts.sum())

    @property
    def key(self) -> tuple:
        return (self.owner, self.app, self.func)


@dataclasses.dataclass(frozen=True)
class AzureTrace:
    """A parsed trace slice: ``F`` functions over ``T`` minutes."""

    functions: tuple            # (F,) TraceFunction, invocation-file order
    minutes: int                # T

    @property
    def n_functions(self) -> int:
        return len(self.functions)

    @property
    def total_invocations(self) -> int:
        return sum(f.total_invocations for f in self.functions)

    def counts_matrix(self) -> np.ndarray:
        """The ``(F, T)`` per-minute invocation-count matrix."""
        if not self.functions:
            return np.zeros((0, self.minutes), dtype=np.int64)
        return np.stack([f.counts for f in self.functions])


def _read_rows(path: str) -> tuple[list, list]:
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        rows = [row for row in reader if row]
    if not rows:
        raise ValueError(f"{path}: empty trace file")
    return rows[0], rows[1:]


def read_invocations(path: str) -> tuple[list, int]:
    """Parse an Azure invocations-per-minute CSV.

    Returns ``(entries, minutes)`` with one
    ``(key, trigger, counts[int64 T])`` tuple per row, in file order.
    """
    header, rows = _read_rows(path)
    k = len(INVOCATION_FIXED_COLUMNS)
    if tuple(header[:k]) != INVOCATION_FIXED_COLUMNS:
        raise ValueError(
            f"{path}: invocation header must start with "
            f"{','.join(INVOCATION_FIXED_COLUMNS)}; got {header[:k]}")
    minute_cols = header[k:]
    if not minute_cols:
        raise ValueError(f"{path}: no per-minute count columns")
    expected = [str(i + 1) for i in range(len(minute_cols))]
    if minute_cols != expected:
        raise ValueError(
            f"{path}: minute columns must be contiguous 1..{len(expected)}; "
            f"got {minute_cols[:5]}...")
    minutes = len(minute_cols)
    entries, seen = [], set()
    for i, row in enumerate(rows):
        if len(row) != k + minutes:
            raise ValueError(
                f"{path} row {i + 2}: expected {k + minutes} cells, "
                f"got {len(row)}")
        key = tuple(row[:3])
        if key in seen:
            raise ValueError(f"{path} row {i + 2}: duplicate function {key}")
        seen.add(key)
        try:
            counts = np.array([int(c) for c in row[k:]], dtype=np.int64)
        except ValueError as e:
            raise ValueError(
                f"{path} row {i + 2}: non-integer invocation count "
                f"({e})") from None
        if (counts < 0).any():
            raise ValueError(
                f"{path} row {i + 2}: negative invocation count")
        entries.append((key, row[3], counts))
    return entries, minutes


def read_durations(path: str) -> dict:
    """Parse an Azure duration-percentiles CSV into ``{key: stats}``."""
    header, rows = _read_rows(path)
    if tuple(header) != DURATION_COLUMNS:
        raise ValueError(
            f"{path}: duration header must be exactly "
            f"{','.join(DURATION_COLUMNS)}; got {header}")
    out = {}
    for i, row in enumerate(rows):
        if len(row) != len(DURATION_COLUMNS):
            raise ValueError(
                f"{path} row {i + 2}: expected {len(DURATION_COLUMNS)} "
                f"cells, got {len(row)}")
        key = tuple(row[:3])
        if key in out:
            raise ValueError(f"{path} row {i + 2}: duplicate function {key}")
        try:
            avg, cnt = float(row[3]), int(float(row[4]))
            mn, mx = float(row[5]), float(row[6])
            pct = {p: float(v)
                   for p, v in zip(DURATION_PERCENTILES, row[7:])}
        except ValueError as e:
            raise ValueError(
                f"{path} row {i + 2}: malformed numeric cell ({e})"
            ) from None
        if cnt < 0:
            raise ValueError(f"{path} row {i + 2}: negative Count")
        if mn > mx:
            raise ValueError(
                f"{path} row {i + 2}: Minimum {mn} > Maximum {mx}")
        vals = [pct[p] for p in DURATION_PERCENTILES]
        if any(v < 0 for v in vals):
            raise ValueError(f"{path} row {i + 2}: negative percentile")
        if any(a > b for a, b in zip(vals, vals[1:])):
            raise ValueError(
                f"{path} row {i + 2}: percentiles not non-decreasing: "
                f"{vals}")
        out[key] = dict(average_ms=avg, count=cnt, minimum_ms=mn,
                        maximum_ms=mx, duration_ms=pct)
    return out


def load_trace(invocations_csv: str, durations_csv: str, *,
               allow_missing_durations: bool = False) -> AzureTrace:
    """Join the two Azure files into an :class:`AzureTrace`.

    Functions present in the invocations file but missing a durations row
    raise by default (the bundled/synthetic traces are always complete);
    ``allow_missing_durations=True`` substitutes the trace-wide Azure
    Log-normal default instead — the pragmatic choice on real dataset
    slices, where the join is imperfect.  Duration rows with no matching
    invocation row are ignored (the real dataset has those too).
    """
    entries, minutes = read_invocations(invocations_csv)
    durations = read_durations(durations_csv)
    default = None
    funcs, missing = [], []
    for key, trigger, counts in entries:
        stats = durations.get(key)
        if stats is None:
            if not allow_missing_durations:
                missing.append(key)
                continue
            if default is None:
                pct = lognormal_percentiles_ms(AZURE_MU, AZURE_SIGMA)
                default = dict(
                    average_ms=1000.0 * math.exp(
                        AZURE_MU + AZURE_SIGMA ** 2 / 2),
                    count=0, minimum_ms=pct[0], maximum_ms=pct[100],
                    duration_ms=pct)
            # fresh duration_ms per function — no aliasing across the
            # frozen TraceFunction instances
            stats = {**default, "duration_ms": dict(default["duration_ms"])}
        funcs.append(TraceFunction(
            owner=key[0], app=key[1], func=key[2], trigger=trigger,
            counts=counts, **stats))
    if missing:
        raise ValueError(
            f"{durations_csv}: no duration row for {len(missing)} "
            f"function(s) present in {invocations_csv} "
            f"(first: {missing[0]}); pass allow_missing_durations=True "
            f"to substitute the Azure default Log-normal")
    return AzureTrace(functions=tuple(funcs), minutes=minutes)
