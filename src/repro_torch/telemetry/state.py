"""Telemetry plane 1, streaming in-engine metrics: the numpy side
(counterpart of ``repro/telemetry/state.py``).

The state is a plain dict of fixed-shape arrays.  The port's engines
carry the same keys as ``[R, …]`` tensors (:mod:`.engine`, as
``tel_<key>`` entries of the engine's state) and the fused kernel as
global tensors, and the update points follow the simulator's events:

=================  =======================================================
``on_place``       cold/warm counters, slot-pressure eviction counter, the
                   balancer decision histogram (one bump per placement)
``on_advance``     per-worker busy-time / queue-depth time integrals and
                   the central queue-length time integral (pre-advance
                   occupancy x tau, a left-Riemann integral, exact for
                   piecewise-constant occupancy)
``on_complete``    slowdown/latency histogram increment (only for tasks
                   past the warmup cutoff, ``summarize``'s population)
``on_evict``       keep-alive budget evictions (lifecycle plane)
``on_reject``      admission rejections
=================  =======================================================

The numpy updaters serve the host-side event loops (the serving
controller).  Counters are int64 and time integrals float64: the
integer planes are equal bit for bit across the engines, the float
integrals to 1e-9 relative against the JAX reference (whose compiler may
contract ``busy + tau * active`` into an FMA) and bit for bit between
the port's engines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple

import numpy as np

from .sketch import (N_BINS, bin_index_np, hist_edges, sketch_count,
                     sketch_percentile)


class TelemetryCfg(NamedTuple):
    """Opt-in telemetry configuration (hashable: part of the engine key).

    ``warmup_frac`` must match the ``warmup_frac`` later passed to
    ``summarize`` for the sketch population to equal the exact-percentile
    population; the default mirrors ``metrics.summarize``'s default.
    A mismatch raises :class:`WarmupMismatchError` at summarize time
    instead of silently skewing the comparison.
    """
    warmup_frac: float = 0.1


class WarmupMismatchError(ValueError):
    """The engine's ``TelemetryCfg.warmup_frac`` differs from the
    ``warmup_frac`` handed to ``summarize``/``summarize_batch``.

    The sketch population is fixed at engine time (``warmup_cutoff``);
    summarizing the same run with a different cutoff would compare two
    different task populations — a silent skew this error makes loud.
    """

    def __init__(self, engine_frac: float, summarize_frac: float):
        self.engine_frac = float(engine_frac)
        self.summarize_frac = float(summarize_frac)
        super().__init__(
            f"telemetry sketches were accumulated with warmup_frac="
            f"{engine_frac!r} but summarize was called with "
            f"warmup_frac={summarize_frac!r}; the two populations "
            f"differ — pass the same warmup_frac to both (or rerun the "
            f"engine with TelemetryCfg(warmup_frac={summarize_frac!r}))")


def init_np(n_workers: int) -> dict:
    """Fresh zeroed telemetry state for an ``n_workers``-wide cluster."""
    return {
        "slow_hist": np.zeros(N_BINS, dtype=np.int64),
        "lat_hist": np.zeros(N_BINS, dtype=np.int64),
        "n_cold": np.int64(0),
        "n_warm": np.int64(0),
        "n_evict": np.int64(0),
        "n_reject": np.int64(0),
        "busy_time": np.zeros(n_workers, dtype=np.float64),
        "depth_time": np.zeros(n_workers, dtype=np.float64),
        "qlen_time": np.float64(0.0),
        "decisions": np.zeros(n_workers, dtype=np.int64),
    }


# --------------------------------------------------------------------------
# Host-side update functions (mutate the dict in place; the torch engine
# in telemetry/engine.py performs the same arithmetic over [R, ...]).
# --------------------------------------------------------------------------

def on_place_np(tel: dict, worker: int, is_cold: bool,
                evicted: bool) -> None:
    if is_cold:
        tel["n_cold"] += 1
    else:
        tel["n_warm"] += 1
    if evicted:
        tel["n_evict"] += 1
    tel["decisions"][worker] += 1


def on_advance_np(tel: dict, tau: float, active_per_worker: np.ndarray,
                  depth_per_worker: np.ndarray, qlen: int) -> None:
    """Accumulate time integrals over a ``tau``-long constant interval.

    ``active_per_worker`` — workers with >= 1 running task (0/1);
    ``depth_per_worker`` — number of running tasks per worker; ``qlen``
    — central queue length.  All sampled *before* the advance, matching
    the engine's pre-advance occupancy convention for server/core time.
    """
    tel["busy_time"] += tau * np.asarray(active_per_worker,
                                         dtype=np.float64)
    tel["depth_time"] += tau * np.asarray(depth_per_worker,
                                          dtype=np.float64)
    tel["qlen_time"] += tau * float(qlen)


def on_complete_np(tel: dict, response_s: float, service_s: float,
                   arr_idx: int, cutoff: int) -> None:
    if arr_idx < cutoff:
        return
    slow = response_s / max(service_s, 1e-12)
    tel["slow_hist"][bin_index_np(slow)] += 1
    tel["lat_hist"][bin_index_np(response_s)] += 1


def on_evict_np(tel: dict, count: int = 1) -> None:
    tel["n_evict"] += count


def on_reject_np(tel: dict) -> None:
    tel["n_reject"] += 1


# --------------------------------------------------------------------------
# Result wrapper
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TelemetryResult:
    """Materialized telemetry from one run (or a batch, pooled on read).

    Array fields keep whatever leading batch axes the engine produced
    (``[R, ...]`` from ``simulate_many``); the percentile/summary readers
    pool across them, mirroring ``summarize_batch``'s pooled statistics.
    """
    slow_hist: np.ndarray
    lat_hist: np.ndarray
    n_cold: np.ndarray
    n_warm: np.ndarray
    n_evict: np.ndarray
    n_reject: np.ndarray
    busy_time: np.ndarray
    depth_time: np.ndarray
    qlen_time: np.ndarray
    decisions: np.ndarray
    cfg: TelemetryCfg = TelemetryCfg()

    @staticmethod
    def from_state(tel: Mapping[str, Any],
                   cfg: TelemetryCfg = TelemetryCfg()) -> "TelemetryResult":
        return TelemetryResult(
            slow_hist=np.asarray(tel["slow_hist"], dtype=np.int64),
            lat_hist=np.asarray(tel["lat_hist"], dtype=np.int64),
            n_cold=np.asarray(tel["n_cold"], dtype=np.int64),
            n_warm=np.asarray(tel["n_warm"], dtype=np.int64),
            n_evict=np.asarray(tel["n_evict"], dtype=np.int64),
            n_reject=np.asarray(tel["n_reject"], dtype=np.int64),
            busy_time=np.asarray(tel["busy_time"], dtype=np.float64),
            depth_time=np.asarray(tel["depth_time"], dtype=np.float64),
            qlen_time=np.asarray(tel["qlen_time"], dtype=np.float64),
            decisions=np.asarray(tel["decisions"], dtype=np.int64),
            cfg=cfg,
        )

    # -- streaming percentile reads (pooled over any batch axes) --------
    def slow_percentile(self, q: float) -> float:
        return sketch_percentile(self.slow_hist, q)

    def lat_percentile(self, q: float) -> float:
        return sketch_percentile(self.lat_hist, q)

    def summary(self) -> dict:
        """Compact JSON-friendly digest (used by reports / manifests)."""
        n_obs = sketch_count(self.slow_hist)
        n_cold = int(self.n_cold.sum())
        n_warm = int(self.n_warm.sum())
        placed = n_cold + n_warm
        return {
            "n_observed": n_obs,
            "slow_p50": _r(self.slow_percentile(50.0)),
            "slow_p99": _r(self.slow_percentile(99.0)),
            "lat_p50_s": _r(self.lat_percentile(50.0)),
            "lat_p99_s": _r(self.lat_percentile(99.0)),
            "n_cold": n_cold,
            "n_warm": n_warm,
            "cold_frac": _r(n_cold / placed) if placed else 0.0,
            "n_evict": int(self.n_evict.sum()),
            "n_reject": int(self.n_reject.sum()),
            "busy_time_s": _r(float(self.busy_time.sum())),
            "qlen_time_s": _r(float(np.asarray(self.qlen_time).sum())),
            "decision_max_frac": _r(
                float(self.decisions.sum(axis=tuple(
                    range(self.decisions.ndim - 1))).max()) / placed
            ) if placed else 0.0,
        }

    # -- batch accessors (mirror BatchSimOutput.rep / slicing) ----------
    def rep(self, r: int) -> "TelemetryResult":
        return self[r]

    def __getitem__(self, idx) -> "TelemetryResult":
        kw = {f.name: getattr(self, f.name)[idx]
              for f in dataclasses.fields(self) if f.name != "cfg"}
        return TelemetryResult(cfg=self.cfg, **kw)


def _r(x: float, nd: int = 6) -> float:
    return float("nan") if isinstance(x, float) and math.isnan(x) \
        else round(float(x), nd)


def warmup_cutoff(n_arrivals: int, cfg: TelemetryCfg) -> int:
    """Static warmup cutoff index — the histogram population starts here.

    Matches ``summarize``'s ``lo = int(n * warmup_frac)`` drop exactly.
    """
    return int(n_arrivals * cfg.warmup_frac)


__all__ = [
    "TelemetryCfg", "TelemetryResult", "WarmupMismatchError", "init_np",
    "warmup_cutoff",
    "on_place_np", "on_advance_np", "on_complete_np", "on_evict_np",
    "on_reject_np", "hist_edges", "N_BINS",
]
