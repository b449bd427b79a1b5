"""Telemetry plane 4, the windowed time-series flight recorder: the
numpy side (counterpart of ``repro/telemetry/timeline.py``).

Run-aggregate telemetry (:mod:`.state`) collapses a whole run into one
sketch; this plane keeps a *time-resolved* view: the virtual-time
horizon is cut into a fixed number ``K`` of equal windows and every
counter, sketch and integral is accumulated per window.  The state is a
plain dict of fixed-shape numpy arrays.  The batched engine carries the
same keys as ``[R, …]`` tensors (:mod:`.timeline_engine`, as ``tl_<key>``
entries of its state) and the fused ``sim_engine`` kernel in its
timeline plane, so a comparison is a per-key array compare.

Window layout (``K`` windows × ``B`` coarse bins × ``W`` workers):

=================  ========  ==========================================
``window_s``       f64       runtime window width (horizon / K if auto)
``arrivals``       [K] i64   arrivals whose time falls in the window
``n_cold/warm``    [K] i64   placements by warm-pool outcome
``n_evict``        [K] i64   capacity + keep-alive evictions
``n_reject``       [K] i64   admission rejections
``slow_hist``      [K,B] i64 per-window slowdown sketch (coarsened)
``lat_hist``       [K,B] i64 per-window latency sketch (coarsened)
``busy_time``      [K,W] f64 per-worker busy-time integral
``qlen_time``      [K] f64   central queue-length time integral
``prov_core``      [K] f64   provisioned core-seconds integral
``n_on``           [K] i32   active-worker count (last write wins)
``mode``           i32       hybrid-balancer mode carry (1 = low load)
``ev_*``           [E]       bounded decision-event log (see below)
=================  ========  ==========================================

Attribution conventions (the same in every engine, so the planes are
equal bit for bit by construction):

* advance-time integrals (busy/qlen/provisioned) credit the window of
  the *interval start*, the same left-Riemann convention as
  ``server_time``;
* completions credit the window of the completion time;
* arrivals, placements and rejections credit the window of the arrival
  time; events at or past the horizon clamp into the last window (the
  end-of-run drain).

Unlike the run-aggregate sketches, the per-window sketches record *all*
completions (no warmup cutoff): the flight recorder shows the ramp-up.

The decision-event log records every autoscaler grow/shrink (kind 0,
with the sensor p99 the controller read) and every hybrid-balancer
pack↔spread mode flip (kind 1).  It is bounded at ``max_events``
entries; ``ev_count`` keeps counting past the bound so truncation is
visible (``n_events_dropped`` in :meth:`TimelineResult.summary`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple

import numpy as np

from .sketch import N_BINS, bin_index_np, hist_edges, sketch_percentile
from .state import _r

#: Decision-event kinds recorded in the bounded log.
EV_AUTOSCALE = 0   # autoscaler changed n_on; ev_val = new n_on
EV_MODE_FLIP = 1   # hybrid balancer flipped pack<->spread; ev_val = mode


class TimelineCfg(NamedTuple):
    """Opt-in timeline configuration (hashable: part of the engine key).

    ``n_windows`` fixes the number ``K`` of virtual-time windows;
    ``window_s`` the window width in virtual seconds (``0.0`` = auto:
    the horizon — last arrival time — divided by ``K``, computed at run
    time so one compiled engine serves any horizon); ``coarse_bins``
    the per-window sketch resolution (must divide the ``N_BINS``-bin
    edge grid so coarse bins are exact groups of fine bins — integer
    bin coarsening keeps the engines equal bit for bit); ``max_events``
    bounds the decision-event log.
    """
    n_windows: int = 64
    window_s: float = 0.0
    coarse_bins: int = 96
    max_events: int = 256


def validate_timeline(cfg: TimelineCfg) -> TimelineCfg:
    """Named errors instead of silent bad shapes downstream."""
    if int(cfg.n_windows) < 1:
        raise ValueError(
            f"TimelineCfg.n_windows must be >= 1, got {cfg.n_windows}")
    if int(cfg.max_events) < 1:
        raise ValueError(
            f"TimelineCfg.max_events must be >= 1, got {cfg.max_events}")
    b = int(cfg.coarse_bins)
    if b < 1 or N_BINS % b != 0:
        raise ValueError(
            f"TimelineCfg.coarse_bins must be a positive divisor of the "
            f"{N_BINS}-bin sketch grid (so coarse bins are exact groups "
            f"of fine bins), got {cfg.coarse_bins}")
    return cfg


def coarse_group(cfg: TimelineCfg) -> int:
    """Fine bins per coarse bin (``N_BINS // coarse_bins``)."""
    return N_BINS // int(cfg.coarse_bins)


def coarse_edges(cfg: TimelineCfg) -> np.ndarray:
    """The ``[coarse_bins + 1]`` edge subgrid of :func:`hist_edges`."""
    return hist_edges()[::coarse_group(cfg)]


def auto_window_s(horizon: float, cfg: TimelineCfg) -> float:
    """The runtime window width: configured, or horizon / K.

    Every engine computes this as one f64 division of the same operands,
    so the width, and therefore every window index, is the same bits in
    all of them.
    """
    if float(cfg.window_s) > 0.0:
        return float(cfg.window_s)
    return float(horizon) / float(int(cfg.n_windows))


def window_index_np(now: float, window_s: float, n_windows: int) -> int:
    """Window of virtual time ``now``: ``clip(floor(now / w), 0, K-1)``.

    A non-positive width (degenerate horizon) maps everything into
    window 0; times at/past the horizon clamp into the last window (the
    drain tail).  The torch twin and the kernel make the same f64
    division, floor and clip.
    """
    if not window_s > 0.0:
        return 0
    k = math.floor(float(now) / float(window_s))
    return int(min(max(k, 0), int(n_windows) - 1))


def init_tl_np(n_workers: int, cfg: TimelineCfg,
               window_s: float) -> dict:
    """Fresh zeroed timeline state (the per-replication rows of
    ``timeline_engine.init_state``, with the runtime window width)."""
    K, B, E = int(cfg.n_windows), int(cfg.coarse_bins), int(cfg.max_events)
    return {
        "window_s": np.float64(window_s),
        # hybrid-balancer mode carry; an empty cluster is low-load, so
        # starting at 1 records no spurious flip on the first arrival
        "mode": np.int32(1),
        "arrivals": np.zeros(K, dtype=np.int64),
        "n_cold": np.zeros(K, dtype=np.int64),
        "n_warm": np.zeros(K, dtype=np.int64),
        "n_evict": np.zeros(K, dtype=np.int64),
        "n_reject": np.zeros(K, dtype=np.int64),
        "slow_hist": np.zeros((K, B), dtype=np.int64),
        "lat_hist": np.zeros((K, B), dtype=np.int64),
        "busy_time": np.zeros((K, n_workers), dtype=np.float64),
        "qlen_time": np.zeros(K, dtype=np.float64),
        "prov_core": np.zeros(K, dtype=np.float64),
        "n_on": np.zeros(K, dtype=np.int32),
        "ev_t": np.zeros(E, dtype=np.float64),
        "ev_kind": np.zeros(E, dtype=np.int32),
        "ev_val": np.zeros(E, dtype=np.int32),
        "ev_p99": np.full(E, np.nan, dtype=np.float64),
        "ev_count": np.int64(0),
    }


def _widx(tl: dict, t: float) -> int:
    return window_index_np(t, float(tl["window_s"]),
                           tl["arrivals"].shape[0])


# --------------------------------------------------------------------------
# Host-side update functions (mutate the dict in place; the batched engine
# in timeline_engine.py makes the same arithmetic over [R, ...] tensors).
# --------------------------------------------------------------------------

def tl_on_arrival_np(tl: dict, t: float, n_on: int) -> None:
    """Count an arrival and write the current active-worker count."""
    k = _widx(tl, t)
    tl["arrivals"][k] += 1
    tl["n_on"][k] = np.int32(n_on)


def tl_on_place_np(tl: dict, t: float, is_cold: bool,
                   evicted: bool) -> None:
    k = _widx(tl, t)
    if is_cold:
        tl["n_cold"][k] += 1
    else:
        tl["n_warm"][k] += 1
    if evicted:
        tl["n_evict"][k] += 1


def tl_on_advance_np(tl: dict, t: float, tau: float,
                     active_per_worker: np.ndarray, qlen: int) -> None:
    """Busy/queue-length integrals, credited to the interval start."""
    k = _widx(tl, t)
    tl["busy_time"][k] += tau * np.asarray(active_per_worker,
                                           dtype=np.float64)
    tl["qlen_time"][k] += tau * float(qlen)


def tl_on_complete_np(tl: dict, t: float, response_s: float,
                      service_s: float) -> None:
    """Coarse sketch scatter at the completion time (all completions —
    the flight recorder keeps the warmup ramp visible)."""
    k = _widx(tl, t)
    group = N_BINS // tl["slow_hist"].shape[1]
    slow = response_s / max(service_s, 1e-12)
    tl["slow_hist"][k, bin_index_np(slow) // group] += 1
    tl["lat_hist"][k, bin_index_np(response_s) // group] += 1


def tl_on_evict_np(tl: dict, t: float, count: int = 1) -> None:
    k = _widx(tl, t)
    tl["n_evict"][k] += count


def tl_on_reject_np(tl: dict, t: float) -> None:
    k = _widx(tl, t)
    tl["n_reject"][k] += 1


def tl_on_prov_np(tl: dict, t: float, core_s: float) -> None:
    """Provisioned core-seconds over an interval starting at ``t``."""
    k = _widx(tl, t)
    tl["prov_core"][k] += core_s


def tl_event_np(tl: dict, t: float, kind: int, val: int,
                p99: float) -> None:
    """Append to the bounded decision log; count past the bound."""
    c = int(tl["ev_count"])
    if c < tl["ev_t"].shape[0]:
        tl["ev_t"][c] = t
        tl["ev_kind"][c] = np.int32(kind)
        tl["ev_val"][c] = np.int32(val)
        tl["ev_p99"][c] = p99
    tl["ev_count"] = tl["ev_count"] + 1


def sensor_p99_np(window: np.ndarray) -> float:
    """The p99 the ``TARGET_P99`` controller read from ``window``.

    Mirrors the fleet's ``TARGET_P99`` numpy decide op for op (same
    ceil-rank, same ``searchsorted(cumsum, k, 'left')``, same geometric
    midpoint) so the logged sensor value is bitwise the one the
    decision used.  Only called on non-empty windows (the engines gate
    decisions on ``window.sum() >= 1``).
    """
    edges = hist_edges()
    window = np.asarray(window, dtype=np.int64)
    total = int(window.sum())
    k = min(max(int(math.ceil(0.99 * total)), 1), total)
    b = int(np.searchsorted(np.cumsum(window), k, side="left"))
    return math.sqrt(float(edges[b]) * float(edges[b + 1]))


# --------------------------------------------------------------------------
# Result wrapper + exporters
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimelineResult:
    """Materialized timeline from one run (or a batch; see notes).

    Array fields keep whatever leading batch axes the engine produced
    (``[R, ...]`` from ``simulate_many``).  Scalar readers and exporters
    pool across them: counters, sketches and time integrals sum over
    replications; ``n_on`` and ``window_s`` average (they are levels,
    not totals).  Use :meth:`rep` for one replication's exact planes
    (the decision log is only meaningful per replication).
    """
    window_s: np.ndarray
    mode: np.ndarray
    arrivals: np.ndarray
    n_cold: np.ndarray
    n_warm: np.ndarray
    n_evict: np.ndarray
    n_reject: np.ndarray
    slow_hist: np.ndarray
    lat_hist: np.ndarray
    busy_time: np.ndarray
    qlen_time: np.ndarray
    prov_core: np.ndarray
    n_on: np.ndarray
    ev_t: np.ndarray
    ev_kind: np.ndarray
    ev_val: np.ndarray
    ev_p99: np.ndarray
    ev_count: np.ndarray
    cfg: TimelineCfg = TimelineCfg()

    @staticmethod
    def from_state(tl: Mapping[str, Any],
                   cfg: TimelineCfg = TimelineCfg()) -> "TimelineResult":
        """From a state dict of numpy arrays or of torch tensors (moved
        to the host once, each)."""
        kw = {}
        for f in dataclasses.fields(TimelineResult):
            if f.name == "cfg":
                continue
            v = tl[f.name]
            if hasattr(v, "detach"):
                v = v.detach().cpu().numpy()
            kw[f.name] = np.asarray(v)
        return TimelineResult(cfg=cfg, **kw)

    # -- shape helpers --------------------------------------------------
    @property
    def n_windows(self) -> int:
        return int(self.arrivals.shape[-1])

    @property
    def batched(self) -> bool:
        return self.arrivals.ndim > 1

    def rep(self, r: int) -> "TimelineResult":
        return self[r]

    def __getitem__(self, idx) -> "TimelineResult":
        kw = {f.name: getattr(self, f.name)[idx]
              for f in dataclasses.fields(self) if f.name != "cfg"}
        return TimelineResult(cfg=self.cfg, **kw)

    def _pool_sum(self, a: np.ndarray, keep: int) -> np.ndarray:
        """Sum any leading batch axes, keeping the last ``keep`` dims."""
        a = np.asarray(a)
        if a.ndim > keep:
            a = a.sum(axis=tuple(range(a.ndim - keep)))
        return a

    def _pool_mean(self, a: np.ndarray, keep: int) -> np.ndarray:
        a = np.asarray(a, dtype=np.float64)
        if a.ndim > keep:
            a = a.mean(axis=tuple(range(a.ndim - keep)))
        return a

    def window_starts(self) -> np.ndarray:
        """``[K]`` window start times (pooled width for batches)."""
        w = float(self._pool_mean(self.window_s, 0))
        return np.arange(self.n_windows, dtype=np.float64) * w

    # -- per-window percentile reads (coarse sketch) --------------------
    def slow_percentile(self, window: int, q: float) -> float:
        return sketch_percentile(
            self._pool_sum(self.slow_hist, 2)[window], q,
            edges=coarse_edges(self.cfg))

    def lat_percentile(self, window: int, q: float) -> float:
        return sketch_percentile(
            self._pool_sum(self.lat_hist, 2)[window], q,
            edges=coarse_edges(self.cfg))

    # -- decision log ---------------------------------------------------
    def events(self) -> list[dict]:
        """The recorded decision events, oldest first (single rep only)."""
        if self.batched:
            raise ValueError(
                "the decision-event log is per-replication; select one "
                "with .rep(r) before reading events()")
        n = min(int(self.ev_count), int(self.ev_t.shape[0]))
        out = []
        for i in range(n):
            kind = int(self.ev_kind[i])
            ev = {"t": float(self.ev_t[i]),
                  "kind": "autoscale" if kind == EV_AUTOSCALE
                  else "mode_flip",
                  "value": int(self.ev_val[i])}
            if kind == EV_AUTOSCALE:
                ev["sensor_p99"] = float(self.ev_p99[i])
            out.append(ev)
        return out

    def replay_n_on(self, n_start: int) -> np.ndarray:
        """Reconstruct the per-window ``n_on`` plane from the decision
        log alone: start at ``n_start``, apply autoscale events in
        order, sample at each window's *last arrival* — i.e. the value
        the engine's last-write-wins plane holds.  Exact as long as the
        log was not truncated (``ev_count <= max_events``)."""
        if self.batched:
            raise ValueError("replay_n_on needs a single replication; "
                             "select one with .rep(r)")
        if int(self.ev_count) > int(self.ev_t.shape[0]):
            raise ValueError(
                f"decision log truncated ({int(self.ev_count)} events > "
                f"max_events={int(self.ev_t.shape[0])}); the n_on "
                f"trajectory cannot be replayed exactly")
        out = np.zeros(self.n_windows, dtype=np.int32)
        level = np.int32(n_start)
        ei, n_ev = 0, min(int(self.ev_count), int(self.ev_t.shape[0]))
        w = float(self.window_s)
        for k in range(self.n_windows):
            if self.arrivals[k] == 0:
                continue
            # events apply at arrival boundaries before the n_on write,
            # so every autoscale event in or before this window that
            # precedes its last arrival has taken effect; within one
            # window the plane keeps only the final level
            while ei < n_ev:
                if int(self.ev_kind[ei]) != EV_AUTOSCALE:
                    ei += 1
                    continue
                if window_index_np(float(self.ev_t[ei]), w,
                                   self.n_windows) > k:
                    break
                level = np.int32(int(self.ev_val[ei]))
                ei += 1
            out[k] = level
        return out

    # -- digests / exporters --------------------------------------------
    def summary(self) -> dict:
        """Compact JSON-friendly digest for reports / RunManifest."""
        arr = self._pool_sum(self.arrivals, 1)
        cold = self._pool_sum(self.n_cold, 1)
        warm = self._pool_sum(self.n_warm, 1)
        n_ev_seen = int(np.asarray(self.ev_count).sum())
        cap = int(self.ev_t.shape[-1])
        reps = int(np.prod(np.asarray(self.ev_count).shape)) \
            if np.asarray(self.ev_count).ndim else 1
        placed = int(cold.sum() + warm.sum())
        return {
            "n_windows": self.n_windows,
            "window_s": _r(float(self._pool_mean(self.window_s, 0))),
            "coarse_bins": int(self.cfg.coarse_bins),
            "arrivals_total": int(arr.sum()),
            "arrivals_peak": int(arr.max()) if arr.size else 0,
            "cold_frac": _r(float(cold.sum()) / placed) if placed
            else 0.0,
            "n_reject": int(self._pool_sum(self.n_reject, 1).sum()),
            "n_events": n_ev_seen,
            "n_events_dropped": max(0, n_ev_seen - cap * reps),
            "n_on_min": int(np.asarray(self.n_on).min())
            if np.asarray(self.n_on).size else 0,
            "n_on_max": int(np.asarray(self.n_on).max())
            if np.asarray(self.n_on).size else 0,
            "prov_core_s": _r(float(
                self._pool_sum(self.prov_core, 1).sum())),
        }

    def to_rows(self) -> list[dict]:
        """One CSV-friendly dict per window (pooled over batch axes)."""
        K = self.n_windows
        w = float(self._pool_mean(self.window_s, 0))
        n_workers = int(self.busy_time.shape[-1])
        arr = self._pool_sum(self.arrivals, 1)
        cold = self._pool_sum(self.n_cold, 1)
        warm = self._pool_sum(self.n_warm, 1)
        evict = self._pool_sum(self.n_evict, 1)
        rej = self._pool_sum(self.n_reject, 1)
        busy = self._pool_sum(self.busy_time, 2)
        qlen = self._pool_sum(self.qlen_time, 1)
        prov = self._pool_sum(self.prov_core, 1)
        n_on = self._pool_mean(self.n_on, 1)
        reps = 1
        if self.batched:
            reps = int(np.prod(self.arrivals.shape[:-1]))
        denom = max(w * reps, 1e-12)
        rows = []
        for k in range(K):
            rows.append({
                "window": k,
                "t_start_s": _r(k * w),
                "arrivals": int(arr[k]),
                "n_cold": int(cold[k]),
                "n_warm": int(warm[k]),
                "n_evict": int(evict[k]),
                "n_reject": int(rej[k]),
                "slow_p50": _r(self.slow_percentile(k, 50.0)),
                "slow_p99": _r(self.slow_percentile(k, 99.0)),
                "lat_p50_s": _r(self.lat_percentile(k, 50.0)),
                "lat_p99_s": _r(self.lat_percentile(k, 99.0)),
                "busy_frac": _r(float(busy[k].sum())
                                / (denom * n_workers)),
                "qlen_avg": _r(float(qlen[k]) / denom),
                "n_on": _r(float(n_on[k]), 3),
                "prov_core_s": _r(float(prov[k])),
            })
        return rows

    def to_openmetrics(self, prefix: str = "repro_timeline") -> str:
        """OpenMetrics / Prometheus text exposition of the timeline.

        Each per-window value becomes one sample with a ``window`` label
        (plus its virtual start time ``t_start_s``); the decision log is
        exported as an info-style gauge per event.  The text ends with
        ``# EOF`` per the OpenMetrics spec.
        """
        rows = self.to_rows()
        counters = ("arrivals", "n_cold", "n_warm", "n_evict", "n_reject")
        gauges = ("slow_p50", "slow_p99", "lat_p50_s", "lat_p99_s",
                  "busy_frac", "qlen_avg", "n_on", "prov_core_s")
        lines = []
        for name in counters:
            lines.append(f"# TYPE {prefix}_{name} counter")
            for r in rows:
                lines.append(
                    f'{prefix}_{name}_total{{window="{r["window"]}",'
                    f't_start_s="{r["t_start_s"]}"}} {r[name]}')
        for name in gauges:
            lines.append(f"# TYPE {prefix}_{name} gauge")
            for r in rows:
                v = r[name]
                v = "NaN" if isinstance(v, float) and math.isnan(v) else v
                lines.append(
                    f'{prefix}_{name}{{window="{r["window"]}",'
                    f't_start_s="{r["t_start_s"]}"}} {v}')
        if not self.batched:
            lines.append(f"# TYPE {prefix}_decision gauge")
            for i, ev in enumerate(self.events()):
                p99 = ev.get("sensor_p99", float("nan"))
                p99 = "NaN" if math.isnan(p99) else _r(p99)
                lines.append(
                    f'{prefix}_decision{{seq="{i}",kind="{ev["kind"]}",'
                    f't_s="{_r(ev["t"])}",sensor_p99="{p99}"}} '
                    f'{ev["value"]}')
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def write_csv(self, path: str) -> str:
        """Write the per-window table as CSV; returns the path."""
        import csv
        import os
        rows = self.to_rows()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        return path

    def write_openmetrics(self, path: str) -> str:
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_openmetrics())
        return path

    def emit_counters(self, tracer, prefix: str = "timeline") -> None:
        """Merge the timeline into a span trace as Perfetto counter
        tracks (one ``ph: "C"`` sample per window on the virtual-time
        process, alongside the serving platform's task events)."""
        rows = self.to_rows()
        tracks = ("arrivals", "n_cold", "n_reject", "slow_p99",
                  "busy_frac", "qlen_avg", "n_on", "prov_core_s")
        for r in rows:
            for name in tracks:
                v = r[name]
                if isinstance(v, float) and math.isnan(v):
                    continue
                tracer.counter_at(f"{prefix}.{name}",
                                  float(r["t_start_s"]), float(v))


__all__ = [
    "TimelineCfg", "TimelineResult", "EV_AUTOSCALE", "EV_MODE_FLIP",
    "validate_timeline", "coarse_group", "coarse_edges", "auto_window_s",
    "window_index_np", "init_tl_np", "sensor_p99_np",
    "tl_on_arrival_np", "tl_on_place_np", "tl_on_advance_np",
    "tl_on_complete_np", "tl_on_evict_np", "tl_on_reject_np",
    "tl_on_prov_np", "tl_event_np",
]
