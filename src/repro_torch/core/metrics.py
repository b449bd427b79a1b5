"""Metrics for the scheduling study (counterpart of ``repro/core/metrics.py``).

``slowdown = response_time / execution_time`` is the paper's headline
metric (§3.3).  :func:`summarize` scores one run; :func:`summarize_batch`
scores ``R`` stacked replications: per-replication rows, a pooled row
over the combined task population, and across-replication mean ± 95 %
confidence intervals.  Host-side numpy on the engine's numpy outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Summary:
    n: int
    n_rejected: int
    cold_frac: float          # fraction of completed invocations cold-started
    lat_p50: float
    lat_p99: float
    slow_p50: float
    slow_p99: float
    slow_mean: float
    mean_servers: float       # time-averaged # of busy servers
    mean_cores: float         # time-averaged # of busy cores
    throughput: float         # completed invocations / horizon

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _pct(x, q):
    return float(np.percentile(x, q)) if len(x) else float("nan")


def summarize(response: np.ndarray, service: np.ndarray,
              cold: np.ndarray, rejected: np.ndarray,
              server_time: float, core_time: float, end_time: float,
              *, warmup_frac: float = 0.1,
              arrival: np.ndarray | None = None) -> Summary:
    """Aggregate per-task results, dropping the first ``warmup_frac``."""
    n = len(response)
    lo = int(n * warmup_frac)
    sel = np.ones(n, dtype=bool)
    sel[:lo] = False
    ok = sel & ~rejected & np.isfinite(response)
    resp = response[ok]
    svc = np.maximum(service[ok], 1e-12)
    slow = resp / svc
    horizon = max(end_time, 1e-12)
    return Summary(
        n=int(ok.sum()),
        n_rejected=int((rejected & sel).sum()),
        cold_frac=float(cold[ok].mean()) if ok.any() else float("nan"),
        lat_p50=_pct(resp, 50), lat_p99=_pct(resp, 99),
        slow_p50=_pct(slow, 50), slow_p99=_pct(slow, 99),
        slow_mean=float(slow.mean()) if len(slow) else float("nan"),
        mean_servers=server_time / horizon,
        mean_cores=core_time / horizon,
        throughput=float(np.isfinite(response).sum()) / horizon,
    )


def _check_warmup_contract(out, kw) -> None:
    """Raise :class:`~repro_torch.telemetry.WarmupMismatchError` when the
    engine's telemetry sketches were filled with another warmup cutoff
    than the one this summarize call applies: the two would describe
    different task populations."""
    tel = getattr(out, "telemetry", None)
    if tel is None or getattr(tel, "cfg", None) is None:
        return
    wf = float(kw.get("warmup_frac", 0.1))
    if float(tel.cfg.warmup_frac) != wf:
        from repro_torch.telemetry import WarmupMismatchError
        raise WarmupMismatchError(tel.cfg.warmup_frac, wf)


def summarize_sim(out, wl, **kw) -> Summary:
    """Convenience wrapper over a SimOutput + Workload pair."""
    _check_warmup_contract(out, kw)
    return summarize(out.response, wl.service, out.cold, out.rejected,
                     out.server_time, out.core_time, out.end_time, **kw)


# Two-sided 95 % Student-t critical values by degrees of freedom; the
# normal 1.96 beyond the table.
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131, 16: 2.120, 17: 2.110, 18: 2.101,
        19: 2.093, 20: 2.086, 25: 2.060, 30: 2.042}


def _t95(df: int) -> float:
    if df <= 0:
        return float("nan")
    if df in _T95:
        return _T95[df]
    if df < 25:
        return _T95[20]
    if df < 30:
        return _T95[25]
    return 1.96


@dataclasses.dataclass(frozen=True)
class Stat:
    """Across-replication mean with a 95 % confidence half-width."""

    mean: float
    ci95: float     # half-width; 0 for R=1 (no spread estimate)

    @property
    def lo(self) -> float:
        return self.mean - self.ci95

    @property
    def hi(self) -> float:
        return self.mean + self.ci95


STAT_FIELDS = ("cold_frac", "lat_p50", "lat_p99", "slow_p50", "slow_p99",
               "slow_mean", "mean_servers", "mean_cores", "throughput")


@dataclasses.dataclass(frozen=True)
class BatchSummary:
    per_rep: tuple            # (R,) Summary — one per replication
    pooled: Summary           # percentiles over the combined task population
    stats: dict               # field name -> Stat (mean ± CI over reps)

    @property
    def n_reps(self) -> int:
        return len(self.per_rep)

    def row(self) -> dict:
        """Flat dict: pooled metrics + per-field mean/ci95 columns."""
        out = self.pooled.row()
        for k, st in self.stats.items():
            out[f"{k}_mean"] = st.mean
            out[f"{k}_ci95"] = st.ci95
        return out


def _stats_over(per_rep) -> dict:
    stats = {}
    for fld in STAT_FIELDS:
        vals = np.array([getattr(s, fld) for s in per_rep], dtype=float)
        vals = vals[np.isfinite(vals)]
        if len(vals) == 0:
            stats[fld] = Stat(float("nan"), float("nan"))
            continue
        mean = float(vals.mean())
        if len(vals) < 2:
            stats[fld] = Stat(mean, 0.0)
        else:
            sem = float(vals.std(ddof=1)) / np.sqrt(len(vals))
            stats[fld] = Stat(mean, _t95(len(vals) - 1) * sem)
    return stats


def summarize_batch(response: np.ndarray, service: np.ndarray,
                    cold: np.ndarray, rejected: np.ndarray,
                    server_time: np.ndarray, core_time: np.ndarray,
                    end_time: np.ndarray, *, warmup_frac: float = 0.1
                    ) -> BatchSummary:
    """Aggregate ``(R, N)`` stacked results along both axes."""
    R = response.shape[0]
    per_rep = tuple(
        summarize(response[r], service[r], cold[r], rejected[r],
                  float(server_time[r]), float(core_time[r]),
                  float(end_time[r]), warmup_frac=warmup_frac)
        for r in range(R))

    n = response.shape[1]
    lo = int(n * warmup_frac)
    sel = np.ones((R, n), dtype=bool)
    sel[:, :lo] = False
    ok = sel & ~rejected & np.isfinite(response)
    resp = response[ok]
    svc = np.maximum(service[ok], 1e-12)
    slow = resp / svc
    horizon = max(float(np.sum(end_time)), 1e-12)
    pooled = Summary(
        n=int(ok.sum()),
        n_rejected=int((rejected & sel).sum()),
        cold_frac=float(cold[ok].mean()) if ok.any() else float("nan"),
        lat_p50=_pct(resp, 50), lat_p99=_pct(resp, 99),
        slow_p50=_pct(slow, 50), slow_p99=_pct(slow, 99),
        slow_mean=float(slow.mean()) if len(slow) else float("nan"),
        mean_servers=float(np.sum(server_time)) / horizon,
        mean_cores=float(np.sum(core_time)) / horizon,
        throughput=float(np.isfinite(response).sum()) / horizon,
    )
    return BatchSummary(per_rep=per_rep, pooled=pooled,
                        stats=_stats_over(per_rep))


def summarize_batch_sim(out, wb, **kw) -> BatchSummary:
    """Convenience wrapper over a BatchSimOutput + WorkloadBatch pair."""
    _check_warmup_contract(out, kw)
    return summarize_batch(out.response, wb.service, out.cold, out.rejected,
                           out.server_time, out.core_time, out.end_time,
                           **kw)
