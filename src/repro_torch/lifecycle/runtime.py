"""Host-side lifecycle state machine for one event-driven run
(counterpart of ``repro/lifecycle/runtime.py``).

An event loop that places and completes one invocation at a time (the
numpy oracle, :mod:`repro_torch.core.sim_ref`, and the serving
controller) keeps its lifecycle state here, in numpy on the host; the
engines of :mod:`repro_torch.core.simulator` and
:mod:`repro_torch.kernels.sim_engine` make the same operations in their
own form, and each method names the engine step it mirrors.  The
keep-alive policy's state is the resolved policy's own: under a
``backend="np"`` resolution (the oracle's) numpy, used as it is, as in
the reference; otherwise one replication (``R = 1``) on the resolved
device, its windows brought to the host after each observation.

State: ``idle_since [W, F]``, the time of each pool's latest completion
(``-1``: none yet; a warm placement does not refresh it), and the
windows ``pre``/``keep [F]``, recomputed after each observation of an
adaptive policy.  A pool is materialized at ``now`` iff ``pre <= now -
idle_since <= pre + keep``.  The eviction victim is the materialized
pool with the oldest ``idle_since``, the lowest function id on ties.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import ResolvedLifecycle


def _host(x) -> np.ndarray:
    """A window tensor (``[F]``, or ``[1, F]`` from a state) as ``[F]``."""
    return x.detach().cpu().numpy().reshape(-1).astype(np.float64)


class LifecycleRuntime:
    """Mutable lifecycle state for one event-driven run."""

    def __init__(self, res: ResolvedLifecycle, n_workers: int,
                 n_functions: int):
        self.res = res
        self.W, self.F = int(n_workers), int(n_functions)
        self.idle_since = np.full((self.W, self.F), -1.0, dtype=np.float64)
        self.ka = res.init_policy_state(1, self.W, self.F)
        self._windows()
        self.max_idle = res.max_idle

    def _windows(self) -> None:
        pre, keep = self.res.windows(self.ka)
        if self.res.backend == "np":
            self.pre, self.keep = pre, keep
        else:
            self.pre, self.keep = _host(pre), _host(keep)

    def cold_cost(self, f: int, scalar_default: float) -> float:
        """Cold-start latency of function ``f``: the preset's, or
        ``scalar_default`` without one (the engines' placement cost)."""
        if self.res.cold_costs is None:
            return float(scalar_default)
        return float(self.res.cold_costs[f])

    def materialized_at(self, w: int, f: int, count: int,
                        now: float) -> int:
        """``count`` if pool ``(w, f)`` is materialized at ``now``, else 0:
        the one-pool warm-hit check of a placement."""
        age = now - self.idle_since[w, f]
        if self.pre[f] <= age <= self.pre[f] + self.keep[f]:
            return int(count)
        return 0

    def materialized_all(self, warm: np.ndarray, now: float) -> np.ndarray:
        """The whole ``[W, F]`` warm matrix as placement sees it (the
        batched dispatch's form of :meth:`materialized_col`)."""
        ages = now - self.idle_since
        ok = (ages >= self.pre) & (ages <= self.pre + self.keep)
        return np.where(ok, warm, 0)

    def materialized_col(self, warm_col: np.ndarray, f: int,
                         now: float) -> np.ndarray:
        """Warm counts of function ``f`` visible to placement, per worker
        (the engines' selection-time warm column)."""
        age = now - self.idle_since[:, f]
        ok = (age >= self.pre[f]) & (age <= self.pre[f] + self.keep[f])
        return np.where(ok, warm_col, 0)

    def eff_row(self, warm_row: np.ndarray, w: int,
                now: float) -> np.ndarray:
        """Materialized (memory-holding) counts of worker ``w``."""
        age = now - self.idle_since[w]
        ok = (age >= self.pre) & (age <= self.pre + self.keep)
        return np.where(ok, warm_row, 0)

    def evict_victim(self, warm_row: np.ndarray, w: int, now: float) -> int:
        """The LRU victim on worker ``w`` (the engines' placement and
        budget eviction); called only when a materialized pool exists."""
        eff = self.eff_row(warm_row, w, now)
        return int(np.argmin(np.where(eff > 0, self.idle_since[w],
                                      np.inf)))

    def on_complete(self, warm: np.ndarray, w: int, f: int,
                    now: float) -> bool:
        """A task of function ``f`` completed on worker ``w`` at ``now``:
        zero a stale pool before the increment, refresh its idle clock,
        then evict the LRU pool if the worker holds more than
        ``max_idle`` materialized executors (the engines' completion
        step).  Returns whether the budget evicted one."""
        age = now - self.idle_since[w, f]
        if age > self.pre[f] + self.keep[f]:
            warm[w, f] = 0
        warm[w, f] += 1
        self.idle_since[w, f] = now
        if self.max_idle > 0:
            eff = self.eff_row(warm[w], w, now)
            if eff.sum() > self.max_idle:
                v = int(np.argmin(np.where(eff > 0, self.idle_since[w],
                                           np.inf)))
                warm[w, v] -= 1
                return True
        return False

    def observe_place(self, w: int, f: int, now: float) -> None:
        """Feed the policy the placed pool's idle age, after the warm or
        cold decision, and recompute the windows (the engines' placement
        step).  A pool without a completion yet is not an observation."""
        if self.res.observe is None or self.idle_since[w, f] < 0.0:
            return
        gap = now - self.idle_since[w, f]
        if self.res.backend == "np":
            self.ka = self.res.observe(self.ka, f, gap)
        else:
            dev = self.res.device
            self.ka = self.res.observe(
                self.ka, torch.tensor([f], dtype=torch.int64, device=dev),
                torch.tensor([gap], dtype=torch.float64, device=dev),
                torch.ones(1, dtype=torch.bool, device=dev))
        self._windows()
