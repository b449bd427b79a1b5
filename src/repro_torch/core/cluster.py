"""Cluster configuration (counterpart of ``repro/core/cluster.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch.fleet.config import FleetCfg
from repro_torch.lifecycle.config import LifecycleCfg


class ClusterCfg(NamedTuple):
    """A homogeneous cluster of ``n_workers`` machines.

    Each worker has ``cores`` CPU cores and hosts up to
    ``capacity_factor × cores`` invocations (running + waiting), the
    OpenWhisk memory-capacity model of the paper (§3.2, §6.1).
    ``cold_start_penalty`` is added to an invocation's service time when
    the chosen worker holds no warm executor for its function.

    ``lifecycle`` (:class:`~repro_torch.lifecycle.LifecycleCfg`) turns
    on the container lifecycle: keep-alive windows, LRU eviction and
    per-function cold-start costs; ``None`` is the model without one.
    ``fleet`` (:class:`~repro_torch.fleet.FleetCfg`) makes the workers
    heterogeneous (per-worker speeds) and can run an autoscaler; ``None``
    is the homogeneous fixed fleet.
    """

    n_workers: int = 4
    cores: int = 12
    capacity_factor: int = 8
    cold_start_penalty: float = 0.0
    lifecycle: Optional[LifecycleCfg] = None
    fleet: Optional[FleetCfg] = None

    @property
    def slots(self) -> int:
        """Max invocations (running + queued) a worker can host."""
        return self.capacity_factor * self.cores

    @property
    def total_cores(self) -> int:
        return self.n_workers * self.cores

    def validate(self) -> "ClusterCfg":
        """Reject impossible or not-yet-ported configs with named errors."""
        if int(self.n_workers) <= 0:
            raise ValueError(
                f"ClusterCfg.n_workers must be positive, got "
                f"{self.n_workers}")
        if int(self.cores) <= 0:
            raise ValueError(
                f"ClusterCfg.cores must be positive, got {self.cores}")
        if int(self.capacity_factor) <= 0:
            raise ValueError(
                f"ClusterCfg.capacity_factor must be positive, got "
                f"{self.capacity_factor}")
        if self.lifecycle is not None:
            lc = self.lifecycle
            if not isinstance(lc, LifecycleCfg):
                raise ValueError(f"ClusterCfg.lifecycle must be a "
                                 f"LifecycleCfg or None, got {lc!r}")
            if not float(lc.ttl_s) >= 0.0:
                raise ValueError(f"LifecycleCfg.ttl_s must be >= 0, got "
                                 f"{lc.ttl_s}")
            if int(lc.max_idle) < 0:
                raise ValueError(f"LifecycleCfg.max_idle must be >= 0, got "
                                 f"{lc.max_idle}")
            # unregistered names fail with their registries' named errors
            from repro_torch.lifecycle import (parse_cold_preset,
                                               parse_keepalive)
            parse_keepalive(lc.keepalive)
            parse_cold_preset(lc.coldstart)
        if self.fleet is not None:
            if not isinstance(self.fleet, FleetCfg):
                raise ValueError(f"ClusterCfg.fleet must be a FleetCfg or "
                                 f"None, got {self.fleet!r}")
            W = int(self.n_workers)
            for field in ("speed", "mem"):
                vec = getattr(self.fleet, field)
                if not vec:
                    continue
                if len(vec) != W:
                    raise ValueError(
                        f"FleetCfg.{field} has {len(vec)} entries for "
                        f"n_workers={W}, got {tuple(vec)}")
                if any(not v > 0 for v in vec):
                    raise ValueError(
                        f"FleetCfg.{field} entries must be positive, "
                        f"got {tuple(vec)}")
            if not 1 <= int(self.fleet.min_workers) <= W:
                raise ValueError(
                    f"FleetCfg.min_workers must be in [1, n_workers="
                    f"{W}], got {self.fleet.min_workers}")
            # unregistered names fail with their registries' named errors
            from repro_torch.fleet import parse_autoscale, parse_fleet_preset
            if not self.fleet.speed:
                parse_fleet_preset(self.fleet.preset)
            parse_autoscale(self.fleet.autoscale)
        return self


# Setups used in the paper.
PAPER_SMALL = ClusterCfg(n_workers=4, cores=12)      # §3.3, Fig 2/3
PAPER_LARGE = ClusterCfg(n_workers=100, cores=12)    # §3.5, Fig 4
PAPER_TESTBED = ClusterCfg(n_workers=8, cores=12)    # §6, 8 invokers
