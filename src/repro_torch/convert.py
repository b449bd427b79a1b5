"""The state carried across from the reference package.

The system has no weights: its state is the workload and the cluster.
These constructors take the reference's ``Workload`` / ``WorkloadBatch``
/ ``ClusterCfg`` fields as numpy arrays and plain values (never the
reference's objects, which the port does not import), so that one case
can be fed identically to both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cluster import ClusterCfg
from repro_torch.core.workload import (Workload, WorkloadBatch,
                                       validate_workload)


def workload_from_arrays(arrival, func, service, u_lb, func_home,
                         n_functions: int, load: float,
                         name: str = "workload") -> Workload:
    """A validated :class:`Workload` with the engine's dtypes pinned."""
    wl = Workload(
        arrival=np.asarray(arrival, dtype=np.float64),
        func=np.asarray(func, dtype=np.int32),
        service=np.asarray(service, dtype=np.float64),
        u_lb=np.asarray(u_lb, dtype=np.float64),
        func_home=np.asarray(func_home, dtype=np.int32),
        n_functions=int(n_functions), load=float(load), name=str(name))
    validate_workload(wl)
    return wl


def batch_from_arrays(arrival, func, service, u_lb, func_home,
                      n_functions: int, loads, names) -> WorkloadBatch:
    """A :class:`WorkloadBatch` from ``[R, N]`` / ``[R, F]`` arrays; every
    replication is validated as a :class:`Workload`."""
    wb = WorkloadBatch(
        arrival=np.asarray(arrival, dtype=np.float64),
        func=np.asarray(func, dtype=np.int32),
        service=np.asarray(service, dtype=np.float64),
        u_lb=np.asarray(u_lb, dtype=np.float64),
        func_home=np.asarray(func_home, dtype=np.int32),
        n_functions=int(n_functions), loads=tuple(loads),
        names=tuple(names))
    for r in range(wb.n_reps):
        validate_workload(wb.rep(r))
    return wb


def cluster_from_fields(n_workers: int, cores: int, capacity_factor: int,
                        cold_start_penalty: float) -> ClusterCfg:
    """A validated plain-configuration :class:`ClusterCfg`."""
    return ClusterCfg(n_workers=int(n_workers), cores=int(cores),
                      capacity_factor=int(capacity_factor),
                      cold_start_penalty=float(cold_start_penalty)
                      ).validate()
