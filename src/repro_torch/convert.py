"""The state carried across from the reference package.

The simulator has no weights: its state is the workload and the cluster.
These constructors take the reference's ``Workload`` / ``WorkloadBatch``
/ ``ClusterCfg`` fields as numpy arrays and plain values (never the
reference's objects, which the port does not import), so that one case
can be fed identically to both packages.  The served models do have
weights: :func:`params_from_reference` carries the reference's parameter
tree across bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cluster import ClusterCfg
from repro_torch.core.workload import (Workload, WorkloadBatch,
                                       validate_workload)
from repro_torch.device import resolve_device


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


def params_from_reference(cfg, tree, device=None) -> dict:
    """The port's parameters from the reference's tree as numpy arrays.

    ``tree`` is what the reference's ``init`` returns, converted leaf by
    leaf with ``np.asarray``: ``{"embed", "layers", "final_norm"}`` and,
    for the hybrid family, ``"shared"``.  Every leaf of ``"layers"`` is
    stacked on a leading ``L`` axis and is split into one dict per layer;
    every other top-level subtree is carried whole.  Every tensor keeps its
    dtype and values bit for bit (``bfloat16`` leaves, which numpy holds
    as ``ml_dtypes.bfloat16``, by their bits).  ``device=None`` is CUDA.
    """
    dev = resolve_device(device)
    n_layers = int(cfg.n_layers)

    def walk(node, layer=None, path=""):
        if isinstance(node, dict):
            return {k: walk(v, layer, f"{path}/{k}")
                    for k, v in node.items()}
        a = np.asarray(node)
        if layer is not None:
            if a.shape[:1] != (n_layers,):
                raise ValueError(f"params_from_reference: {path} has shape "
                                 f"{a.shape}, expected a leading "
                                 f"L={n_layers}")
            a = a[layer]
        if a.dtype.name == "bfloat16":     # ml_dtypes: carry the bits
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {k: ([walk(v, i, "layers") for i in range(n_layers)]
                if k == "layers" else walk(v, path=k))
            for k, v in tree.items()}
