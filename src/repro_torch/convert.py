"""The state carried across from the reference package.

The simulator has no weights: its state is the workload and the cluster.
These constructors take the reference's ``Workload`` / ``WorkloadBatch``
/ ``ClusterCfg`` fields as numpy arrays and plain values (never the
reference's objects, which the port does not import), so that one case
can be fed identically to both packages.  The served models do have
weights: :func:`params_from_reference` carries the reference's parameter
tree across bit for bit, :func:`train_state_from_reference` a whole
training state (parameters, AdamW moments and step, error feedback), and
:func:`stack_like_reference` takes a port tree back to the reference's
layout for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cluster import ClusterCfg
from repro_torch.core.workload import (Workload, WorkloadBatch,
                                       validate_workload)
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import OptState
from repro_torch.training.train import TrainState


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


def train_state_from_reference(cfg, state, device=None):
    """The port's :class:`~repro_torch.training.train.TrainState` from the
    reference's, leaf by leaf as numpy arrays.

    ``state`` has the reference's fields: ``params``, ``opt`` (``m``,
    ``v``, ``step``) and ``err`` (``None`` unless the compressed step made
    it).  ``params``, ``m``, ``v`` and ``err`` are split per layer as in
    :func:`params_from_reference`; ``step`` becomes a 0-d int32 tensor.
    ``device=None`` is CUDA.
    """
    dev = resolve_device(device)
    tree = lambda t: params_from_reference(cfg, t, dev)   # noqa: E731
    opt = state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(params=tree(state.params),
                      opt=OptState(m=tree(opt.m), v=tree(opt.v), step=step),
                      err=None if state.err is None else tree(state.err))


def stack_like_reference(tree) -> dict:
    """A port tree (``{"layers": [one dict per layer], ...}``) in the
    reference's layout: numpy arrays, every leaf under ``"layers"`` stacked
    on a leading ``L`` axis, the other subtrees whole.  bfloat16 leaves
    come back as float32 (exact)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([layer[k] for layer in layers]) for k in first}
        return np.stack([leaf(t) for t in layers])

    return {k: stack(v) if k == "layers" else walk(v)
            for k, v in tree.items()}
