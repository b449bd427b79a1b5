"""The replication split of the streaming simulator (counterpart of
``repro/distribution/sim_shard.py``).

Replications never interact, so a stream
(:func:`repro_torch.core.streaming.simulate_stream`) splits its leading
``R`` axis into contiguous shards, one per device of a 1-D ``"rep"`` mesh
(:func:`repro_torch.launch.mesh.make_rep_mesh`), runs each shard's chunks
on its device and concatenates the results: no communication, and the
same bits as the unsplit run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import REP_AXIS


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_reps(tree, mesh) -> list:
    """One copy of ``tree`` per device of ``mesh``: every leaf (a tensor
    or a numpy array, leading axis ``R``) cut to that device's contiguous
    shard of ``R`` and put there as a tensor; 0-d leaves are copied whole.

    A mesh without the ``"rep"`` axis, or a leaf whose ``R`` the mesh
    does not divide, raises the reference's named errors.
    """
    names = tuple(getattr(mesh, "axis_names", ()))
    if REP_AXIS not in names:
        raise ValueError(
            f"mesh has axes {names}, expected a 1-D {REP_AXIS!r} mesh — "
            f"build one with repro_torch.launch.mesh.make_rep_mesh()")
    devices = list(mesh)
    n = len(devices)

    def check(x):
        x = torch.as_tensor(x)
        if x.dim() > 0 and x.shape[0] % n != 0:
            raise ValueError(
                f"replication axis of size {x.shape[0]} does not divide "
                f"across the {n}-device {REP_AXIS!r} mesh; pad the rep "
                f"count or shrink the mesh (make_rep_mesh(n_devices=...))")
        return x

    tree = _map(lambda x: check(np.ascontiguousarray(x)
                                if isinstance(x, np.ndarray) else x), tree)

    def part(i):
        def cut(x):
            if x.dim() == 0:
                return x.to(devices[i])
            per = x.shape[0] // n
            return x[i * per:(i + 1) * per].to(devices[i])
        return _map(cut, tree)

    return [part(i) for i in range(n)]
