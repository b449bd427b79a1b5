"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``; only
``make_rep_mesh`` is ported).

The simulator's unit of parallelism is the replication: a stream
(:func:`repro_torch.core.streaming.simulate_stream`) splits its stacked
replications over a 1-D ``"rep"`` mesh, one contiguous shard per device
(:mod:`repro_torch.distribution.sim_shard`).  Here a mesh is a tuple of
torch devices that names its one axis.
"""
from __future__ import annotations

import torch

from repro_torch.device import NoCudaDeviceError

#: the mesh axis the replication dimension maps onto
REP_AXIS = "rep"


class RepMesh(tuple):
    """A 1-D mesh over the replication axis: a tuple of torch devices."""

    axis_names = (REP_AXIS,)

    @property
    def shape(self) -> dict:
        return {REP_AXIS: len(self)}

    @property
    def devices(self) -> tuple:
        return tuple(self)


def make_rep_mesh(n_devices: int | None = None, devices=None) -> RepMesh:
    """A 1-D mesh over the replication axis.

    ``devices`` (an explicit sequence, e.g. ``("cpu", "cpu")``) or every
    CUDA device; ``n_devices`` takes a prefix of them.  Without
    ``devices`` and without a card it raises
    :class:`~repro_torch.device.NoCudaDeviceError`.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "make_rep_mesh spans the CUDA devices by default and none "
                "is available; pass devices=('cpu', ...) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(f"n_devices={n} exceeds the {len(devices)} "
                         f"devices given")
    return RepMesh(devices[:n])
