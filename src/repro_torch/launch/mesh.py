"""Device meshes and sharding-context assembly (counterpart of
``repro/launch/mesh.py``).

The model meshes are ``torch.distributed`` device meshes over the default
process group, which the caller starts (``init_process_group`` with its
address, world size and rank): one rank a device.  The single-pod
production mesh is 16 × 16 = 256 ranks (``data × model``); multi-pod adds
a leading ``pod`` axis (2 × 256 = 512) used as an outer data-parallel /
replica axis.  A world of another size cannot hold them:
:class:`MeshSizeError` says the size it needs.  Nothing here runs at
import, so importing the module touches no process group.

The simulator's unit of parallelism is the replication: a stream
(:func:`repro_torch.core.streaming.simulate_stream`) splits its stacked
replications over a 1-D ``"rep"`` mesh, one contiguous shard per device
(:mod:`repro_torch.distribution.sim_shard`).  That mesh is a tuple of
torch devices that names its one axis.
"""
from __future__ import annotations

import torch

from repro_torch.device import NoCudaDeviceError, resolve_device
from repro_torch.distribution.sharding import (MeshShape, ShardCtx,
                                               make_rules, mesh_axes)

#: the mesh axis the replication dimension maps onto
REP_AXIS = "rep"


class MeshSizeError(RuntimeError):
    """The process group's world does not match the mesh asked for."""


def production_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's axes and sizes, without a process group."""
    return MeshShape({"pod": 2, "data": 16, "model": 16} if multi_pod
                     else {"data": 16, "model": 16})


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the product of ``shape``.
    ``device_type`` ``None`` is CUDA.  A CUDA mesh over ``gloo`` (two ranks
    on one card) routes DTensor's collectives through c10d's
    (:func:`~repro_torch.distribution.sharding.route_functional_collectives`).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device_type)
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise MeshSizeError(
            f"a {' x '.join(map(str, shape))} mesh ({', '.join(axes)}) needs "
            f"a process group of {n} ranks; this world has {world}. Start "
            f"{n} processes and init_process_group(world_size={n}) first")
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.distribution.sharding import \
            route_functional_collectives
        route_functional_collectives()
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The 16 × 16 ``data × model`` mesh, or 2 × 16 × 16 ``pod × data ×
    model``; :class:`MeshSizeError` unless the world has 256 or 512
    ranks."""
    shp = production_shape(multi_pod).shape
    return make_mesh(tuple(shp.values()), tuple(shp), device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None):
    """A small mesh (the tests' process groups: ``device_type="cpu"``)."""
    return make_mesh(shape, axes, device_type)


def make_ctx(mesh, cfg, shape_cfg=None, **rule_overrides) -> ShardCtx:
    """The sharding context for (arch cfg × input shape × mesh).  Reads
    only the mesh's axis names and sizes, so a
    :class:`~repro_torch.distribution.sharding.MeshShape` stands in for a
    mesh no process group holds."""
    shape = mesh_axes(mesh)
    multi_pod = "pod" in shape
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    dp = 1
    for a in dp_axes:
        dp *= shape[a]
    seq_kv_data = bool(shape_cfg is not None
                       and shape_cfg.kind == "decode"
                       and shape_cfg.seq_len >= 262_144)
    rules = make_rules(multi_pod=multi_pod, fsdp=cfg.fsdp,
                       shard_heads=cfg.shard_heads,
                       seq_kv_data=seq_kv_data)
    if shape_cfg is not None and shape_cfg.global_batch % dp != 0:
        rules["batch"] = None            # e.g. long_500k's global_batch=1
    # sequence-parallel residual stream for many-token steps (decode
    # steps have S=1 — off)
    if (shape_cfg is not None and shape_cfg.kind in ("train", "prefill")
            and shape_cfg.seq_len % shape["model"] == 0):
        rules["act_seq"] = "model"
    # serving weight layout: no FSDP on the decode latency path; MoE
    # expert weights shard their ff dim over 'data' instead
    if shape_cfg is not None and shape_cfg.kind == "decode":
        rules["fsdp"] = None
        if cfg.moe is not None:
            rules["expert_ff"] = "data"
    rules.update(rule_overrides)
    return ShardCtx(mesh=mesh, rules=rules, dp_axes=dp_axes,
                    tp_axis="model",
                    pod_axis="pod" if multi_pod else None)


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
