"""Fused engine entry points: the kernel on the card, its plain version
for tensors on the CPU."""
from __future__ import annotations

from . import kernel
from .ref import (ChunkPlan, chunk_init, chunk_plan, sim_engine_chunk_ref,
                  sim_engine_ref)

__all__ = ["ChunkPlan", "chunk_init", "chunk_plan", "sim_engine",
           "sim_engine_chunk"]


def sim_engine(balance, cluster, arrival, func, service, u_lb, home,
               telemetry=None, timeline=None, keep_state=False):
    """One early-binding, PS ``simulate_many`` under the balancer
    ``balance`` (see :func:`.ref.sim_engine_ref`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel, which raises on
    anything it does not take."""
    if arrival.device.type == "cpu":
        return sim_engine_ref(balance, cluster, arrival, func, service, u_lb,
                              home, telemetry, timeline, keep_state)
    return kernel.sim_engine(balance, cluster, arrival, func, service, u_lb,
                             home, telemetry, timeline, keep_state)


def sim_engine_chunk(plan: ChunkPlan, carry, arrival, func, service, u_lb,
                     home, *, g0: int, drain: bool, cutoff: int,
                     window_s=None):
    """One chunk of a stream (see :func:`.ref.sim_engine_chunk_ref`):
    ``(carry, {"rejected", "cold", "worker_of"})``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel's chunk mode."""
    if arrival.device.type == "cpu":
        return sim_engine_chunk_ref(plan, carry, arrival, func, service,
                                    u_lb, home, g0, drain, cutoff, window_s)
    return kernel.sim_engine_chunk(plan, carry, arrival, func, service, u_lb,
                                   home, g0, drain, cutoff, window_s)
