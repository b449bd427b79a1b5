"""Fused engine entry point: the kernel on the card, its plain version
for tensors on the CPU."""
from __future__ import annotations

from . import kernel
from .ref import sim_engine_ref


def sim_engine(balance, cluster, arrival, func, service, u_lb, home,
               telemetry=None, timeline=None):
    """One early-binding, PS ``simulate_many`` under the balancer
    ``balance`` (see :func:`.ref.sim_engine_ref`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel, which raises on
    anything it does not take."""
    if arrival.device.type == "cpu":
        return sim_engine_ref(balance, cluster, arrival, func, service, u_lb,
                              home, telemetry, timeline)
    return kernel.sim_engine(balance, cluster, arrival, func, service, u_lb,
                             home, telemetry, timeline)
