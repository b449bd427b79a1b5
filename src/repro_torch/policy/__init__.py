"""``repro_torch.policy`` — the ported policy table and :func:`resolve`."""
from .registry import (BALANCERS, BINDINGS, ENGINES, INIT_STATE, SCHEDS,
                       ResolvedPolicy, balancer_names, default_backend,
                       engine, resolve)

__all__ = ["BALANCERS", "BINDINGS", "ENGINES", "INIT_STATE", "SCHEDS",
           "ResolvedPolicy", "balancer_names", "default_backend", "engine",
           "resolve"]
