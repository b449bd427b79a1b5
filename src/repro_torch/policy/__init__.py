"""``repro_torch.policy`` — the ported policy table and :func:`resolve`."""
from .registry import (BALANCERS, BINDINGS, ENGINES, NOT_PORTED, SCHEDS,
                       NotPortedError, ResolvedPolicy, default_backend,
                       engine, resolve)

__all__ = ["BALANCERS", "BINDINGS", "ENGINES", "NOT_PORTED", "SCHEDS",
           "NotPortedError", "ResolvedPolicy", "default_backend", "engine",
           "resolve"]
