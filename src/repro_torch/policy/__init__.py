"""``repro_torch.policy`` — the ported policy table and :func:`resolve`."""
from .registry import (BALANCERS, BINDINGS, NOT_PORTED, SCHEDS,
                       NotPortedError, ResolvedPolicy, default_backend,
                       resolve)

__all__ = ["BALANCERS", "BINDINGS", "NOT_PORTED", "SCHEDS",
           "NotPortedError", "ResolvedPolicy", "default_backend", "resolve"]
