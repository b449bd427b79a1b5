"""``repro_torch.policy`` — the ported policy table and :func:`resolve`."""
from .balancers import hermes_score_np
from .registry import (BALANCERS, BALANCERS_NP, BINDINGS, ENGINES,
                       INIT_STATE, INIT_STATE_NP, SCHEDS, SCHEDS_NP,
                       ResolvedPolicy, balancer_names, default_backend,
                       engine, np_rates, np_select, resolve)

__all__ = ["BALANCERS", "BALANCERS_NP", "BINDINGS", "ENGINES", "INIT_STATE",
           "INIT_STATE_NP", "SCHEDS", "SCHEDS_NP", "ResolvedPolicy",
           "balancer_names", "default_backend", "engine", "hermes_score_np",
           "np_rates", "np_select", "resolve"]
