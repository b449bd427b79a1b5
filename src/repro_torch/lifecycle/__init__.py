"""``repro_torch.lifecycle`` — container lifecycle, keep-alive and cold
starts (counterpart of ``repro.lifecycle``).

Per-``(worker, function)`` warm pools with idle clocks, an open registry
of keep-alive policies (``NONE``, ``FIXED_TTL``, ``HYBRID_HIST`` built
in), LRU eviction under slot pressure and a per-worker budget, and
per-function cold-start presets in place of the scalar penalty.  The
engines gate the whole plane on ``ClusterCfg.lifecycle``: the ``None``
default is the model without one, op for op.

A keep-alive registered here runs through the batched engine; the fused
``sim_engine`` kernel runs the built-ins, and
:func:`repro_torch.policy.engine` routes every other one to the batched
engine.  A tiered TTL in a few lines::

    import torch
    from repro_torch.lifecycle import register_keepalive

    def make_torch(cfg, n_functions, device):
        even = torch.arange(n_functions, device=device) % 2 == 0
        keep = torch.where(even, 2.0 * cfg.ttl_s, 0.5 * cfg.ttl_s).double()
        pre = torch.zeros(n_functions, dtype=torch.float64, device=device)
        return (lambda state: (pre, keep)), None

    register_keepalive("TIERED", make_torch=make_torch)
"""
import math

from .coldstart import (SCALAR, ColdStartPreset, cold_costs_for,
                        cold_preset_names, get_cold_preset,
                        parse_cold_preset, register_cold_preset)
from .config import LifecycleCfg
from .registry import (KeepAlivePolicy, ResolvedLifecycle, get_keepalive,
                       is_builtin, keepalive_names, parse_keepalive,
                       register_keepalive, resolve_lifecycle,
                       unregister_keepalive)
from .runtime import LifecycleRuntime


def lifecycle_from_flags(keepalive=None, ttl_s: float = 60.0,
                         max_idle: int = 0, coldstart: str = SCALAR):
    """An ``Optional[LifecycleCfg]`` from CLI flag values.

    Every name is checked against its registry.  Without a keep-alive, a
    cold-start preset or a budget alone turns the lifecycle on with an
    infinite ``FIXED_TTL`` window, so executors never expire; all flags
    at their defaults give ``None``.
    """
    preset = parse_cold_preset(coldstart)
    if keepalive is not None:
        return LifecycleCfg(keepalive=parse_keepalive(keepalive),
                            ttl_s=float(ttl_s), max_idle=int(max_idle),
                            coldstart=preset)
    if preset != SCALAR or int(max_idle) > 0:
        return LifecycleCfg(keepalive="FIXED_TTL", ttl_s=math.inf,
                            max_idle=int(max_idle), coldstart=preset)
    return None


__all__ = [
    "SCALAR", "ColdStartPreset", "KeepAlivePolicy", "LifecycleCfg",
    "LifecycleRuntime", "ResolvedLifecycle", "cold_costs_for",
    "cold_preset_names", "get_cold_preset", "get_keepalive", "is_builtin",
    "keepalive_names", "lifecycle_from_flags", "parse_cold_preset",
    "parse_keepalive", "register_cold_preset", "register_keepalive",
    "resolve_lifecycle", "unregister_keepalive",
]
