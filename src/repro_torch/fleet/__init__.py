"""``repro_torch.fleet`` — heterogeneous workers and latency-target
autoscaling (counterpart of ``repro.fleet``).

* **Heterogeneity**: :class:`FleetCfg` per-worker ``speed[W]`` /
  ``mem[W]`` vectors (explicit or from the named presets ``uniform`` /
  ``two-gen`` / ``long-tail``), carried as ``ClusterCfg.fleet``; ``None``
  keeps the homogeneous model, op for op.
* **SWARM balancing** lives in :mod:`repro_torch.policy.balancers` (it
  learns per-worker slowness online without reading ``FleetCfg``).
* **Autoscaling**: the open :func:`register_autoscaler` registry
  (``STATIC`` / ``TARGET_P99``) driving an active-worker count through
  both engines against a p99-slowdown target, read off the telemetry
  sketch.

Both engines run every fleet; on the card, a built-in autoscaler and a
built-in preset (or an explicit speed vector) run inside the fused
``sim_engine`` kernel's observation plane, anything a user registered
in the batched engine.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .config import (BUILTIN_PRESETS, FLEET_PRESETS, FleetCfg, STATIC,
                     fleet_preset_names, mem_for, parse_fleet_preset,
                     preset_is_builtin, register_fleet_preset, speeds_for)
from .registry import (AUTOSCALERS, AutoscalePolicy, ResolvedFleet,
                       autoscaler_names, get_autoscaler, is_builtin,
                       parse_autoscale, register_autoscaler, resolve_fleet,
                       unregister_autoscaler)

__all__ = [
    "BUILTIN_PRESETS", "FLEET_PRESETS", "FleetCfg", "STATIC",
    "fleet_preset_names", "mem_for", "parse_fleet_preset",
    "preset_is_builtin", "register_fleet_preset", "speeds_for",
    "AUTOSCALERS", "AutoscalePolicy", "ResolvedFleet", "autoscaler_names",
    "get_autoscaler", "is_builtin", "parse_autoscale",
    "register_autoscaler", "resolve_fleet", "unregister_autoscaler",
    "fleet_from_flags",
]


def fleet_from_flags(preset: Optional[str] = None,
                     speed: Optional[Sequence[float]] = None,
                     autoscale: Optional[str] = None,
                     target_p99: float = 5.0,
                     min_workers: int = 1,
                     cooldown_s: float = 60.0,
                     hysteresis: float = 0.1) -> Optional[FleetCfg]:
    """A :class:`FleetCfg` from CLI flag values, or ``None``.

    With every fleet flag at its default the result is ``None`` (the
    homogeneous fixed-W model); preset and autoscale names are checked
    against their registries up front, so a typo raises the named
    ``ValueError``.  An autoscale flag without a preset runs on the
    ``uniform`` fleet.
    """
    if preset is None and not speed and autoscale is None:
        return None
    kw = {}
    if preset is not None:
        kw["preset"] = parse_fleet_preset(preset)
    if speed:
        kw["speed"] = tuple(float(s) for s in speed)
    if autoscale is not None:
        kw["autoscale"] = parse_autoscale(autoscale)
        kw["target_p99"] = float(target_p99)
        kw["min_workers"] = int(min_workers)
        kw["cooldown_s"] = float(cooldown_s)
        kw["hysteresis"] = float(hysteresis)
    return FleetCfg(**kw)
