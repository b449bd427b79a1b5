"""Fleet configuration: per-worker speed/memory vectors and presets
(counterpart of ``repro/fleet/config.py``).

The paper's cluster is homogeneous: every worker has identical cores
and unit speed.  Real providers run mixed hardware generations; the
fleet layer gives :class:`~repro_torch.core.cluster.ClusterCfg` a
per-worker ``speed[W]`` vector (service times on worker ``w`` scale by
``1 / speed[w]``) and a reserved ``mem[W]`` vector, either explicit or
derived from a named preset.

``FleetCfg`` is a plain ``NamedTuple`` of hashable scalars/tuples, so a
``ClusterCfg`` carrying one stays hashable and carries across from the
reference's field for field.  The ``ClusterCfg.fleet`` default of
``None`` keeps the homogeneous model, op for op (the same gate as
``lifecycle`` and ``telemetry``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

#: Name of the pass-through autoscale policy (fixed worker set).
STATIC = "STATIC"


class FleetCfg(NamedTuple):
    """Heterogeneous-fleet model for a :class:`ClusterCfg`.

    ``speed`` / ``mem`` are per-worker vectors (tuples, so the config
    stays hashable); empty tuples mean "derive from ``preset``".
    ``speed[w] = 0.5`` makes worker ``w`` run every invocation twice as
    long; cold-start penalties scale the same way (spin-up is compute
    too).  ``mem`` is validated and carried but semantically reserved:
    per-worker slot capacity is the memory-aware-lifecycle ROADMAP item
    and would change the scalar ``(cores, slots)`` balancer contract.

    The autoscale fields configure the closed-loop controller
    (:mod:`repro_torch.fleet.policies`): ``autoscale="TARGET_P99"`` grows /
    shrinks the active worker set against ``target_p99`` slowdown with
    ``hysteresis`` dead-band and ``cooldown_s`` between decisions,
    never below ``min_workers``.  ``"STATIC"`` (default) keeps all
    ``W`` workers active.
    """

    preset: str = "uniform"
    speed: tuple = ()
    mem: tuple = ()
    autoscale: str = STATIC
    target_p99: float = 5.0
    min_workers: int = 1
    cooldown_s: float = 60.0
    hysteresis: float = 0.1


def _uniform(W: int) -> np.ndarray:
    return np.ones(W, dtype=np.float64)


def _two_gen(W: int) -> np.ndarray:
    """Half current-gen (speed 1.0), half previous-gen (speed 0.5)."""
    new = (W + 1) // 2
    s = np.full(W, 0.5, dtype=np.float64)
    s[:new] = 1.0
    return s


def _long_tail(W: int) -> np.ndarray:
    """Smooth generational decay: fastest 1.0 down to slowest 0.25."""
    k = np.arange(W, dtype=np.float64)
    return 1.0 / (1.0 + 3.0 * k / max(W - 1, 1))


FLEET_PRESETS: dict[str, Callable[[int], np.ndarray]] = {}
#: the built-in presets, as registered at import; the fused engine runs
#: these and explicit speed vectors (see :func:`preset_is_builtin`)
BUILTIN_PRESETS: dict[str, Callable[[int], np.ndarray]] = {}


def register_fleet_preset(name: str, make, *, overwrite: bool = False):
    """Register a named ``W -> speed[W]`` fleet preset."""
    name = str(name).strip().lower()
    if not name or "/" in name:
        raise ValueError(f"invalid fleet preset name {name!r}")
    if not overwrite and name in FLEET_PRESETS:
        raise ValueError(f"fleet preset {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    FLEET_PRESETS[name] = make
    return make


register_fleet_preset("uniform", _uniform)
register_fleet_preset("two-gen", _two_gen)
register_fleet_preset("long-tail", _long_tail)
BUILTIN_PRESETS.update(FLEET_PRESETS)


def preset_is_builtin(fleet: FleetCfg) -> bool:
    """Whether ``fleet``'s speeds come from an explicit vector or from a
    built-in preset as registered at import (not one a user registered
    or overwrote)."""
    if fleet.speed:
        return True
    key = str(fleet.preset).strip().lower()
    return key in BUILTIN_PRESETS and \
        FLEET_PRESETS.get(key) is BUILTIN_PRESETS[key]


def fleet_preset_names() -> tuple[str, ...]:
    return tuple(FLEET_PRESETS)


def parse_fleet_preset(name: str) -> str:
    """Validate a CLI preset token; returns the canonical name."""
    key = str(name).strip().lower()
    if key not in FLEET_PRESETS:
        raise ValueError(
            f"unknown fleet preset {key!r}; registered fleet presets: "
            f"{', '.join(sorted(FLEET_PRESETS))}")
    return key


def speeds_for(fleet: FleetCfg, n_workers: int) -> np.ndarray:
    """Resolve the per-worker speed vector (``[W] float64``).

    An explicit ``fleet.speed`` tuple wins; otherwise the named preset
    generates it.  Length/positivity are enforced by
    :meth:`ClusterCfg.validate`; this re-checks length so direct
    callers fail with the same named error.
    """
    if fleet.speed:
        s = np.asarray(fleet.speed, dtype=np.float64)
        if s.shape != (n_workers,):
            raise ValueError(
                f"FleetCfg.speed has {s.size} entries for "
                f"n_workers={n_workers}, got {tuple(fleet.speed)}")
        return s
    return np.asarray(FLEET_PRESETS[parse_fleet_preset(fleet.preset)](
        int(n_workers)), dtype=np.float64)


def mem_for(fleet: FleetCfg, n_workers: int) -> np.ndarray:
    """Resolve the per-worker memory vector (``[W] float64``, unit 1.0
    default).  Reserved: validated and carried, not yet consumed by the
    engines (memory-aware lifecycle is a separate ROADMAP item)."""
    if fleet.mem:
        m = np.asarray(fleet.mem, dtype=np.float64)
        if m.shape != (n_workers,):
            raise ValueError(
                f"FleetCfg.mem has {m.size} entries for "
                f"n_workers={n_workers}, got {tuple(fleet.mem)}")
        return m
    return np.ones(n_workers, dtype=np.float64)
