"""Open autoscale-policy registry (counterpart of
``repro/fleet/registry.py``).

Capacity is the third scheduling axis: the balancer decides *where*,
the worker scheduler *in what order*, and the autoscaler *how much
fleet exists at all*.

**The autoscale contract.**  The engines keep an *active-worker count*
``n_on`` per replication (workers ``0..n_on-1`` accept placements; the
rest read as slot-full at selection, so the balancer contract is
untouched) and a histogram *window*: the slowdown-sketch counts recorded
since the last decision (the telemetry plane is the sensor).  A policy
is a pair of backend factories::

    make_np(cfg, n_workers)            -> decide(n_on, window) -> n_on'
    make_torch(cfg, n_workers, device) -> decide(n_on, window) -> n_on'

The numpy ``decide`` takes one replication (``n_on`` int, ``window
[N_BINS]`` int64); the torch one is batched over the replications
(``n_on [R]`` int32, ``window [R, N_BINS]`` int64, returns ``[R]``
int32).  Either returns the new count already clipped to
``[cfg.min_workers, n_workers]``.  The engines call it only when the
cooldown has elapsed *and* the window is non-empty (the torch engine
calls it every arrival and keeps its answer only there), then snapshot
the sketch and re-arm the cooldown.  ``decide`` must take the same
integer decisions in both backends: read percentiles with
:func:`repro_torch.telemetry.sketch.sketch_percentile`'s exact op
sequence, as ``TARGET_P99`` does.

A policy registered here runs in the batched engine; the fused
``sim_engine`` kernel runs the built-ins (``STATIC``, ``TARGET_P99``)
in its observation plane, and :func:`repro_torch.policy.engine` routes
every other one to the batched engine.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np

from .config import FleetCfg, STATIC, mem_for, speeds_for

_BACKENDS = ("np", "torch")


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """A registered autoscale strategy (see the module contract)."""

    name: str
    doc: str = ""
    make_np: Optional[Callable[[FleetCfg, int], Callable]] = None
    make_torch: Optional[Callable[[FleetCfg, int, Any], Callable]] = None
    #: ``True`` when ``decide`` reads the telemetry slowdown sketch: the
    #: engines then require a ``TelemetryCfg`` (named error if absent).
    #: ``STATIC`` has no sensor and runs anywhere.
    needs_telemetry: bool = True

    def backends(self) -> tuple[str, ...]:
        return tuple(b for b, fn in zip(
            _BACKENDS, (self.make_np, self.make_torch)) if fn is not None)


AUTOSCALERS: dict[str, AutoscalePolicy] = {}
#: the built-in records, as registered at import; the fused engine runs
#: exactly these (see :func:`is_builtin`)
BUILTINS: dict[str, AutoscalePolicy] = {}

_builtin_lock = threading.Lock()
_builtins_loaded = False


def _load_builtins() -> None:
    """Register the built-in policies once.  The flag is set before the
    import, whose registrations re-enter :func:`register_autoscaler`; a
    failed import resets it."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    with _builtin_lock:
        if _builtins_loaded:
            return
        _builtins_loaded = True
        try:
            from . import policies  # noqa: F401  (registers on import)
        except BaseException:
            _builtins_loaded = False
            raise


def register_autoscaler(name: str, *, make_np=None, make_torch=None,
                        needs_telemetry: bool = True, doc: str = "",
                        overwrite: bool = False) -> AutoscalePolicy:
    """Register an autoscale policy under ``name`` (upper-cased).

    At least one of ``make_np`` / ``make_torch`` must be given; the
    engines need ``make_torch``.  Returns the :class:`AutoscalePolicy`
    record.
    """
    name = name.strip().upper()
    if "/" in name or "*" in name or not name:
        raise ValueError(f"invalid autoscale policy name {name!r}")
    if make_np is None and make_torch is None:
        raise ValueError(
            f"autoscaler {name!r} needs an np or torch backend")
    # built-ins first, so that a collision with one is reported here
    _load_builtins()
    if not overwrite and name in AUTOSCALERS:
        raise ValueError(f"autoscaler {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    pol = AutoscalePolicy(name=name, doc=doc, make_np=make_np,
                          make_torch=make_torch,
                          needs_telemetry=needs_telemetry)
    AUTOSCALERS[name] = pol
    return pol


def unregister_autoscaler(name: str) -> None:
    _load_builtins()
    AUTOSCALERS.pop(str(name).strip().upper(), None)


def autoscaler_names() -> tuple[str, ...]:
    _load_builtins()
    return tuple(AUTOSCALERS)


def get_autoscaler(name) -> AutoscalePolicy:
    _load_builtins()
    key = str(name).strip().upper()
    try:
        return AUTOSCALERS[key]
    except KeyError:
        raise ValueError(
            f"unknown autoscale policy {key!r}; registered autoscale "
            f"policies: "
            f"{', '.join(sorted(AUTOSCALERS))}") from None


def parse_autoscale(name: str) -> str:
    """Validate a CLI autoscale token; returns the canonical name."""
    return get_autoscaler(name).name


def is_builtin(name) -> bool:
    """Whether ``name`` is a built-in autoscaler as registered at import
    (not one a user registered or overwrote)."""
    _load_builtins()
    key = str(name).strip().upper()
    return key in BUILTINS and AUTOSCALERS.get(key) is BUILTINS[key]


# --------------------------------------------------------------------------
# resolve: fleet cfg -> speed vector + decide callable (the engines' entry)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolvedFleet:
    """A fleet config resolved against one backend and worker count.

    ``speeds`` / ``mem`` are the concrete ``[W]`` float64 numpy vectors.
    ``decide`` follows the module contract for the chosen backend;
    ``auto_on`` is ``False`` for ``STATIC`` (no decisions, no state: the
    engines then apply speed scaling only).
    """

    cfg: FleetCfg
    policy: AutoscalePolicy
    backend: str
    speeds: np.ndarray
    mem: np.ndarray
    decide: Optional[Callable]

    @property
    def auto_on(self) -> bool:
        return self.cfg.autoscale.strip().upper() != STATIC

    @property
    def uniform(self) -> bool:
        """True when every worker runs at exactly speed 1.0."""
        return bool(np.all(self.speeds == 1.0))


def resolve_fleet(cluster, *, backend: str = "np", device=None
                  ) -> Optional[ResolvedFleet]:
    """Resolve ``cluster.fleet`` into the speed vector and decide hook.

    Returns ``None`` when the cluster carries no fleet config (the
    homogeneous fixed-W model), so engines gate the whole subsystem on
    one check.  ``backend`` is ``"np"`` or ``"torch"`` (whose ``decide``
    works on ``device``).
    """
    cfg = getattr(cluster, "fleet", None)
    if cfg is None:
        return None
    _load_builtins()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown fleet backend {backend!r}; "
                         f"choose from {_BACKENDS}")
    pol = get_autoscaler(cfg.autoscale)
    W = int(cluster.n_workers)
    if backend == "np":
        make = pol.make_np and (lambda: pol.make_np(cfg, W))
    else:
        make = pol.make_torch and (lambda: pol.make_torch(cfg, W, device))
    if make is None:
        raise ValueError(f"autoscaler {pol.name!r} has no {backend} "
                         f"backend (has: {pol.backends()})")
    return ResolvedFleet(cfg=cfg, policy=pol, backend=backend,
                         speeds=speeds_for(cfg, W), mem=mem_for(cfg, W),
                         decide=make())
