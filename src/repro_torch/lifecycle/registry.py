"""Open keep-alive policy registry (counterpart of
``repro/lifecycle/registry.py``).

**The keep-alive contract.**  Warm executors live in per-``(worker,
function)`` pools, and the engines keep one idle-since time per pool
(the time of its latest completion).  A policy maps its carried state,
if it has one, to per-function *windows*::

    windows(state) -> (pre, keep)     # f64 seconds, [F] or [R, F]

A pool of function ``f`` whose idle age is ``a = now - idle_since`` is
**materialized** iff ``pre[f] <= a <= pre[f] + keep[f]``.  Only
materialized pools serve warm hits, take memory (slot pressure and the
``max_idle`` budget) and are eviction candidates.  Expiry is lazy: the
engines apply the window wherever they read a pool's count, and zero a
stale pool when its next completion refreshes it.

An adaptive policy also declares ``init_state(cfg, n_reps, n_workers,
n_functions, device)``, a dict of ``[R, …]`` tensors, and an
observation hook that the engines call at each placement with the placed
pool's idle age, batched over the replications::

    observe(state, func [R] i64, gap [R] f64, mask [R] bool) -> state

which leaves a replication's state as it was where ``mask`` is false.
``make_torch(cfg, n_functions, device) -> (windows, observe)`` builds
both (``observe`` is ``None`` for a stateless policy, whose ``windows``
ignores its argument and returns ``[F]`` tensors).  It takes the place of
the reference's ``make_jax``: the float operations run in its order, so
the windows are bit-equal to it and to ``make_np``.

A policy may also carry the reference's numpy backend, one run on the
host (the oracle's, :mod:`repro_torch.core.sim_ref`): ``make_np(cfg,
n_functions) -> (windows, observe)`` over numpy arrays, ``observe(state,
func, gap) -> state`` with scalars, and, for an adaptive policy,
``init_np(cfg, n_workers, n_functions)``.  The built-ins have it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device

from .config import LifecycleCfg


@dataclasses.dataclass(frozen=True)
class KeepAlivePolicy:
    """A registered keep-alive strategy (see the module contract)."""

    name: str
    doc: str = ""
    make_torch: Optional[Callable[[LifecycleCfg, int, Any], tuple]] = None
    init_state: Optional[Callable[..., dict]] = None
    make_np: Optional[Callable[[LifecycleCfg, int], tuple]] = None
    init_np: Optional[Callable[[LifecycleCfg, int, int], dict]] = None

    @property
    def stateful(self) -> bool:
        return self.init_state is not None


KEEPALIVES: dict[str, KeepAlivePolicy] = {}
#: the built-in records, as registered at import; the fused engine runs
#: exactly these (see :func:`is_builtin`)
BUILTINS: dict[str, KeepAlivePolicy] = {}

_builtin_lock = threading.Lock()
_builtins_loaded = False


def _load_builtins() -> None:
    """Register the built-in policies once.  The flag is set before the
    import, whose registrations re-enter :func:`register_keepalive`; a
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


def register_keepalive(name: str, *, make_torch=None, init_state=None,
                       make_np=None, init_np=None, doc: str = "",
                       overwrite: bool = False) -> KeepAlivePolicy:
    """Register a keep-alive policy under ``name`` (upper-cased).

    ``init_state`` opts into the carried-state contract (``make_torch``
    then returns a non-``None`` observe hook; ``init_np`` and ``make_np``
    are its numpy backend, which the oracle needs).  A policy registered
    here runs in the batched engine; the fused engine runs the built-ins
    only.
    """
    name = name.strip().upper()
    if "/" in name or "*" in name or not name:
        raise ValueError(f"invalid keep-alive name {name!r}")
    if make_torch is None:
        raise ValueError(f"keep-alive {name!r} needs a make_torch factory")
    # built-ins first, so that a collision with one is reported here
    _load_builtins()
    if not overwrite and name in KEEPALIVES:
        raise ValueError(f"keep-alive {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    ka = KeepAlivePolicy(name=name, doc=doc, make_torch=make_torch,
                         init_state=init_state, make_np=make_np,
                         init_np=init_np)
    KEEPALIVES[name] = ka
    return ka


def unregister_keepalive(name: str) -> None:
    _load_builtins()
    KEEPALIVES.pop(str(name).strip().upper(), None)


def keepalive_names() -> tuple[str, ...]:
    _load_builtins()
    return tuple(KEEPALIVES)


def get_keepalive(name) -> KeepAlivePolicy:
    _load_builtins()
    key = str(name).strip().upper()
    try:
        return KEEPALIVES[key]
    except KeyError:
        raise ValueError(
            f"unknown keep-alive policy {key!r}; registered keep-alive "
            f"policies: "
            f"{', '.join(sorted(KEEPALIVES))}") from None


def parse_keepalive(name: str) -> str:
    """The canonical (upper-cased) name of a registered keep-alive; the
    registry's named ``ValueError`` listing the registered ones
    otherwise."""
    return get_keepalive(name).name


def is_builtin(name) -> bool:
    """Whether ``name`` is registered as the built-in policy of that name
    (not a user's policy, nor one registered over a built-in)."""
    _load_builtins()
    key = str(name).strip().upper()
    return key in BUILTINS and KEEPALIVES.get(key) is BUILTINS[key]


@dataclasses.dataclass(frozen=True)
class ResolvedLifecycle:
    """A lifecycle config resolved for one function count and device.

    ``windows``/``observe`` follow the module contract (``observe`` is
    ``None`` for a stateless policy); under ``backend="np"`` they are the
    numpy backend's and ``device`` is ``None``.  ``cold_costs`` is the
    preset's per-function cost vector (``np.ndarray [F]``), or ``None``
    for the scalar penalty.  ``max_idle`` is the per-worker budget (0:
    none).
    """

    cfg: LifecycleCfg
    policy: KeepAlivePolicy
    device: Optional[torch.device]
    windows: Callable
    observe: Optional[Callable]
    cold_costs: Optional[Any]
    max_idle: int
    backend: str = "torch"

    @property
    def stateful(self) -> bool:
        return self.policy.stateful

    def init_policy_state(self, n_reps: int, n_workers: int,
                          n_functions: int):
        """The policy's fresh ``[R, …]`` state, or ``None``; under
        ``"np"`` the one run's numpy state (``n_reps`` is not read)."""
        if self.policy.init_state is None:
            return None
        if self.backend == "np":
            return self.policy.init_np(self.cfg, n_workers, n_functions)
        return self.policy.init_state(self.cfg, n_reps, n_workers,
                                      n_functions, self.device)


def resolve_lifecycle(cluster, n_functions: int, device=None, *,
                      backend: str = "torch"
                      ) -> Optional[ResolvedLifecycle]:
    """Resolve ``cluster.lifecycle`` for ``n_functions`` functions on
    ``device`` (``None`` = CUDA); ``None`` when the cluster has no
    lifecycle, so that an engine gates the whole plane on one check.
    ``backend="np"`` resolves the numpy backend on the host (the
    oracle's), which takes no device."""
    cfg = getattr(cluster, "lifecycle", None)
    if cfg is None:
        return None
    if backend not in ("torch", "np"):
        raise ValueError(f"unknown lifecycle backend {backend!r}; choose "
                         f"from ('torch', 'np')")
    ka = get_keepalive(cfg.keepalive)
    if backend == "np":
        if device is not None:
            raise ValueError("the np lifecycle runs on the host and takes "
                             f"no device (got {device!r})")
        if ka.make_np is None or (ka.stateful and ka.init_np is None):
            raise ValueError(f"keep-alive {ka.name!r} has no np backend "
                             f"(register it with make_np and, if it "
                             f"carries state, init_np)")
        dev, (windows, observe) = None, ka.make_np(cfg, int(n_functions))
    else:
        dev = resolve_device(device)
        windows, observe = ka.make_torch(cfg, int(n_functions), dev)
    from .coldstart import cold_costs_for
    costs = cold_costs_for(cfg.coldstart, int(n_functions))
    return ResolvedLifecycle(cfg=cfg, policy=ka, device=dev,
                             windows=windows, observe=observe,
                             cold_costs=costs, max_idle=int(cfg.max_idle),
                             backend=backend)
