"""Port-side policy table and :func:`resolve`.

Counterpart of ``repro/policy/registry.py``, keyed by the same names.
The reference's registry is open (``register_balancer``); the port keeps
a fixed table of every balancer the reference registers, in the same
order (:func:`balancer_names`).  ``HIKU``, ``DD`` and ``SWARM`` carry
state (the reference's carried-state contract): their
:class:`ResolvedPolicy` has ``init_state`` and ``on_complete``, and its
``select`` takes and returns the state.

Backends: ``"torch"`` runs every balancer as plain tensor code;
``"kernel"`` sends a balancer that has a hand-written kernel (today
``H``, through :mod:`repro_torch.kernels.hermes_select`) to it and runs
the others as plain tensor code; ``"auto"`` is ``"kernel"`` for early
binding, mirroring the reference's ``default_backend``.  ``"np"`` is the
reference's numpy backend, one replication at a time on the host: the
backend of the oracle (:mod:`repro_torch.core.sim_ref`) and of the
numpy compat shims, which takes no device and which no engine runs.

Engines: :data:`ENGINES` and :func:`engine` say which engine runs a
policy.  On a CUDA device under ``"kernel"`` or ``"auto"``, early
binding with PS under any of the nine balancers runs whole in the fused
``sim_engine`` kernel (:mod:`repro_torch.kernels.sim_engine`), one launch
per ``simulate_many``, unless the cluster is one the kernel does not take
(:func:`engine`'s ``cluster``); everything else, every CPU device and
``"torch"`` run the batched engine of :mod:`repro_torch.core.simulator`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device

from . import balancers, scheds

BACKENDS = ("torch", "kernel", "np")
#: the backends the engines run (``"np"`` is the oracle's)
ENGINE_BACKENDS = ("torch", "kernel")

#: name -> (plain factory, kernel factory or None), in the reference's
#: registration order
BALANCERS = {
    "LOC": (balancers.loc, None),
    "R": (balancers.random_pick, None),
    "LL": (balancers.least_loaded, None),
    "H": (balancers.hybrid, balancers.hybrid_kernel),
    "JSQ2": (balancers.jsq2, None),
    "RR": (balancers.round_robin, None),
    "HIKU": (balancers.hiku, None),
    "DD": (balancers.data_driven, None),
    "SWARM": (balancers.swarm, None),
}
#: carried-state balancers -> ``init_state(R, W, F, device)``; their
#: factories return ``(select, on_complete)`` pairs
INIT_STATE = {"HIKU": balancers.hiku_init, "DD": balancers.dd_init,
              "SWARM": balancers.swarm_init}
SCHEDS = {"PS": scheds.ps, "FCFS": scheds.fcfs, "SRPT": scheds.srpt}
#: the numpy backend: name -> ``(cores, slots)`` factory (a ``(select,
#: on_complete)`` pair for a carried-state balancer, whose state comes
#: from ``INIT_STATE_NP[name](W, F)``); scheduler -> ``(cores)`` factory
BALANCERS_NP = {
    "LOC": balancers.loc_np, "R": balancers.random_np,
    "LL": balancers.least_loaded_np, "H": balancers.hybrid_np,
    "JSQ2": balancers.jsq2_np, "RR": balancers.round_robin_np,
    "HIKU": balancers.hiku_np, "DD": balancers.data_driven_np,
    "SWARM": balancers.swarm_np,
}
INIT_STATE_NP = {"HIKU": balancers.hiku_init_np,
                 "DD": balancers.dd_init_np,
                 "SWARM": balancers.swarm_init_np}
SCHEDS_NP = {"PS": scheds.ps_np, "FCFS": scheds.fcfs_np,
             "SRPT": scheds.srpt_np}
#: binding name -> late?
BINDINGS = {"E": False, "L": True}
#: (binding, balancer, scheduler) -> the engine that runs it on a CUDA
#: device under backend "kernel" or "auto"; a policy not listed, any CPU
#: device and backend "torch" take the batched engine
ENGINES = {("E", b, "PS"): "sim_engine" for b in BALANCERS}


def _name(x) -> str:
    return str(getattr(x, "value", x)).strip().upper()


def balancer_names() -> tuple[str, ...]:
    """Every balancer's name, in the reference's order (LOC, R, LL, H,
    then the zoo), as ``repro.policy.balancer_names`` gives them."""
    return tuple(BALANCERS)


def check_binding(name) -> bool:
    """Return whether binding ``name`` is late; named error if unknown."""
    key = _name(name)
    if key not in BINDINGS:
        raise ValueError(f"unknown binding {key!r}; registered bindings: "
                         f"{', '.join(sorted(BINDINGS))}")
    return BINDINGS[key]


def check_balancer(name) -> str:
    key = _name(name)
    if key not in BALANCERS:
        raise ValueError(
            f"unknown load balancer {key!r}; registered balancers: "
            f"{', '.join(sorted(BALANCERS))}")
    return key


def check_sched(name) -> str:
    key = _name(name)
    if key not in SCHEDS:
        raise ValueError(f"unknown worker scheduler {key!r}; registered "
                         f"schedulers: {', '.join(sorted(SCHEDS))}")
    return key


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """A policy resolved against one backend, cluster shape and device.

    ``select``/``rates`` are ``None`` for late binding: the engine owns
    the controller queue, places on ``argmin(active)`` and runs every
    dispatched task at rate 1.  For a carried-state balancer
    (:attr:`stateful`), ``init_state(R, W, F, device)`` makes the state
    (``init_state(W, F)`` under ``"np"``), ``select`` takes and returns
    it and ``on_complete`` updates it once per task completion; both are
    ``None`` otherwise.
    """

    spec: object
    backend: str
    late: bool
    select: Optional[Callable]
    rates: Optional[Callable]
    init_state: Optional[Callable] = None
    on_complete: Optional[Callable] = None

    @property
    def stateful(self) -> bool:
        return self.init_state is not None


def default_backend(policy) -> str:
    """The backend ``backend="auto"`` picks for the per-arrival select:
    the kernel where one exists.

    On a CUDA device the engine's route (:func:`engine`) comes first:
    there the port runs E/<B>/PS for every balancer, like E/H/PS, in a
    kernel (``sim_engine``), where the reference's ``default_backend``
    sends all but H to ``"jax"``.  The outputs are the same.
    """
    if check_binding(policy.binding):
        return "torch"
    key = check_balancer(policy.balance)
    has_kernel = BALANCERS[key][1] is not None
    return "kernel" if has_kernel else "torch"


def engine(policy, device, backend: str = "auto", cluster=None) -> str:
    """``"sim_engine"`` or ``"batched"``: the engine that runs ``policy``
    (a PolicySpec or ``"T/LB/S"`` text) on ``device`` under ``backend``.
    A table lookup; it needs no card.

    With a ``cluster``, a policy of the table still takes the batched
    engine (on the card too: a route, not a fallback) where the fused
    kernel does not take the cluster: more workers or slots than the
    kernel holds (``MAX_WORKERS``, ``MAX_SLOTS``), a lifecycle whose
    keep-alive is not one of the built-ins the kernel runs, or a fleet
    whose autoscaler or speed preset a user registered.  Telemetry and a
    timeline do not change the route: the kernel's observation and
    timeline planes carry them.
    """
    if isinstance(policy, str):
        from repro_torch.core.taxonomy import parse_policy
        policy = parse_policy(policy)
    check_engine_backend(backend)
    if backend == "torch" or torch.device(device).type != "cuda":
        return "batched"
    key = (_name(policy.binding), check_balancer(policy.balance),
           check_sched(policy.sched))
    route = ENGINES.get(key, "batched")
    if route == "sim_engine" and cluster is not None and \
            not _fused_takes(cluster):
        return "batched"
    return route


def check_engine_backend(backend: str) -> None:
    """A named error unless an engine runs ``backend``: ``"np"`` is the
    numpy oracle's, which no engine takes in place of its own."""
    if backend == "np":
        raise ValueError(
            "backend 'np' is the numpy oracle's, not an engine's: run "
            "repro_torch.core.sim_ref.simulate_ref for it, or choose from "
            f"{ENGINE_BACKENDS} or 'auto'")
    if backend not in (*ENGINE_BACKENDS, "auto"):
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{ENGINE_BACKENDS} or 'auto'")


def _fused_takes(cluster) -> bool:
    """Whether the fused kernel takes ``cluster``'s shape, lifecycle and
    fleet."""
    from repro_torch import fleet as fl
    from repro_torch.kernels.sim_engine.kernel import MAX_SLOTS, MAX_WORKERS
    from repro_torch.lifecycle import is_builtin
    if int(cluster.n_workers) > MAX_WORKERS or \
            int(cluster.slots) > MAX_SLOTS:
        return False
    life, fleet = cluster.lifecycle, cluster.fleet
    if life is not None and not is_builtin(life.keepalive):
        return False
    return fleet is None or (fl.is_builtin(fleet.autoscale)
                             and fl.preset_is_builtin(fleet))


def np_rates(sched, cores: int):
    """The numpy rates of scheduler ``sched`` for ``cores`` cores:
    ``rates(remaining, seqs) -> list[float]`` over one worker's tasks."""
    return SCHEDS_NP[check_sched(sched)](int(cores))


def np_select(balancer, cores: int, slots: int):
    """The numpy select of ``balancer`` for a cluster shape; a ``(select,
    on_complete)`` pair for a carried-state balancer, whose state
    :func:`resolve` with ``backend="np"`` hands over with it."""
    return BALANCERS_NP[check_balancer(balancer)](int(cores), int(slots))


def _resolve_np(policy, cluster) -> ResolvedPolicy:
    """The reference's ``resolve(policy, backend="np", cluster)``."""
    if check_binding(policy.binding):
        return ResolvedPolicy(spec=policy, backend="np", late=True,
                              select=None, rates=None)
    key = check_balancer(policy.balance)
    select, on_complete = np_select(key, cluster.cores, cluster.slots), None
    if key in INIT_STATE_NP:
        select, on_complete = select
    return ResolvedPolicy(
        spec=policy, backend="np", late=False, select=select,
        rates=np_rates(policy.sched, cluster.cores),
        init_state=INIT_STATE_NP.get(key), on_complete=on_complete)


def resolve(policy, cluster, device=None, backend: str = "auto"
            ) -> ResolvedPolicy:
    """Resolve ``policy`` (a PolicySpec or ``"T/LB/S"`` text) into batched
    callables for ``cluster`` on ``device`` (``None`` = CUDA); under
    ``backend="np"``, into the reference's numpy callables, one
    replication at a time on the host, which take no device."""
    if isinstance(policy, str):
        from repro_torch.core.taxonomy import parse_policy
        policy = parse_policy(policy)
    if backend == "np":
        if device is not None:
            raise ValueError("backend 'np' runs on the host and takes no "
                             f"device (got {device!r})")
        cluster.validate()
        return _resolve_np(policy, cluster)
    dev = resolve_device(device)
    cluster.validate()
    if backend == "auto":
        backend = default_backend(policy)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS} or 'auto'")
    if check_binding(policy.binding):
        return ResolvedPolicy(spec=policy, backend=backend, late=True,
                              select=None, rates=None)
    key = check_balancer(policy.balance)
    make_plain, make_kernel = BALANCERS[key]
    make = make_kernel if backend == "kernel" and make_kernel else make_plain
    C, S, W = int(cluster.cores), int(cluster.slots), int(cluster.n_workers)
    select, on_complete = make(C, S, W, dev), None
    if key in INIT_STATE:
        select, on_complete = select
    return ResolvedPolicy(
        spec=policy, backend=backend, late=False, select=select,
        rates=SCHEDS[check_sched(policy.sched)](C, dev),
        init_state=INIT_STATE.get(key), on_complete=on_complete)
