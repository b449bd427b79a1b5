"""Discrete-event policy simulator on torch tensors.

Counterpart of ``repro/core/simulator.py`` (early and late binding, the
container lifecycle, telemetry, the heterogeneous fleet and its
autoscaler, the timeline, and the chunk engine of
:func:`repro_torch.core.streaming.simulate_stream`).  The reference
runs a ``lax.scan`` over arrivals under ``jax.vmap``; here the replication axis ``R`` is written out as the
leading axis of every state tensor and the scan is a Python loop:

* per arrival, ``advance`` fast-forwards every replication to the
  arrival time, one completion per iteration (the earliest-finishing
  slot, lowest flat index on ties), then the balancer picks a worker
  (early binding) or the controller queues (late binding);
* a batched ``lax.while_loop`` runs its body on every replication but
  keeps the new state only where that replication's predicate holds, and
  a batched ``lax.cond`` evaluates both branches and selects.  The port
  does the same with :func:`_merge`, so rows whose loop has ended never
  take the garbage their body computed;
* completions that did not happen scatter into the scratch index ``N``
  of the per-arrival planes and the pad column ``F`` of ``warm``, as in
  the reference, so every replication executes the same ops.

Each loop iteration reads one boolean back to the host (``go.any()``).
Pass a :class:`LoopStats` to count iterations and those syncs.

On a CUDA device, early binding with PS under any balancer does not
take this engine: :func:`repro_torch.policy.engine` routes it to the
fused ``sim_engine`` kernel, which runs the same loop (one block per
replication, no masking, no host reads) in one launch and returns the
same planes bit for bit.

State (``R`` replications × ``W`` workers × ``S`` slots):

==============  ========  =====================================
``remaining``   f64       remaining work; ``inf`` in empty slots
``task_arr``    f64       arrival time of the occupying task
``task_idx``    i32       arrival index (doubles as FCFS seq); -1 empty
``warm``        i32       ``[R, W, F+1]`` idle warm executors (+1 pad col)
``q``           i32       ``[R, N]`` late-binding FIFO ring
``resp`` …      f64 …     ``[R, N+1]`` per-arrival planes (last = scratch)
``lb_<key>``    …         a carried-state balancer's ``[R, …]`` state
==============  ========  =====================================

With ``cluster.lifecycle`` set (:mod:`repro_torch.lifecycle`) the
engine carries the reference's ``life`` plane, op for op: ``idle_since
[R, W, F+1]`` f64 (-1: no completion yet; the pad column again),
``pre``/``keep [R, F]`` and the keep-alive's own state.  Selection sees
the *materialized* warm column (pools inside their window), placement
decides cold starts, slot-pressure evictions (the LRU materialized pool)
and the preset's cost over the materialized pools, then feeds an
adaptive keep-alive the placed pool's idle age; a completion zeroes a
stale pool before its increment, refreshes its idle clock and enforces
the ``max_idle`` budget.  With ``lifecycle=None`` none of these
operations is made.

A carried-state balancer (HIKU, DD, SWARM) threads its state as the
reference does: ``select`` takes and returns it at each arrival, and
each advance iteration calls ``on_complete`` for the argmin slot with the
task's nominal service (no cold-start penalty; divided by the worker's
speed under a fleet) and the worker's active count after the slot is
cleared, keeping the update only where that slot completed.

With ``telemetry`` (:class:`~repro_torch.telemetry.TelemetryCfg`) the
engine carries the reference's ``tel`` plane as ``tel_<key>`` entries
(:mod:`repro_torch.telemetry.engine`), updated where the reference
updates it: each placement (cold/warm, slot-pressure eviction, the
decision count), each advance iteration (busy, depth and queue-length
integrals over the pre-advance occupancy), each completion (both
histograms, past the warmup cutoff), each budget eviction and each
rejection.  With ``cluster.fleet`` every rate is multiplied by the
worker's speed (late binding too), and an autoscaler carries
``fleet_n_on``, ``fleet_cool_until``, ``fleet_prov_time`` and
``fleet_snap``: per arrival, the provisioned-time integral over the gap,
then after the advance the gated decision (cooldown elapsed and a
recorded completion since the last snapshot) and the mask that makes
workers ``>= n_on`` read as slot-full at the choice.  Without either,
none of these operations is made.

With ``timeline`` (:class:`~repro_torch.telemetry.TimelineCfg`) the engine
carries the reference's windowed flight recorder as ``tl_<key>`` entries
(:mod:`repro_torch.telemetry.timeline_engine`), at the reference's sites
and in its order: per arrival the provisioned core-seconds over the gap
(``n_on`` or ``W`` workers, in the gap start's window), per advance
iteration the busy and queue-length integrals, per completion both coarse
sketches (no warmup cutoff), each budget eviction, the autoscaler's
decision where it changed the level (with the sensor p99 of its window),
the arrival and its ``n_on``, Hermes' pack/spread flips under early
binding, each rejection and placement, and the drain's provisioned tail.
The width is the last arrival over ``K`` per replication (or the
configured one).  Without it, none of these operations is made.

``_build_engine(..., stream=True)`` is the stream's chunk engine: the
same per-arrival operations over any chunk of arrivals from a carry
without a plane of the horizon's length (slot mirrors of each occupant's
function and service, exact online counters), the drain on its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleet import STATIC, get_autoscaler, resolve_fleet
from repro_torch.kernels.sim_engine import ops as sim_engine_ops
from repro_torch.lifecycle import resolve_lifecycle
from repro_torch.policy import engine, resolve
from repro_torch.policy.registry import (check_balancer, check_binding,
                                         check_engine_backend)
from repro_torch.telemetry import engine as tel_engine
from repro_torch.telemetry import timeline_engine as tl_engine
from repro_torch.telemetry.sketch import N_BINS
from repro_torch.telemetry.state import (TelemetryCfg, TelemetryResult,
                                         warmup_cutoff)
from repro_torch.telemetry.timeline import (EV_AUTOSCALE, EV_MODE_FLIP,
                                            TimelineCfg, TimelineResult,
                                            validate_timeline)

from .cluster import ClusterCfg
from .taxonomy import PolicySpec, parse_policy
from .workload import Workload, WorkloadBatch, stack_workloads

EPS = 1e-9
_BIG_TIME = 1e18
_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64


@dataclasses.dataclass(frozen=True)
class SimOutput:
    response: np.ndarray
    cold: np.ndarray
    rejected: np.ndarray
    worker: np.ndarray
    server_time: float
    core_time: float
    end_time: float
    #: streaming in-engine metrics (None unless ``telemetry=`` was passed)
    telemetry: TelemetryResult | None = None
    #: provisioned core-seconds: the autoscaler's ``n_on × cores`` time
    #: integral, or ``end_time × total_cores`` for a fixed fleet
    prov_core_s: float = 0.0
    #: the windowed flight recorder (None unless ``timeline=`` was passed)
    timeline: TimelineResult | None = None
    #: the final lifecycle state (see :class:`BatchSimOutput`); None
    #: without a lifecycle
    life: dict | None = None
    #: the autoscaler's final state (see :class:`BatchSimOutput`); None
    #: without one
    fleet: dict | None = None


@dataclasses.dataclass(frozen=True)
class BatchSimOutput:
    """Results of ``R`` stacked workload replications (leading axis R)."""

    response: np.ndarray     # [R, N] f64
    cold: np.ndarray         # [R, N] bool
    rejected: np.ndarray     # [R, N] bool
    worker: np.ndarray       # [R, N] i32
    server_time: np.ndarray  # [R] f64
    core_time: np.ndarray    # [R] f64
    end_time: np.ndarray     # [R] f64
    #: batched streaming metrics, leading axis R (None unless enabled)
    telemetry: TelemetryResult | None = None
    prov_core_s: np.ndarray | None = None   # [R] f64
    #: the windowed flight recorder, leading axis R (None unless enabled)
    timeline: TimelineResult | None = None
    #: the final lifecycle state, ``None`` without a lifecycle:
    #: ``idle_since [R, W, F]``, ``pre``/``keep [R, F]`` f64 and the
    #: keep-alive's own state (``hist [R, F, 32]``, ``n_obs [R, F]`` for
    #: HYBRID_HIST), numpy
    life: dict | None = None
    #: the autoscaler's final state, ``None`` without one: ``n_on [R]``
    #: i32, ``cool_until``/``prov_time [R]`` f64, ``snap [R, N_BINS]``
    #: i64 (the slowdown sketch at the last decision), numpy
    fleet: dict | None = None

    @property
    def n_reps(self) -> int:
        return int(self.response.shape[0])

    def rep(self, r: int) -> SimOutput:
        """The ``r``-th replication as a plain :class:`SimOutput`."""
        return SimOutput(
            response=self.response[r], cold=self.cold[r],
            rejected=self.rejected[r], worker=self.worker[r],
            server_time=float(self.server_time[r]),
            core_time=float(self.core_time[r]),
            end_time=float(self.end_time[r]),
            telemetry=None if self.telemetry is None
            else self.telemetry.rep(r),
            prov_core_s=0.0 if self.prov_core_s is None
            else float(self.prov_core_s[r]),
            timeline=None if self.timeline is None
            else self.timeline.rep(r),
            life=None if self.life is None
            else {k: v[r] for k, v in self.life.items()},
            fleet=None if self.fleet is None
            else {k: v[r] for k, v in self.fleet.items()})

    def __getitem__(self, sl: slice) -> "BatchSimOutput":
        """A sub-batch over a slice of the replication axis."""
        return BatchSimOutput(
            response=self.response[sl], cold=self.cold[sl],
            rejected=self.rejected[sl], worker=self.worker[sl],
            server_time=self.server_time[sl], core_time=self.core_time[sl],
            end_time=self.end_time[sl],
            telemetry=None if self.telemetry is None
            else self.telemetry[sl],
            prov_core_s=None if self.prov_core_s is None
            else self.prov_core_s[sl],
            timeline=None if self.timeline is None
            else self.timeline[sl],
            life=None if self.life is None
            else {k: v[sl] for k, v in self.life.items()},
            fleet=None if self.fleet is None
            else {k: v[sl] for k, v in self.fleet.items()})


@dataclasses.dataclass
class LoopStats:
    """Host-side counts of one engine run (the caller creates and passes
    one; the engine adds to it)."""

    arrivals: int = 0
    #: completion-drain iterations: of the lockstep loop in the batched
    #: engine, summed over replications in the fused one
    advance_iters: int = 0
    pop_iters: int = 0         # late-binding dispatches from the queue
    host_syncs: int = 0        # device→host reads of a loop predicate


def _merge(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Per replication, ``new`` where ``mask [R]`` holds, else ``old``."""
    out = {}
    for k, v in new.items():
        o = old[k]
        if v is o:
            out[k] = v
        else:
            m = mask.view((-1,) + (1,) * (v.dim() - 1))
            out[k] = torch.where(m, v, o)
    return out


def _lb_of(st: dict) -> dict:
    """A carried-state balancer's state out of the engine's ``st``."""
    return {k[3:]: v for k, v in st.items() if k.startswith("lb_")}


def _with_lb(lb: dict) -> dict:
    """``lb``'s entries under their keys in the engine's ``st``."""
    return {f"lb_{k}": v for k, v in lb.items()}


#: the life plane's own entries of ``st`` (as ``life_<key>``); its other
#: ``life_`` entries are the keep-alive's state
LIFE_PLANES = ("idle_since", "pre", "keep")


def _ka_of(st: dict) -> dict:
    """The keep-alive's carried state out of the engine's ``st``."""
    return {k[5:]: v for k, v in st.items()
            if k.startswith("life_") and k[5:] not in LIFE_PLANES}


def _with_life(d: dict) -> dict:
    """``d``'s entries under their ``life_`` keys in the engine's ``st``."""
    return {f"life_{k}": v for k, v in d.items()}


def _tel_of(st: dict) -> dict:
    """The telemetry state out of the engine's ``st``."""
    return {k[4:]: v for k, v in st.items() if k.startswith("tel_")}


def _with_tel(tel: dict) -> dict:
    """``tel``'s entries under their ``tel_`` keys in the engine's ``st``."""
    return {f"tel_{k}": v for k, v in tel.items()}


def _tl_of(st: dict) -> dict:
    """The timeline state out of the engine's ``st``."""
    return {k[3:]: v for k, v in st.items() if k.startswith("tl_")}


def _with_tl(tl: dict) -> dict:
    """``tl``'s entries under their ``tl_`` keys in the engine's ``st``."""
    return {f"tl_{k}": v for k, v in tl.items()}


def _check_autoscale(policy, cluster: ClusterCfg,
                     telemetry: TelemetryCfg | None) -> None:
    """The reference's two named errors of an autoscaler
    (``repro/core/simulator.py:332-343``): under late binding, and one
    that reads the sketch without telemetry."""
    fl = cluster.fleet
    if fl is None or str(fl.autoscale).strip().upper() == STATIC:
        return
    pol = get_autoscaler(fl.autoscale)
    if isinstance(policy, str):
        policy = parse_policy(policy)
    if check_binding(policy.binding):
        raise ValueError(
            f"autoscaler {pol.name!r} requires early binding"
            f" — late binding has no per-worker placement to mask")
    if pol.needs_telemetry and telemetry is None:
        raise ValueError(
            f"autoscaler {pol.name!r} reads the telemetry slowdown sketch "
            f"as its sensor; pass telemetry=TelemetryCfg() to the "
            f"simulator")


def _check_stream(policy) -> None:
    """The reference's refusal of late binding in the stream engine
    (``repro/core/simulator.py:277-281``)."""
    if isinstance(policy, str):
        policy = parse_policy(policy)
    if check_binding(policy.binding):
        raise ValueError(
            f"streaming engine requires early binding — policy "
            f"{policy!r} uses late binding, whose controller queue "
            f"scales with the horizon; run it through simulate_many")


def _build_engine(policy: PolicySpec, cluster: ClusterCfg, n_arrivals: int,
                  n_functions: int, n_reps: int, device: torch.device,
                  backend: str, telemetry: TelemetryCfg | None = None,
                  timeline: TimelineCfg | None = None, stream: bool = False):
    """The batched engine for (policy, cluster, N, F, R) on ``device``.

    Returns ``run(arrivals, funcs, services, u_lb, homes, stats) -> state``
    over ``[R, N]`` / ``[R, F]`` tensors on ``device``.

    ``stream=True`` builds the chunk engine of
    :func:`repro_torch.core.streaming.simulate_stream` (``n_arrivals`` is
    not used: one engine serves any chunk and any horizon) and returns
    ``(init, run_chunk, drain)``:

    * ``init(cutoff, window_s)``: the fresh carry; ``cutoff`` is the
      horizon's warmup index, ``window_s [R]`` the timeline's widths (or
      None);
    * ``run_chunk(st, g0, arrivals, funcs, services, u_lb, homes, stats)
      -> (st, (rejected, cold, worker))``: the arrivals ``g0, g0 + 1, …``
      of a chunk (``[R, n]`` inputs, any ``n``), and their per-arrival
      outputs ``[R, n]``;
    * ``drain(st, stats)``: the monolithic run's end-of-horizon drain.

    The carry holds no plane of the horizon's length: completions read
    the occupant's function and nominal service from the slot mirrors
    ``task_fn``/``task_svc [R, W, S]`` written at placement, and the
    exact online counters ``stream_n_done``/``stream_n_obs`` (i64) and
    ``stream_resp_sum``/``stream_slow_sum`` (f64, in completion order)
    take the place of the response plane; ``stream_cutoff [R]`` is the
    warmup index.  Each arrival makes the operations the monolithic run
    makes at it, so any chunking gives the same bits.
    """
    if stream:
        _check_stream(policy)
    _check_autoscale(policy, cluster, telemetry)
    W, C, S = cluster.n_workers, cluster.cores, cluster.slots
    F, N, R = n_functions, n_arrivals, n_reps
    Q = N  # the late-binding controller queue can hold every arrival
    res = resolve(policy, cluster, device=device, backend=backend)
    late = res.late
    select = res.select
    stateful = res.stateful
    rows = torch.arange(R, device=device)
    arrival_ids = None if stream else torch.arange(N, device=device)
    pen = torch.tensor(float(cluster.cold_start_penalty), dtype=_F64,
                       device=device)
    no_pen = torch.zeros((), dtype=_F64, device=device)
    # the container lifecycle: every life-plane op below is gated on
    # life_on, so lifecycle=None makes exactly the operations it made
    # before the plane existed
    lres = resolve_lifecycle(cluster, F, device)
    life_on = lres is not None
    if life_on:
        life_costs = None if lres.cold_costs is None else torch.as_tensor(
            lres.cold_costs, dtype=_F64, device=device)
    # telemetry and the fleet: gated as the life plane is
    tel_on = telemetry is not None
    if tel_on:
        tel_edges = tel_engine.edges_for(device)
        # the stream's cutoff rides in the carry (N is not the horizon)
        tel_cutoff = None if stream else warmup_cutoff(N, telemetry)
    fres = resolve_fleet(cluster, backend="torch", device=device)
    fleet_on = fres is not None
    auto_on = fleet_on and fres.auto_on
    if fleet_on:
        speed = torch.as_tensor(fres.speeds, dtype=_F64, device=device)
    if auto_on:
        auto_decide = fres.decide
        auto_cool = float(fres.cfg.cooldown_s)
        worker_ids = torch.arange(W, dtype=_I32, device=device)
    # the windowed flight recorder: gated as the planes above
    tl_on = timeline is not None
    if tl_on:
        tl_edges = tel_engine.edges_for(device)
        tl_mids = tl_engine.midpoints_for(device)
        # Hermes' pack/spread mode flips (early binding only)
        flip_on = not late and check_balancer(res.spec.balance) == "H"
        n_fixed = torch.full((R,), float(W), dtype=_F64, device=device)

    def n_prov(st):
        """The provisioned workers: the autoscaler's n_on, else W."""
        return st["fleet_n_on"].to(_F64) if auto_on else n_fixed

    def tl_prov(st, t0, t1):
        """Provisioned core-seconds over ``[t0, t1]``, in ``t0``'s
        window."""
        return _with_tl(tl_engine.on_prov(
            _tl_of(st), t0, (t1 - t0) * n_prov(st) * float(C)))

    def any_(go: torch.Tensor, stats: LoopStats) -> bool:
        stats.host_syncs += 1
        return bool(go.any())

    def rates_of(st):
        if late:
            r = (st["task_idx"] >= 0).to(_F64)
        else:
            r = res.rates(st["task_idx"], st["remaining"])
        if fleet_on:
            # the worker's speed multiplies every rate: the work stays
            # nominal, fast workers drain it faster
            r = r * speed[:, None]
        return r

    def place(st, tid, w, f, svc_nom, t_arr, at=None):
        """Place arrival ``tid [R]`` (fn ``f``, nominal service
        ``svc_nom``, arrival ``t_arr``) on worker ``w [R]`` (valid); its
        outputs go to index ``at [R]`` of the per-arrival planes (``tid``
        by default; the chunk's own index in a stream)."""
        row = st["task_idx"][rows, w]                          # [R, S]
        active_w = (row >= 0).sum(dim=1)
        warm_row = st["warm"][rows, w]                         # [R, F+1]
        warm_cnt = warm_row[rows, f]
        life = {}
        if life_on:
            # only materialized pools serve a warm hit, take memory and
            # are eviction candidates; the victim is the LRU one (oldest
            # idle-since, first index on ties)
            lu_w = st["life_idle_since"][rows, w, :F]          # [R, F]
            pre, keep = st["life_pre"], st["life_keep"]
            ages_w = st["now"][:, None] - lu_w
            eff = torch.where((ages_w >= pre) & (ages_w <= pre + keep),
                              warm_row[:, :F], 0)
            is_cold = eff[rows, f] == 0
            idle = eff.sum(dim=1)
            victim = torch.where(eff > 0, lu_w, torch.inf).argmin(dim=1)
            pen_f = pen if life_costs is None else life_costs[f]
            if lres.observe is not None:
                # the placed pool's idle age, after the warm/cold
                # decision; a pool without a completion is no observation
                lu_f = lu_w[rows, f]
                ka = lres.observe(_ka_of(st), f,
                                  torch.clamp(st["now"] - lu_f, min=0.0),
                                  lu_f >= 0.0)
                pre2, keep2 = lres.windows(ka)
                life = _with_life(dict(ka, pre=pre2, keep=keep2))
        else:
            is_cold = warm_cnt == 0
            idle = warm_row[:, :F].sum(dim=1)
            victim = warm_row[:, :F].argmax(dim=1)
            pen_f = pen
        need_evict = is_cold & (active_w + idle >= S)
        tel = {} if not tel_on else _with_tel(tel_engine.on_place(
            _tel_of(st), rows, w, is_cold, need_evict))
        if tl_on:
            # in the window of the dispatch time
            tel.update(_with_tl(tl_engine.on_place(
                _tl_of(st), st["now"], is_cold, need_evict)))
        warm = st["warm"].index_put(
            (rows, w, f), warm_cnt - (~is_cold).to(_I32))
        warm = warm.index_put(
            (rows, w, victim), warm[rows, w, victim] - need_evict.to(_I32))
        slot = (row < 0).to(_I32).argmax(dim=1)
        svc = svc_nom + torch.where(is_cold, pen_f, no_pen)
        mirror = {}
        if stream:
            # the slot mirrors: a completion in a later chunk reads them
            mirror = dict(
                task_fn=st["task_fn"].index_put((rows, w, slot), f),
                task_svc=st["task_svc"].index_put((rows, w, slot), svc_nom))
        at = tid if at is None else at
        return dict(
            st, **life, **tel, **mirror,
            remaining=st["remaining"].index_put((rows, w, slot), svc),
            task_arr=st["task_arr"].index_put((rows, w, slot), t_arr),
            task_idx=st["task_idx"].index_put((rows, w, slot),
                                              tid.to(_I32)),
            warm=warm,
            cold=st["cold"].index_put((rows, at), is_cold),
            worker_of=st["worker_of"].index_put((rows, at), w.to(_I32)))

    def n_active(st):
        return (st["task_idx"] >= 0).sum(dim=2)                # [R, W] i64

    def pop_all(st, funcs, services, arrivals, stats):
        """Dispatch queued invocations while any worker has a free core."""
        def cond(st):
            return (st["q_tail"] > st["q_head"]) & \
                (n_active(st).amin(dim=1) < C)

        go = cond(st)
        while any_(go, stats):
            w = n_active(st).argmin(dim=1)
            arr = st["q"][rows, (st["q_head"] % Q).to(_I64)].to(_I64)
            new = place(st, arr, w, funcs[rows, arr], services[rows, arr],
                        arrivals[rows, arr])
            new["q_head"] = st["q_head"] + 1
            st = _merge(go, new, st)
            stats.pop_iters += 1
            go = cond(st)
        return st

    def advance(st, dt, funcs, services, arrivals, stats):
        """Fast-forward every replication by ``dt [R]`` seconds."""
        def cond(st, dt_left):
            active = st["task_idx"] >= 0
            pending = (active & (st["remaining"] <= EPS)).flatten(1).any(1)
            go = active.flatten(1).any(1) & ((dt_left > 0) | pending)
            if late:
                go = go | ((st["q_tail"] > st["q_head"])
                           & (active.sum(dim=2).amin(dim=1) < C))
            return go

        def body(st, dt_left):
            if late:
                st = pop_all(st, funcs, services, arrivals, stats)
            task_idx, remaining = st["task_idx"], st["remaining"]
            active = task_idx >= 0
            rates = rates_of(st)
            t_done = torch.where(rates > 0, remaining / rates, torch.inf)
            flat = t_done.view(R, W * S)
            tmin = flat.amin(dim=1)
            tau = torch.minimum(dt_left, tmin)
            tau = torch.where(torch.isfinite(tau) & (tau > 0), tau, 0.0)
            # occupancy integrals (constant over tau)
            n_w = active.sum(dim=2)
            server_time = st["server_time"] + tau * (n_w > 0).sum(dim=1)
            core_time = st["core_time"] + tau * n_w.clamp(max=C).sum(dim=1)
            if tel_on:
                # the same pre-advance occupancy, per worker
                tel = tel_engine.on_advance(_tel_of(st), tau, n_w > 0, n_w,
                                            st["q_tail"] - st["q_head"])
            if tl_on:
                # the same, windowed: the interval start's window
                tl = tl_engine.on_advance(_tl_of(st), st["now"], tau,
                                          n_w > 0,
                                          st["q_tail"] - st["q_head"])
            now = st["now"] + tau
            remaining = remaining - rates * tau[:, None, None]
            # complete the argmin slot only (idx N / col F are scratch)
            j = flat.argmin(dim=1)
            wj, sj = j // S, j % S
            tid = task_idx[rows, wj, sj]
            completed = (tmin <= dt_left) | \
                ((tid >= 0) & (st["remaining"][rows, wj, sj] <= EPS))
            resp_val = now - st["task_arr"][rows, wj, sj]
            if stream:
                # the slot's mirrors, not the (earlier chunk's) inputs
                f_j = st["task_fn"][rows, wj, sj]
                svc_nom = st["task_svc"][rows, wj, sj]
            else:
                f_j = funcs[rows, tid.clamp(min=0).to(_I64)]
                svc_nom = services[rows, tid.clamp(min=0).to(_I64)]
            if tel_on:
                tel = tel_engine.on_complete(
                    tel, rows, resp_val, svc_nom, tid, completed,
                    st["stream_cutoff"] if stream else tel_cutoff, tel_edges)
            if tl_on:
                # every completion, in the completion time's window
                tl = tl_engine.on_complete(tl, now, resp_val, svc_nom,
                                           completed, tl_edges)
            if stream:
                # the exact online counters over the post-warmup
                # completions, in completion order
                rec = completed & (tid >= st["stream_cutoff"])
                slow_v = resp_val / torch.clamp(svc_nom, min=1e-12)
                counters = dict(
                    stream_n_done=st["stream_n_done"] + completed.to(_I64),
                    stream_n_obs=st["stream_n_obs"] + rec.to(_I64),
                    stream_resp_sum=st["stream_resp_sum"]
                    + torch.where(rec, resp_val, 0.0),
                    stream_slow_sum=st["stream_slow_sum"]
                    + torch.where(rec, slow_v, 0.0))
            else:
                counters = dict(resp=st["resp"].index_put(
                    (rows, torch.where(completed, tid.to(_I64), N)),
                    torch.where(completed, resp_val, 0.0)))
            w_pad = torch.where(completed, wj, 0)
            f_pad = torch.where(completed, f_j, F)
            life = {}
            if life_on:
                # zero a stale pool before the increment, refresh its idle
                # clock, then hold the worker to its max_idle budget by
                # evicting its LRU materialized pool
                lu = st["life_idle_since"]
                pre, keep = st["life_pre"], st["life_keep"]
                stale = now - lu[rows, wj, f_j] > \
                    pre[rows, f_j] + keep[rows, f_j]
                base = torch.where(stale, 0, st["warm"][rows, wj, f_j])
                warm = st["warm"].index_put(
                    (rows, w_pad, f_pad),
                    torch.where(completed, base + 1,
                                st["warm"][rows, w_pad, f_pad]))
                lu = lu.index_put(
                    (rows, w_pad, f_pad),
                    torch.where(completed, now, lu[rows, w_pad, f_pad]))
                life = dict(life_idle_since=lu)
                if lres.max_idle > 0:
                    lu_row = lu[rows, wj, :F]
                    ages_row = now[:, None] - lu_row
                    eff = torch.where(
                        (ages_row >= pre) & (ages_row <= pre + keep),
                        warm[rows, wj, :F], 0)
                    over = completed & (eff.sum(dim=1) > lres.max_idle)
                    evict = torch.where(eff > 0, lu_row,
                                        torch.inf).argmin(dim=1)
                    w_ev = torch.where(over, wj, 0)
                    f_ev = torch.where(over, evict, F)
                    warm = warm.index_put(
                        (rows, w_ev, f_ev),
                        warm[rows, w_ev, f_ev] - over.to(_I32))
                    if tel_on:
                        tel = tel_engine.on_evict(tel, over)
                    if tl_on:
                        tl = tl_engine.on_evict(tl, now, over)
            else:
                warm = st["warm"].index_put(
                    (rows, w_pad, f_pad),
                    st["warm"][rows, w_pad, f_pad] + completed.to(_I32))
            warm[:, :, F] = 0
            remaining = remaining.index_put(
                (rows, wj, sj),
                torch.where(completed, torch.inf, remaining[rows, wj, sj]))
            task_idx = task_idx.index_put(
                (rows, wj, sj), torch.where(completed, -1, tid))
            new = dict(st, remaining=remaining, task_idx=task_idx,
                       warm=warm, now=now, server_time=server_time,
                       core_time=core_time, **counters, **life)
            if tel_on:
                new.update(_with_tel(tel))
            if tl_on:
                new.update(_with_tl(tl))
            if stateful:
                # one hook call per iteration, kept where the argmin slot
                # really completed; under a fleet it observes the time the
                # task took on its worker
                lb = _lb_of(st)
                svc_obs = svc_nom / speed[wj] if fleet_on else svc_nom
                upd = res.on_complete(lb, wj, f_j, svc_obs,
                                      (task_idx[rows, wj] >= 0).sum(dim=1))
                new.update(_with_lb(_merge(completed, upd, lb)))
            return new, dt_left - tau

        dt_left = dt
        go = cond(st, dt_left)
        while any_(go, stats):
            new, new_dt = body(st, dt_left)
            st = _merge(go, new, st)
            dt_left = torch.where(go, new_dt, dt_left)
            stats.advance_iters += 1
            go = cond(st, dt_left)
        if late:
            st = pop_all(st, funcs, services, arrivals, stats)
        return st

    def step(st, i, arrivals, funcs, services, u_lb, homes, stats,
             ids=None, g0=0, at=None):
        """Arrival ``i`` of the inputs; in a stream, ``ids`` are the
        chunk's global indices (``g0 + i``) and ``at [R]`` is ``i``, where
        its outputs go."""
        t_i, f_i = arrivals[:, i], funcs[:, i]
        tid = (arrival_ids if ids is None else ids)[i].expand(R)
        if auto_on:
            # provisioned time over [now, t_i] at the current n_on (a
            # decision takes effect at an arrival only)
            st = dict(st, fleet_prov_time=st["fleet_prov_time"]
                      + (t_i - st["now"]) * st["fleet_n_on"].to(_F64))
        if tl_on:
            st = dict(st, **tl_prov(st, st["now"], t_i))
        st = advance(st, t_i - st["now"], funcs, services, arrivals, stats)
        st = dict(st, now=t_i)
        active = n_active(st).to(_I32)
        if late:
            if tl_on:
                st.update(_with_tl(tl_engine.on_arrival(_tl_of(st), t_i, W)))
            placed = place(st, tid, active.argmin(dim=1), f_i,
                           services[:, i], t_i)
            queued = dict(
                st,
                q=st["q"].index_put((rows, (st["q_tail"] % Q).to(_I64)),
                                    tid.to(_I32)),
                q_tail=st["q_tail"] + 1)
            return _merge(active.amin(dim=1) < C, placed, queued)
        warm_col = st["warm"][rows, :, f_i]                    # [R, W]
        if life_on:
            # selection sees the materialized warm column only
            ages = st["now"][:, None] - st["life_idle_since"][rows, :, f_i]
            pre_f = st["life_pre"][rows, f_i][:, None]
            end_f = pre_f + st["life_keep"][rows, f_i][:, None]
            warm_col = torch.where((ages >= pre_f) & (ages <= end_f),
                                   warm_col, 0)
        sel_active = active
        if auto_on:
            # the decision: read the sketch's window since the last
            # snapshot, decide where the cooldown elapsed and the window
            # holds a completion, then snapshot and re-arm
            n_on, snap = st["fleet_n_on"], st["fleet_snap"]
            hist = st["tel_slow_hist"][:, :N_BINS] if tel_on else snap
            window = hist - snap
            do = (t_i >= st["fleet_cool_until"]) & (window.sum(dim=1) >= 1)
            n_new = auto_decide(n_on, window)
            if tl_on:
                # the decision, logged where it changed the level, with
                # the p99 the controller read off the same window
                st.update(_with_tl(tl_engine.on_event(
                    _tl_of(st), do & (n_new != n_on), t_i, EV_AUTOSCALE,
                    n_new, tl_engine.sensor_p99(window, tl_mids))))
            n_on = torch.where(do, n_new, n_on)
            st = dict(st, fleet_n_on=n_on,
                      fleet_cool_until=torch.where(
                          do, t_i + auto_cool, st["fleet_cool_until"]),
                      fleet_snap=torch.where(do[:, None], hist, snap))
            # workers past n_on read as slot-full at the choice; their
            # running tasks drain as before
            sel_active = torch.where(worker_ids < n_on[:, None], active, S)
        if tl_on:
            # the arrival and the level after the decision
            tl = tl_engine.on_arrival(_tl_of(st), t_i,
                                      st["fleet_n_on"] if auto_on else W)
            if flip_on:
                # Hermes packs while a worker it sees has a free core
                mode = (sel_active < C).any(dim=1).to(_I32)
                tl = tl_engine.on_event(tl, mode != tl["mode"], t_i,
                                        EV_MODE_FLIP, mode,
                                        torch.nan)
                tl["mode"] = mode
            st.update(_with_tl(tl))
        if stateful:
            w, lb = select(_lb_of(st), sel_active, warm_col, f_i, homes,
                           u_lb[:, i], g0 + i)
            st = dict(st, **_with_lb(lb))
        else:
            w = select(sel_active, warm_col, f_i, homes, u_lb[:, i], g0 + i)
        st = dict(st, rejected=st["rejected"].index_put(
            (rows, tid if at is None else at), w < 0))
        if tel_on:
            st.update(_with_tel(tel_engine.on_reject(_tel_of(st), w < 0)))
        if tl_on:
            st.update(_with_tl(tl_engine.on_reject(_tl_of(st), t_i, w < 0)))
        placed = place(st, tid, w.clamp(min=0).to(_I64), f_i,
                       services[:, i], t_i, at)
        return _merge(w >= 0, placed, st)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    def fresh(window_s):
        """The initial state (the per-arrival planes and the late-binding
        queue of the monolithic run, the mirrors and counters of a
        stream); ``window_s [R]``: the timeline's widths."""
        st = {
            "remaining": full((R, W, S), torch.inf, _F64),
            "task_arr": full((R, W, S), 0.0, _F64),
            "task_idx": full((R, W, S), -1, _I32),
            "warm": full((R, W, F + 1), 0, _I32),
            "q_head": full((R,), 0, _I32),
            "q_tail": full((R,), 0, _I32),
            "now": full((R,), 0.0, _F64),
            "server_time": full((R,), 0.0, _F64),
            "core_time": full((R,), 0.0, _F64),
        }
        if stream:
            st.update(task_fn=full((R, W, S), 0, _I64),
                      task_svc=full((R, W, S), 0.0, _F64),
                      stream_n_done=full((R,), 0, _I64),
                      stream_n_obs=full((R,), 0, _I64),
                      stream_resp_sum=full((R,), 0.0, _F64),
                      stream_slow_sum=full((R,), 0.0, _F64))
        else:
            st.update(q=full((R, Q), 0, _I32),
                      resp=full((R, N + 1), torch.nan, _F64),
                      cold=full((R, N + 1), False, torch.bool),
                      rejected=full((R, N + 1), False, torch.bool),
                      worker_of=full((R, N + 1), -1, _I32))
        if stateful:
            st.update(_with_lb(res.init_state(R, W, F, device)))
        if life_on:
            ka = lres.init_policy_state(R, W, F) or {}
            pre, keep = lres.windows(ka or None)
            st.update(_with_life(dict(
                ka, idle_since=full((R, W, F + 1), -1.0, _F64),
                pre=pre.to(_F64).expand(R, F).clone(),
                keep=keep.to(_F64).expand(R, F).clone())))
        if tel_on:
            st.update(_with_tel(tel_engine.init_state(R, W, device)))
        if auto_on:
            # fully provisioned at the start
            st.update(fleet_n_on=full((R,), W, _I32),
                      fleet_cool_until=full((R,), 0.0, _F64),
                      fleet_prov_time=full((R,), 0.0, _F64),
                      fleet_snap=full((R, N_BINS), 0, _I64))
        if tl_on:
            st.update(_with_tl(tl_engine.init_state(R, W, timeline, window_s,
                                                    device)))
        return st

    def drain(st, stats, funcs=None, services=None, arrivals=None):
        """The end-of-horizon drain and the provisioned tails."""
        t_last = st["now"]
        st = advance(st, full((R,), _BIG_TIME, _F64), funcs, services,
                     arrivals, stats)
        if auto_on:
            # the fleet stays provisioned until the last completion
            st["fleet_prov_time"] = st["fleet_prov_time"] + \
                (st["now"] - t_last) * st["fleet_n_on"].to(_F64)
        if tl_on:
            st.update(tl_prov(st, t_last, st["now"]))
        return st

    def run(arrivals, funcs, services, u_lb, homes, stats):
        """``stats`` counts the loops; the timeline's widths come from
        ``arrivals``."""
        st = fresh(tl_engine.widths(arrivals, timeline) if tl_on else None)
        for i in range(N):
            st = step(st, i, arrivals, funcs, services, u_lb, homes, stats)
            stats.arrivals += 1
        return drain(st, stats, funcs, services, arrivals)

    if not stream:
        return run

    def init(cutoff: int, window_s=None):
        """The fresh carry: ``cutoff`` the horizon's warmup index,
        ``window_s [R]`` f64 the timeline's widths (from the horizon)."""
        st = fresh(window_s)
        st["stream_cutoff"] = full((R,), int(cutoff), _I64)
        return st

    def run_chunk(st, g0, arrivals, funcs, services, u_lb, homes, stats):
        n = arrivals.shape[1]
        ids = torch.arange(g0, g0 + n, device=device)
        local = torch.arange(n, device=device)
        st = dict(st, rejected=full((R, n), False, torch.bool),
                  cold=full((R, n), False, torch.bool),
                  worker_of=full((R, n), -1, _I32))
        for i in range(n):
            st = step(st, i, arrivals, funcs, services, u_lb, homes, stats,
                      ids=ids, g0=g0, at=local[i].expand(R))
            stats.arrivals += 1
        ys = (st.pop("rejected"), st.pop("cold"), st.pop("worker_of"))
        return st, ys

    return init, run_chunk, drain


def _prov_core_s(st: dict, cluster: ClusterCfg) -> np.ndarray:
    """Provisioned core-seconds, ``∫ n_on(t)·cores dt`` (fig. 13's
    x-axis); without an autoscaler the whole fleet for the whole run,
    ``end_time × W × C``."""
    if "fleet_prov_time" in st:
        return st["fleet_prov_time"].cpu().numpy() * cluster.cores
    return st["now"].cpu().numpy() * cluster.n_workers * cluster.cores


def simulate_many(policy: PolicySpec, cluster: ClusterCfg, workloads, *,
                  device=None, backend: str = "auto",
                  telemetry: TelemetryCfg | None = None,
                  timeline: TimelineCfg | None = None,
                  stats: LoopStats | None = None) -> BatchSimOutput:
    """Run ``R`` stacked replications in lockstep on ``device``.

    ``workloads`` is a :class:`WorkloadBatch` or a sequence of
    :class:`Workload` sharing one ``(N, F)`` shape.  ``device=None`` is
    CUDA (raises :class:`~repro_torch.device.NoCudaDeviceError` without
    a card).  ``backend`` is ``"auto"`` or ``"kernel"`` (on the card,
    the fused ``sim_engine`` kernel for every E/<B>/PS policy and the
    ``hermes_select`` kernel for the other ``H`` policies) or ``"torch"``
    (the batched engine in plain tensor code throughout).  With
    ``telemetry`` the output carries a :class:`TelemetryResult` and with
    ``timeline`` (a :class:`TimelineCfg`) a :class:`TimelineResult`, both
    with the leading ``R`` axis (their readers pool over it).
    ``backend="np"`` is refused by name: the numpy backend is the
    oracle's, :func:`repro_torch.core.sim_ref.simulate_ref`.
    """
    check_engine_backend(backend)
    if timeline is not None:
        validate_timeline(timeline)
    dev = resolve_device(device)
    cluster.validate()
    _check_autoscale(policy, cluster, telemetry)
    wb = workloads if isinstance(workloads, WorkloadBatch) \
        else stack_workloads(workloads)
    stats = LoopStats() if stats is None else stats

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    if engine(policy, dev, backend, cluster) == "sim_engine":
        if isinstance(policy, str):
            policy = parse_policy(policy)
        st = sim_engine_ops.sim_engine(
            check_balancer(policy.balance), cluster, put(wb.arrival, _F64),
            put(wb.func, _I32), put(wb.service, _F64), put(wb.u_lb, _F64),
            put(wb.func_home, _I32), telemetry=telemetry, timeline=timeline)
        stats.arrivals += wb.n
        stats.advance_iters += int(st["iters"].sum())
    else:
        run = _build_engine(policy, cluster, wb.n, wb.n_functions,
                            wb.n_reps, dev, backend, telemetry, timeline)
        st = run(put(wb.arrival, _F64), put(wb.func, _I64),
                 put(wb.service, _F64), put(wb.u_lb, _F64),
                 put(wb.func_home, _I32), stats)
    n = wb.n
    end = st["now"].cpu().numpy()
    life = None
    if cluster.lifecycle is not None:
        life = {k[5:]: v.cpu().numpy() for k, v in st.items()
                if k.startswith("life_")}
        life["idle_since"] = life["idle_since"][:, :, :wb.n_functions]
    fleet = {k[6:]: v.cpu().numpy() for k, v in st.items()
             if k.startswith("fleet_")} or None
    tl = None
    if timeline is not None:
        # the batched engine's planes carry their spare rows, the fused
        # engine's do not
        tl = _tl_of(st)
        tl = tl_engine.result_of(tl, timeline) \
            if tl["n_on"].shape[1] > timeline.n_windows \
            else TimelineResult.from_state(tl, cfg=timeline)
    return BatchSimOutput(
        response=st["resp"][:, :n].cpu().numpy(),
        cold=st["cold"][:, :n].cpu().numpy(),
        rejected=st["rejected"][:, :n].cpu().numpy(),
        worker=st["worker_of"][:, :n].cpu().numpy(),
        server_time=st["server_time"].cpu().numpy(),
        core_time=st["core_time"].cpu().numpy(),
        end_time=end,
        telemetry=None if telemetry is None else tel_engine.result_of(
            _tel_of(st), telemetry),
        prov_core_s=_prov_core_s(st, cluster), timeline=tl, life=life,
        fleet=fleet)


def simulate(policy: PolicySpec, cluster: ClusterCfg, wl: Workload, *,
             device=None, backend: str = "auto",
             telemetry: TelemetryCfg | None = None,
             timeline: TimelineCfg | None = None,
             stats: LoopStats | None = None) -> SimOutput:
    """Run one workload: :func:`simulate_many` with ``R = 1``."""
    return simulate_many(policy, cluster, [wl], device=device,
                         backend=backend, telemetry=telemetry,
                         timeline=timeline, stats=stats).rep(0)
