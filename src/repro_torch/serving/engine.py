"""Serving platform: a controller and workers with Hermes as the
dispatcher (counterpart of ``repro/serving/engine.py``).

The paper's §5 OpenWhisk implementation, as an event-driven platform:
"functions" are registered entry points, a warm executor is a
worker-resident one, a cold start pays the spin-up cost, and each worker
timeshares its cores across its active invocations (processor sharing,
the CFS analogue; FCFS and SRPT too).  On top of the paper's design it
re-dispatches stragglers: invocations stuck on a degraded worker past a
deadline move to the least loaded healthy one.

The virtual-time event loop is host Python over numpy, as in the
reference: the redispatch of stragglers, the health mask, the controller
latency, the container lifecycle (:class:`LifecycleRuntime`), the fleet's
speeds and its ``TARGET_P99`` control loop, telemetry, the timeline and
the tracer's events.  Each task's rate comes from the policy table's
numpy schedulers (:func:`repro_torch.policy.np_rates`, the reference's
``np`` backend), so responses are the reference's bit for bit.

The dispatch decision runs on ``device`` through
:func:`repro_torch.policy.resolve` (``backend="auto"``): on the card,
``H`` launches the ``hermes_select`` kernel once per arrival (one
function id, ``N = 1``: each choice depends on the placement before it
and on the completions advanced between two arrivals, so arrivals cannot
share a launch), and the other balancers run their torch ``select`` at
``R = 1`` there; a carried-state balancer keeps its state on the device
and takes each completion through ``on_complete``.  On the CPU the plain
versions run.  ``use_kernel=True`` sends each dispatch through the
kernel's ``(active, warm [W, F], funcs)`` gather API on the materialized
warm matrix, and refuses a balancer that has no kernel.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.cluster import ClusterCfg
from repro_torch.core.taxonomy import HERMES, PolicySpec, parse_policy
from repro_torch.core.workload import Workload
from repro_torch.device import resolve_device
from repro_torch.fleet import resolve_fleet
from repro_torch.kernels.hermes_select import ops as hermes_ops
from repro_torch.lifecycle import LifecycleRuntime, resolve_lifecycle
from repro_torch.policy import np_rates, resolve
from repro_torch.policy.registry import BALANCERS, check_balancer
from repro_torch.telemetry.sketch import N_BINS
from repro_torch.telemetry.spans import get_tracer
from repro_torch.telemetry.state import (TelemetryCfg, TelemetryResult,
                                         init_np, on_advance_np,
                                         on_complete_np, on_evict_np,
                                         on_place_np, on_reject_np,
                                         warmup_cutoff)
from repro_torch.telemetry.timeline import (EV_AUTOSCALE, EV_MODE_FLIP,
                                            TimelineCfg, TimelineResult,
                                            auto_window_s, init_tl_np,
                                            sensor_p99_np, tl_event_np,
                                            tl_on_advance_np,
                                            tl_on_arrival_np,
                                            tl_on_complete_np,
                                            tl_on_evict_np, tl_on_place_np,
                                            tl_on_prov_np, tl_on_reject_np,
                                            validate_timeline)

EPS = 1e-9
_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64


@dataclasses.dataclass(frozen=True)
class ServeCfg:
    """Platform config.  ``cluster.lifecycle`` (if set) threads the
    container lifecycle (:mod:`repro_torch.lifecycle`) through the
    platform: keep-alive windows gate warm hits, the ``max_idle`` budget
    evicts idle executors (LRU), and a cold-start preset replaces the
    scalar ``cold_start_s`` (the fallback of the ``"scalar"`` preset)."""

    cluster: ClusterCfg = ClusterCfg(n_workers=8, cores=12)
    cold_start_s: float = 0.5          # executor spin-up
    ctrl_latency_s: float = 0.0005     # controller decision latency (§6.6)
    # straggler mitigation: re-dispatch when a task on a degraded worker
    # has completed < frac of its work after deadline_s of residence
    redispatch_deadline_s: float | None = None
    redispatch_frac: float = 0.1
    # failure detector: degraded workers (speed < health_threshold) are
    # masked out of dispatch while healthy capacity exists
    health_aware: bool = False
    health_threshold: float = 0.5
    detect_after_s: float = 0.0     # failure-detector latency
    # worker speed factors (1.0 = healthy); index -> factor.  Empty with
    # ``cluster.fleet`` set: the fleet's speed vector; explicit speeds
    # always win (a straggler experiment overrides one worker)
    speeds: tuple = ()

    def speed(self, w: int) -> float:
        return self.speeds[w] if w < len(self.speeds) else 1.0


@dataclasses.dataclass
class _Task:
    arr_idx: int
    func: int
    arrival: float
    placed_at: float
    work: float               # total work (incl. cold start)
    remaining: float
    seq: int
    rate: float = 0.0
    migrations: int = 0


@dataclasses.dataclass(frozen=True)
class ServeResult:
    response: np.ndarray      # [N] seconds (NaN = rejected)
    cold: np.ndarray          # [N] bool
    rejected: np.ndarray      # [N] bool
    worker: np.ndarray        # [N] final worker
    redispatched: np.ndarray  # [N] bool
    server_time: float
    core_time: float
    end_time: float
    n_cold: int
    n_redispatch: int
    #: streaming metrics (None unless the cluster was built with a
    #: TelemetryCfg), the simulators' layout
    telemetry: TelemetryResult | None = None
    #: provisioned core-seconds: the autoscaler's ``n_on × cores`` time
    #: integral, or ``end_time × total_cores`` for a fixed fleet
    prov_core_s: float = 0.0
    #: windowed flight recorder (None unless the cluster was built with a
    #: TimelineCfg), the simulators' layout
    timeline: TimelineResult | None = None


class ServingCluster:
    """Event-driven serving cluster under a scheduling policy; its
    dispatch decisions run on ``device`` (``None``: the card)."""

    def __init__(self, cfg: ServeCfg, policy: PolicySpec = HERMES,
                 use_kernel: bool = False,
                 telemetry: TelemetryCfg | None = None,
                 timeline: TimelineCfg | None = None, device=None):
        if isinstance(policy, str):
            policy = parse_policy(policy)
        self.cfg = cfg
        self.policy = policy
        self.use_kernel = use_kernel
        self.telemetry = telemetry
        self.timeline = validate_timeline(timeline) \
            if timeline is not None else None
        self.device = resolve_device(device)
        self._res = resolve(policy, cfg.cluster, device=self.device,
                            backend="auto")
        self._rates = np_rates(policy.sched, cfg.cluster.cores)
        if use_kernel and (self._res.late or BALANCERS[check_balancer(
                policy.balance)][1] is None):
            raise ValueError(
                f"policy {policy.name} has no batched kernel dispatch "
                f"(balancer lacks a make_batch backend)")

    # ------------------------------------------------------------------
    def run(self, wl: Workload) -> ServeResult:
        cfg = self.cfg
        cl = cfg.cluster
        W, C, S = cl.n_workers, cl.cores, cl.slots
        F = wl.n_functions
        N = wl.n
        res = self._res
        late = res.late
        dev = self.device

        tasks: list[list[_Task]] = [[] for _ in range(W)]
        warm = np.zeros((W, F), dtype=np.int64)
        queue: list[int] = []
        # the dispatch's inputs on the device: one replication
        homes = torch.as_tensor(np.asarray(wl.func_home)[None],
                                dtype=_I32, device=dev)
        lb_state = res.init_state(1, W, F, dev) \
            if (res.stateful and not late) else None
        # container lifecycle: the host-side state machine
        lres = resolve_lifecycle(cl, F, dev)
        life = LifecycleRuntime(lres, W, F) if lres is not None else None
        # streaming telemetry and virtual-time task events
        tel = init_np(W) if self.telemetry is not None else None
        tel_cutoff = warmup_cutoff(N, self.telemetry) \
            if self.telemetry is not None else 0
        # the windowed flight recorder, with the platform's own event
        # semantics (responses include the controller latency, migrations
        # count evictions only)
        tl = None
        if self.timeline is not None:
            tl = init_tl_np(W, self.timeline,
                            auto_window_s(float(wl.arrival[-1]),
                                          self.timeline))
        flip_on = tl is not None and not late \
            and check_balancer(self.policy.balance) == "H"
        tracer = get_tracer()
        # heterogeneous fleet: with ServeCfg.speeds empty, the fleet's
        # speeds scale the rates; a non-STATIC autoscaler adds the
        # simulators' arrival-boundary control loop
        fres = resolve_fleet(cl, backend="np")
        fleet_on = fres is not None
        if fleet_on and not cfg.speeds:
            fl_speeds = np.asarray(fres.speeds)

            def speed(w: int) -> float:
                return float(fl_speeds[w])
        else:
            speed = cfg.speed
        auto_on = fleet_on and fres.auto_on
        if auto_on:
            if late:
                raise ValueError(
                    f"autoscaler {fres.policy.name!r} requires early "
                    f"binding — late binding has no per-worker placement "
                    f"to mask")
            if fres.policy.needs_telemetry and tel is None:
                raise ValueError(
                    f"autoscaler {fres.policy.name!r} reads the telemetry "
                    f"slowdown sketch as its sensor; pass telemetry="
                    f"TelemetryCfg() to the platform")
            auto_decide = fres.decide
            auto_cool = float(fres.cfg.cooldown_s)
            n_on = W
            cool_until = 0.0
            prov_time = 0.0
            snap = np.zeros(N_BINS, dtype=np.int64)
        response = np.full(N, np.nan)
        cold = np.zeros(N, dtype=bool)
        rejected = np.zeros(N, dtype=bool)
        redisp = np.zeros(N, dtype=bool)
        worker_of = np.full(N, -1, dtype=np.int32)
        server_time = core_time = 0.0
        now = 0.0

        def set_rates(w: int) -> None:
            ts = tasks[w]
            if not ts:
                return
            spd = speed(w)
            if late:
                for t in ts:
                    t.rate = spd
                return
            # the scheduler's rates, scaled by the worker's speed
            rs = self._rates([t.remaining for t in ts],
                             [t.seq for t in ts])
            for t, r in zip(ts, rs):
                t.rate = r * spd

        def place(w: int, arr_idx: int, work: float | None = None,
                  migration: bool = False) -> None:
            f = int(wl.func[arr_idx])
            avail = int(warm[w, f]) if life is None \
                else life.materialized_at(w, f, warm[w, f], now)
            evicted = False
            if avail > 0 and work is None:
                warm[w, f] -= 1
                is_cold = False
            else:
                is_cold = True
                idle = int(warm[w].sum()) if life is None \
                    else int(life.eff_row(warm[w], w, now).sum())
                if len(tasks[w]) + idle >= S:
                    victim = int(np.argmax(warm[w])) if life is None \
                        else life.evict_victim(warm[w], w, now)
                    warm[w, victim] -= 1
                    evicted = True
            if tel is not None:
                if not migration:
                    on_place_np(tel, w, is_cold, evicted)
                elif evicted:
                    # a migration's slot-pressure eviction is real, its
                    # placement is not a decision
                    on_evict_np(tel)
            if tl is not None:
                if not migration:
                    tl_on_place_np(tl, now, is_cold, evicted)
                elif evicted:
                    tl_on_evict_np(tl, now)
            cold_s = cfg.cold_start_s if life is None \
                else life.cold_cost(f, cfg.cold_start_s)
            if life is not None:
                # an adaptive keep-alive observes the placed pool's idle
                # age after the warm/cold decision
                life.observe_place(w, f, now)
            if not migration:
                cold[arr_idx] = is_cold
            worker_of[arr_idx] = w
            if work is None:
                work = float(wl.service[arr_idx]) + \
                    (cold_s if is_cold else 0.0)
            elif is_cold:
                work += cold_s
            tasks[w].append(_Task(
                arr_idx=arr_idx, func=f, arrival=float(wl.arrival[arr_idx]),
                placed_at=now, work=work, remaining=work, seq=arr_idx))

        def pop_queue() -> None:
            while queue:
                loads = [len(tasks[w]) for w in range(W)]
                w = int(np.argmin(loads))
                if loads[w] >= C:
                    break
                place(w, queue.pop(0))

        def maybe_redispatch() -> None:
            # migrations place without the balancer, so a carried-state
            # balancer's accounting is approximate under re-dispatch (as
            # in the reference)
            if cfg.redispatch_deadline_s is None:
                return
            active = np.array([len(tasks[w]) for w in range(W)])
            for w in range(W):
                if speed(w) >= 1.0:
                    continue
                for t in list(tasks[w]):
                    resident = now - t.placed_at
                    done_frac = 1.0 - t.remaining / max(t.work, EPS)
                    if resident >= cfg.redispatch_deadline_s and \
                            done_frac < cfg.redispatch_frac:
                        key = np.array([active[x] / speed(x)
                                        if x != w else np.inf
                                        for x in range(W)])
                        tgt = int(np.argmin(key))
                        if active[tgt] >= S:
                            continue
                        tasks[w].remove(t)
                        active[w] -= 1
                        redisp[t.arr_idx] = True
                        place(tgt, t.arr_idx, work=t.remaining,
                              migration=True)
                        active[tgt] += 1

        def lb_complete(w: int, f: int, svc: float, n_alive: int) -> None:
            """The carried-state balancer's update for one completion."""
            nonlocal lb_state
            lb_state = res.on_complete(
                lb_state, torch.tensor([w], dtype=_I64, device=dev),
                torch.tensor([f], dtype=_I64, device=dev),
                torch.tensor([svc], dtype=_F64, device=dev),
                torch.tensor([n_alive], dtype=_I64, device=dev))

        def advance(dt: float) -> None:
            nonlocal now, server_time, core_time
            dt_left = dt
            while True:
                if late:
                    pop_queue()
                if not any(tasks[w] for w in range(W)):
                    break
                for w in range(W):
                    set_rates(w)
                tau = dt_left
                for w in range(W):
                    for t in tasks[w]:
                        if t.rate > 0:
                            tau = min(tau, t.remaining / t.rate)
                if tau <= 0 and dt_left <= 0:
                    break
                tau = max(tau, 0.0)
                server_time += tau * sum(1 for w in range(W) if tasks[w])
                core_time += tau * sum(min(len(tasks[w]), C)
                                       for w in range(W))
                if tel is not None:
                    on_advance_np(
                        tel, tau,
                        np.array([bool(tasks[w]) for w in range(W)]),
                        np.array([len(tasks[w]) for w in range(W)]),
                        len(queue))
                if tl is not None:
                    tl_on_advance_np(
                        tl, now, tau,
                        np.array([bool(tasks[w]) for w in range(W)]),
                        len(queue))
                now += tau
                dt_left -= tau
                for w in range(W):
                    survivors = []
                    n_alive = len(tasks[w])
                    for t in tasks[w]:
                        t.remaining -= t.rate * tau
                        if t.remaining <= EPS:
                            response[t.arr_idx] = now - t.arrival + \
                                self.cfg.ctrl_latency_s
                            if tel is not None:
                                on_complete_np(
                                    tel, response[t.arr_idx],
                                    float(wl.service[t.arr_idx]),
                                    t.arr_idx, tel_cutoff)
                            if tl is not None:
                                tl_on_complete_np(
                                    tl, now, response[t.arr_idx],
                                    float(wl.service[t.arr_idx]))
                            if tracer.enabled:
                                # one virtual-time event per task, arrival
                                # to completion on its worker's track
                                tracer.event_at(
                                    f"f{t.func}", t.arrival,
                                    response[t.arr_idx], tid=w,
                                    task=t.arr_idx,
                                    cold=bool(cold[t.arr_idx]),
                                    migrations=t.migrations)
                            if life is None:
                                warm[w, t.func] += 1
                            else:
                                budget_evicted = life.on_complete(
                                    warm, w, t.func, now)
                                if budget_evicted:
                                    if tel is not None:
                                        on_evict_np(tel)
                                    if tl is not None:
                                        tl_on_evict_np(tl, now)
                            n_alive -= 1
                            if lb_state is not None:
                                # the observed (speed-scaled) duration
                                # under a heterogeneous fleet
                                svc_obs = wl.service[t.arr_idx] / speed(w) \
                                    if fleet_on else wl.service[t.arr_idx]
                                lb_complete(w, t.func, float(svc_obs),
                                            n_alive)
                        else:
                            survivors.append(t)
                    tasks[w] = survivors
                maybe_redispatch()
                if dt_left <= 0:
                    break

        def dispatch(i: int, active: np.ndarray, f: int,
                     wcol: np.ndarray) -> int:
            """The balancer's worker for arrival ``i`` on the device (-1:
            every worker is slot-full)."""
            nonlocal lb_state
            act = torch.as_tensor(active[None], dtype=_I32, device=dev)
            if self.use_kernel:
                kwarm = warm if life is None \
                    else life.materialized_all(warm, now)
                ws, _ = hermes_ops.hermes_select(
                    act[0], kwarm, [f], cores=C, slots=S, device=dev)
                return int(ws[0])
            args = (act, torch.as_tensor(wcol[None], dtype=_I32,
                                         device=dev),
                    torch.tensor([f], dtype=_I64, device=dev), homes,
                    torch.tensor([float(wl.u_lb[i])], dtype=_F64,
                                 device=dev), i)
            if lb_state is not None:
                w, lb_state = res.select(lb_state, *args)
            else:
                w = res.select(*args)
            return int(w[0])

        # the failure detector reads the straggler speeds (explicit
        # ServeCfg.speeds) only: a fleet's slow generation stays
        # schedulable (the simulators have no health mask either)
        unhealthy = np.array([cfg.speed(w) < cfg.health_threshold
                              for w in range(W)]) if cfg.health_aware \
            else np.zeros(W, dtype=bool)

        for i in range(N):
            t_i = float(wl.arrival[i])
            if auto_on:
                # provisioned time over [now, t_i] at the current n_on
                prov_time += (t_i - now) * float(n_on)
            if tl is not None:
                n_prov = float(n_on) if auto_on else float(W)
                tl_on_prov_np(tl, now, (t_i - now) * n_prov * float(C))
            advance(t_i - now)
            now = t_i
            active = np.array([len(tasks[w]) for w in range(W)])
            if cfg.health_aware and unhealthy.any() and \
                    now >= cfg.detect_after_s:
                healthy_free = (~unhealthy) & (active < S)
                if healthy_free.any():      # mask stragglers out
                    active = np.where(unhealthy, S, active)
            if auto_on:
                # the decision on the sketch's window (the simulators'
                # gate), then workers past n_on read as slot-full
                window = tel["slow_hist"] - snap
                if t_i >= cool_until and int(window.sum()) >= 1:
                    n_new = int(auto_decide(n_on, window))
                    if tl is not None and n_new != n_on:
                        tl_event_np(tl, t_i, EV_AUTOSCALE, n_new,
                                    sensor_p99_np(window))
                    n_on = n_new
                    cool_until = t_i + auto_cool
                    snap = tel["slow_hist"].copy()
                active = np.where(np.arange(W) < n_on, active, S)
            if tl is not None:
                tl_on_arrival_np(tl, t_i, n_on if auto_on else W)
                if flip_on:
                    new_mode = int(bool((active < C).any()))
                    if new_mode != int(tl["mode"]):
                        tl_event_np(tl, t_i, EV_MODE_FLIP, new_mode,
                                    float("nan"))
                    tl["mode"] = np.int32(new_mode)
            if late:
                if active.min() < C:
                    place(int(np.argmin(active)), i)
                else:
                    queue.append(i)
                continue
            f = int(wl.func[i])
            wcol = warm[:, f] if life is None \
                else life.materialized_col(warm[:, f], f, now)
            w = dispatch(i, active, f, wcol)
            if w < 0:
                rejected[i] = True
                if tel is not None:
                    on_reject_np(tel)
                if tl is not None:
                    tl_on_reject_np(tl, t_i)
            else:
                place(w, i)

        t_last = now
        advance(math.inf)
        if auto_on:
            # the drain: provisioned until the last completion
            prov_time += (now - t_last) * float(n_on)
            prov_core_s = prov_time * C
        else:
            prov_core_s = now * W * C
        if tl is not None:
            n_prov = float(n_on) if auto_on else float(W)
            tl_on_prov_np(tl, t_last, (now - t_last) * n_prov * float(C))
        return ServeResult(
            response=response, cold=cold, rejected=rejected,
            worker=worker_of, redispatched=redisp,
            server_time=server_time, core_time=core_time, end_time=now,
            n_cold=int(cold[~rejected].sum()),
            n_redispatch=int(redisp.sum()),
            telemetry=None if tel is None else TelemetryResult.from_state(
                tel, cfg=self.telemetry),
            prov_core_s=prov_core_s,
            timeline=None if tl is None else TimelineResult.from_state(
                tl, cfg=self.timeline))
