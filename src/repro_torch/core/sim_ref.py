"""The numpy oracle: a plain discrete-event loop on the host
(counterpart of ``repro/core/sim_ref.py``).

The semantic contract every engine of the port reproduces task by task:
the batched engine (:mod:`repro_torch.core.simulator`), the fused
``sim_engine`` kernel and its plain version, ``simulate_stream`` and the
serving platform.  It is numpy throughout, one replication at a time, and
takes no device: it resolves the policy, the lifecycle and the fleet
with their ``np`` backends (:func:`repro_torch.policy.resolve`,
:func:`repro_torch.lifecycle.resolve_lifecycle`,
:func:`repro_torch.fleet.resolve_fleet`) and feeds the telemetry and
timeline numpy hooks.  It makes the reference oracle's operations in its
order, so its results equal the reference's bit for bit.  The contract:

* Arrivals are processed in order; between consecutive arrivals the
  cluster is advanced through every completion event (piecewise-constant
  rates).
* Worker rates per active task, in cores: PS ``min(1, C/n)``; FCFS the
  ``C`` earliest arrivals at 1; SRPT the ``C`` tasks with least remaining
  work at 1 (ties by arrival sequence); late binding holds at most ``C``
  tasks a worker, all at rate 1, the rest queue FIFO at the controller.
* Selection is deterministic given the pre-drawn uniform ``u_lb``, the
  function-home table and the arrival index; a carried-state balancer's
  state is threaded through selection and updated once per completion,
  counting down the worker's remaining tasks in worker-index order.
* Each completion leaves one idle warm executor for its function on its
  worker; a placement takes a matching one (warm) or is cold, and evicts
  an idle executor when busy plus idle fill the worker's slots (the
  function with the most idle executors, or the LRU pool under a
  lifecycle; the first index on ties).  Late binding checks warmth at
  dispatch.
* Under ``cluster.lifecycle`` the keep-alive windows mask pools, cold
  starts cost the preset's per-function cost and the ``max_idle`` budget
  LRU-evicts at completions (:class:`repro_torch.lifecycle.
  LifecycleRuntime`).
* Under ``cluster.fleet`` rates scale by the worker's speed, carried-state
  balancers observe effective execution times, and a non-``STATIC``
  autoscaler decides at arrival boundaries from the telemetry
  slowdown-sketch window under a cooldown, deprovisioned workers masked
  slot-full at selection.
* After the last arrival the cluster drains to empty; only rejected
  invocations have a NaN response.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np

from repro_torch.fleet import resolve_fleet
from repro_torch.lifecycle import LifecycleRuntime, resolve_lifecycle
from repro_torch.policy import resolve
from repro_torch.policy.registry import check_balancer
from repro_torch.telemetry.sketch import N_BINS
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

from .cluster import ClusterCfg
from .taxonomy import PolicySpec, parse_policy
from .workload import Workload

EPS = 1e-9


@dataclasses.dataclass
class _Task:
    arr_idx: int
    func: int
    arrival: float
    remaining: float
    seq: int
    rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class SimResult:
    response: np.ndarray    # (N,) float64 seconds; NaN if rejected
    cold: np.ndarray        # (N,) bool — placement caused a cold start
    rejected: np.ndarray    # (N,) bool
    worker: np.ndarray      # (N,) int32; -1 if rejected
    server_time: float      # ∫ #workers-with-≥1-active dt
    core_time: float        # ∫ Σ_w min(n_w, C) dt
    end_time: float
    #: streaming metrics (None unless ``telemetry=`` was passed); the
    #: oracle twin of the engines' carry — integer planes bitwise, float
    #: integrals to float64 accumulation order
    telemetry: TelemetryResult | None = None
    #: provisioned core-seconds: the autoscaler's ``n_on × cores`` time
    #: integral, or ``end_time × total_cores`` for a fixed fleet
    prov_core_s: float = 0.0
    #: windowed flight recorder (None unless ``timeline=`` was passed);
    #: the oracle twin of the engines' ``tl`` carry — integer planes
    #: bitwise, float integrals to accumulation order
    timeline: TimelineResult | None = None


def simulate_ref(policy: PolicySpec, cluster: ClusterCfg, wl: Workload,
                 *, telemetry: TelemetryCfg | None = None,
                 timeline: TimelineCfg | None = None,
                 chunk_size: int | None = None,
                 chunk_hook=None) -> SimResult:
    """Pure-numpy oracle event loop (the semantic contract).

    ``chunk_size``/``chunk_hook`` replay the streaming engine's segment
    boundaries: after every ``chunk_size``-th arrival has been
    processed (advance + placement, before the next arrival), the hook
    is called as ``chunk_hook(chunk_idx, tel_snapshot, now)`` with a
    deep copy of the telemetry plane — the per-segment parity probe
    for :func:`repro_torch.core.streaming.simulate_stream`.
    """
    if isinstance(policy, str):
        policy = parse_policy(policy)
    W, C, S = cluster.n_workers, cluster.cores, cluster.slots
    F = wl.n_functions
    N = wl.n

    tasks: list[list[_Task]] = [[] for _ in range(W)]
    warm = np.zeros((W, F), dtype=np.int64)
    queue: list[int] = []  # arrival indices (late binding only)

    response = np.full(N, np.nan)
    cold = np.zeros(N, dtype=bool)
    rejected = np.zeros(N, dtype=bool)
    worker_of = np.full(N, -1, dtype=np.int32)

    server_time = 0.0
    core_time = 0.0
    now = 0.0
    # numpy-backend resolution: select/rates are the oracle callables of
    # the registered balancer/scheduler (None for late binding)
    res = resolve(policy, cluster, backend="np")
    late = res.late
    # carried-state balancers thread a state dict through selection and
    # receive a hook per completion (repro_torch.policy.registry's
    # contract)
    lb_state = res.init_state(W, F) if (res.stateful and not late) else None
    # container lifecycle (None = legacy infinite keep-alive, bit-exact)
    lres = resolve_lifecycle(cluster, F, backend="np")
    life = LifecycleRuntime(lres, W, F) if lres is not None else None
    # streaming telemetry — updated at the same event boundaries as the
    # batched engine's carry (place / advance / complete / reject)
    tel = init_np(W) if telemetry is not None else None
    tel_cutoff = warmup_cutoff(N, telemetry) if telemetry is not None else 0
    # windowed flight recorder — hooks fire at the same event boundaries
    # (and in the same order) as the batched engine's tl carry
    tl = None
    if timeline is not None:
        validate_timeline(timeline)
        tl = init_tl_np(W, timeline,
                        auto_window_s(float(wl.arrival[-1]), timeline))
    flip_on = tl is not None and not late \
        and check_balancer(policy.balance) == "H"
    # heterogeneous fleet + autoscaling (None = homogeneous, bit-exact)
    fres = resolve_fleet(cluster, backend="np")
    fleet_on = fres is not None
    auto_on = fleet_on and fres.auto_on
    speeds = np.asarray(fres.speeds) if fleet_on else None
    if auto_on:
        if late:
            raise ValueError(
                f"autoscaler {fres.policy.name!r} requires early binding"
                f" — late binding has no per-worker placement to mask")
        if fres.policy.needs_telemetry and tel is None:
            raise ValueError(
                f"autoscaler {fres.policy.name!r} reads the telemetry "
                f"slowdown sketch as its sensor; pass telemetry="
                f"TelemetryCfg() to the simulator")
        auto_decide = fres.decide
        auto_cool = float(fres.cfg.cooldown_s)
        n_on = W                        # start fully provisioned
        cool_until = 0.0
        prov_time = 0.0
        snap = np.zeros(N_BINS, dtype=np.int64)

    def set_rates(w: int) -> None:
        ts = tasks[w]
        spd = float(speeds[w]) if fleet_on else 1.0
        if not ts:
            return
        if late:
            for t in ts:
                t.rate = spd
            return
        rs = res.rates([t.remaining for t in ts], [t.seq for t in ts])
        for t, r in zip(ts, rs):
            t.rate = r * spd if fleet_on else r

    def start_task(w: int, arr_idx: int, start_service: bool) -> None:
        """Place arrival ``arr_idx`` on worker ``w`` (slot already free)."""
        f = int(wl.func[arr_idx])
        avail = int(warm[w, f]) if life is None \
            else life.materialized_at(w, f, warm[w, f], now)
        evicted = False
        if avail > 0:
            warm[w, f] -= 1
            is_cold = False
        else:
            is_cold = True
            idle = int(warm[w].sum()) if life is None \
                else int(life.eff_row(warm[w], w, now).sum())
            if len(tasks[w]) + idle >= S:      # evict an idle executor
                # victim: most idle executors (legacy) / LRU pool
                # (lifecycle) — first index breaks ties, the contract
                # shared with the engines
                victim = int(np.argmax(warm[w])) if life is None \
                    else life.evict_victim(warm[w], w, now)
                warm[w, victim] -= 1
                evicted = True
        if tel is not None:
            on_place_np(tel, w, is_cold, evicted)
        if tl is not None:
            tl_on_place_np(tl, now, is_cold, evicted)
        cold[arr_idx] = is_cold
        worker_of[arr_idx] = w
        svc = float(wl.service[arr_idx])
        if is_cold:
            svc += cluster.cold_start_penalty if life is None \
                else life.cold_cost(f, cluster.cold_start_penalty)
        if life is not None:
            # adaptive keep-alive observes the placed pool's idle age
            # AFTER the warm/cold decision (same order as the
            # batched engine's in-place observation block)
            life.observe_place(w, f, now)
        tasks[w].append(_Task(arr_idx=arr_idx, func=f,
                              arrival=float(wl.arrival[arr_idx]),
                              remaining=svc, seq=arr_idx))

    def pop_queue() -> None:
        """Dispatch queued invocations to workers with free cores."""
        while queue:
            loads = [len(tasks[w]) for w in range(W)]
            w = int(np.argmin(loads))
            if loads[w] >= C:
                break
            start_task(w, queue.pop(0), True)

    def advance(dt: float) -> None:
        nonlocal now, server_time, core_time, lb_state
        dt_left = dt
        while True:
            any_task = any(tasks[w] for w in range(W))
            if not any_task:
                if late:
                    pop_queue()
                    if any(tasks[w] for w in range(W)):
                        continue
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
            # integrals with pre-advance occupancy (rates constant over tau)
            server_time += tau * sum(1 for w in range(W) if tasks[w])
            core_time += tau * sum(min(len(tasks[w]), C) for w in range(W))
            if tel is not None:
                on_advance_np(
                    tel, tau,
                    np.array([bool(tasks[w]) for w in range(W)]),
                    np.array([len(tasks[w]) for w in range(W)]),
                    len(queue))
            if tl is not None:
                # windowed twin: the whole tau slice credits the window
                # of its start (left-start convention, same as the scan
                # engine)
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
                        response[t.arr_idx] = now - t.arrival
                        if tel is not None:
                            on_complete_np(tel, response[t.arr_idx],
                                           float(wl.service[t.arr_idx]),
                                           t.arr_idx, tel_cutoff)
                        if tl is not None:
                            # all completions (no warmup cutoff), in the
                            # window of the completion time
                            tl_on_complete_np(
                                tl, now, response[t.arr_idx],
                                float(wl.service[t.arr_idx]))
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
                            # effective (wall-clock-equivalent) duration
                            # when the fleet is heterogeneous — one f64
                            # division, bitwise ≡ the batched engine's
                            svc_obs = wl.service[t.arr_idx] / speeds[w] \
                                if fleet_on else wl.service[t.arr_idx]
                            lb_state = res.on_complete(
                                lb_state, w, t.func, float(svc_obs),
                                n_alive)
                    else:
                        survivors.append(t)
                tasks[w] = survivors
            if late:
                pop_queue()
            if dt_left <= 0:
                break

    for i in range(N):
        t_i = float(wl.arrival[i])
        if auto_on:
            # provisioned-time integral over [now, t_i] at the current
            # n_on (decisions only take effect at arrival boundaries)
            prov_time += (t_i - now) * float(n_on)
        if tl is not None:
            # windowed provisioned core-seconds over the same interval,
            # credited to the interval-start window (same operand order
            # as the batched engine: (dt × n_prov) × C)
            n_prov = float(n_on) if auto_on else float(W)
            tl_on_prov_np(tl, now, (t_i - now) * n_prov * float(C))
        advance(t_i - now)
        now = t_i  # guard drift
        active = np.array([len(tasks[w]) for w in range(W)])
        if late:
            if tl is not None:
                tl_on_arrival_np(tl, t_i, W)
            if active.min() < C:
                start_task(int(np.argmin(active)), i, True)
            else:
                queue.append(i)
        else:
            f = int(wl.func[i])
            wcol = warm[:, f] if life is None \
                else life.materialized_col(warm[:, f], f, now)
            sel_active = active
            if auto_on:
                # autoscale decision: slowdown-sketch window since the
                # last snapshot, gated by cooldown + non-empty window —
                # same gating (and decide ops) as the batched engine
                window = tel["slow_hist"] - snap
                if t_i >= cool_until and int(window.sum()) >= 1:
                    n_new = int(auto_decide(n_on, window))
                    if tl is not None and n_new != n_on:
                        # log the level change with the sensor p99 the
                        # controller read off the same window
                        tl_event_np(tl, t_i, EV_AUTOSCALE, n_new,
                                    sensor_p99_np(window))
                    n_on = n_new
                    cool_until = t_i + auto_cool
                    snap = tel["slow_hist"].copy()
                # deprovisioned workers are masked slot-full at
                # selection; their running tasks drain normally
                sel_active = np.where(np.arange(W) < n_on, active, S)
            if tl is not None:
                # post-decision level, last write wins in the window
                tl_on_arrival_np(tl, t_i, n_on if auto_on else W)
                if flip_on:
                    # the hybrid balancer packs while any selectable
                    # worker still has a free core (hermes_score's
                    # low_load read on the masked active vector)
                    new_mode = int(bool((sel_active < C).any()))
                    if new_mode != int(tl["mode"]):
                        tl_event_np(tl, t_i, EV_MODE_FLIP, new_mode,
                                    float("nan"))
                    tl["mode"] = np.int32(new_mode)
            if lb_state is not None:
                w, lb_state = res.select(lb_state, sel_active, wcol, f,
                                         wl.func_home, float(wl.u_lb[i]), i)
            else:
                w = res.select(sel_active, wcol, f, wl.func_home,
                               float(wl.u_lb[i]), i)
            if w < 0:
                rejected[i] = True
                if tel is not None:
                    on_reject_np(tel)
                if tl is not None:
                    tl_on_reject_np(tl, t_i)
            else:
                start_task(w, i, True)
        if chunk_hook is not None and chunk_size and \
                ((i + 1) % chunk_size == 0 or i + 1 == N):
            # the streaming engine's chunk boundary: the last arrival
            # of the segment has been placed, nothing else has run
            chunk_hook(i // chunk_size,
                       None if tel is None
                       else {k: np.copy(v) for k, v in tel.items()},
                       now)

    t_last = now
    advance(math.inf)  # drain
    if auto_on:
        # drain tail: the fleet stays provisioned to the last completion
        prov_time += (now - t_last) * float(n_on)
        prov_core_s = prov_time * C
    else:
        prov_core_s = now * W * C
    if tl is not None:
        n_prov = float(n_on) if auto_on else float(W)
        tl_on_prov_np(tl, t_last, (now - t_last) * n_prov * float(C))
    return SimResult(response=response, cold=cold, rejected=rejected,
                     worker=worker_of, server_time=server_time,
                     core_time=core_time, end_time=now,
                     telemetry=None if tel is None
                     else TelemetryResult.from_state(tel, cfg=telemetry),
                     prov_core_s=prov_core_s,
                     timeline=None if tl is None
                     else TimelineResult.from_state(tl, cfg=timeline))


def simulate_ref_chunks(policy: PolicySpec, cluster: ClusterCfg,
                        wl: Workload, *, chunk_size: int,
                        telemetry: TelemetryCfg | None = None
                        ) -> tuple[SimResult, list[dict | None]]:
    """Oracle replay of the streaming engine's segment boundaries.

    Runs :func:`simulate_ref` once, snapshotting the telemetry plane at
    every chunk boundary (after the segment's last arrival has been
    placed).  Returns ``(result, snapshots)`` — one snapshot per chunk,
    each a deep-copied telemetry dict (or None with telemetry off).
    The integer histogram/counter planes are bitwise-comparable to the
    engines' carry at the same boundary, so a chunked run and this
    replay agreeing *per segment* is the streaming parity gate.
    """
    snaps: list[dict | None] = []
    res = simulate_ref(
        policy, cluster, wl, telemetry=telemetry,
        chunk_size=int(chunk_size),
        chunk_hook=lambda c, tel_snap, now: snaps.append(tel_snap))
    return res, snaps


# --------------------------------------------------------------------------
# Holding an engine's run to the oracle, at the reference's tolerances
# --------------------------------------------------------------------------

#: responses (and the end time): absolute, s (tests/test_simulator.py)
RESPONSE_ATOL = 1e-6
#: server and core time: relative to max(1, the oracle's)
TIME_RTOL = 1e-3
#: telemetry and timeline float integrals: atol = rtol
#: (tests/test_batch_sim.py, tests/test_timeline.py), and
#: ``prov_core_s`` relative (tests/test_fleet.py)
PLANE_TOL = 1e-9
TEL_INT = ("slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict",
           "n_reject", "decisions")
TEL_FLOAT = ("busy_time", "depth_time", "qlen_time")
TL_INT = ("mode", "arrivals", "n_cold", "n_warm", "n_evict", "n_reject",
          "slow_hist", "lat_hist", "n_on", "ev_kind", "ev_val", "ev_count")
TL_FLOAT = ("window_s", "busy_time", "qlen_time", "prov_core", "ev_t",
            "ev_p99")


class OracleMismatch(AssertionError):
    """An engine's run disagrees with the oracle beyond its tolerance."""


def _field(x, name: str):
    return x[name] if isinstance(x, Mapping) else getattr(x, name)


def _planes_gap(got, want, ints, floats, what: str) -> float:
    """Integer planes equal, float planes within ``PLANE_TOL`` (atol and
    rtol, NaN where the oracle has NaN); returns the largest float gap.
    Either side is a result (attributes) or a state dict."""
    gap = 0.0
    for name in ints:
        a, b = np.asarray(_field(got, name)), np.asarray(_field(want, name))
        if a.shape != b.shape or not np.array_equal(a, b):
            raise OracleMismatch(f"{what}: {name} differs from the oracle")
    for name in floats:
        a = np.asarray(_field(got, name), dtype=np.float64)
        b = np.asarray(_field(want, name), dtype=np.float64)
        if a.shape != b.shape or not np.array_equal(np.isnan(a),
                                                    np.isnan(b)):
            raise OracleMismatch(f"{what}: {name} differs from the oracle "
                                 f"in shape or NaNs")
        d = np.abs(np.nan_to_num(a - b, nan=0.0))
        if (d > PLANE_TOL + PLANE_TOL * np.abs(np.nan_to_num(b))).any():
            raise OracleMismatch(f"{what}: {name} beyond {PLANE_TOL} of the "
                                 f"oracle (gap {float(d.max())})")
        gap = max(gap, float(d.max(initial=0.0)))
    return gap


def telemetry_gap(got, want, what: str = "run") -> float:
    """Hold one replication's telemetry (a ``TelemetryResult`` or a state
    dict under the numpy keys, such as an engine's carry at a chunk
    boundary) to the oracle's (``SimResult.telemetry`` or a
    :func:`simulate_ref_chunks` snapshot): the integer planes equal, the
    float integrals within :data:`PLANE_TOL`.  Raises
    :class:`OracleMismatch`; returns the largest float gap."""
    return _planes_gap(got, want, TEL_INT, TEL_FLOAT, what)


def oracle_gaps(out, ref: SimResult, what: str = "run") -> dict:
    """Hold one replication of an engine's run (a ``SimOutput``, a
    ``ServeResult``: ``response``, ``cold``, ``rejected``, ``worker``,
    the three times, ``prov_core_s``, ``telemetry``, ``timeline``) to the
    oracle's result of the same inputs, at the reference's own oracle
    tolerances: ``worker``, ``cold`` and ``rejected`` equal; ``response``
    NaN at the same places and within :data:`RESPONSE_ATOL`, as is the end
    time; server and core time within :data:`TIME_RTOL` of max(1, the
    oracle's); ``prov_core_s`` within :data:`PLANE_TOL` relative; the
    telemetry's and the timeline's integer planes equal and their float
    planes within :data:`PLANE_TOL`.  Raises :class:`OracleMismatch`
    naming the first plane beyond them; returns the largest gap of each
    family (times relative)."""
    for name in ("worker", "cold", "rejected"):
        a, b = np.asarray(getattr(out, name)), getattr(ref, name)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise OracleMismatch(f"{what}: {name} differs from the oracle")
    resp = np.asarray(out.response, dtype=np.float64)
    if not np.array_equal(np.isnan(resp), np.isnan(ref.response)):
        raise OracleMismatch(f"{what}: response NaN at other places than "
                             f"the oracle's")
    gaps = {"response": float(np.abs(np.nan_to_num(
        resp - ref.response, nan=0.0)).max(initial=0.0))}
    gaps["end_time"] = abs(float(out.end_time) - ref.end_time)
    if max(gaps["response"], gaps["end_time"]) > RESPONSE_ATOL:
        raise OracleMismatch(f"{what}: response or end time beyond "
                             f"{RESPONSE_ATOL} s of the oracle ({gaps})")
    gaps["times"] = max(
        abs(float(getattr(out, name)) - getattr(ref, name))
        / max(1.0, abs(getattr(ref, name)))
        for name in ("server_time", "core_time"))
    if gaps["times"] > TIME_RTOL:
        raise OracleMismatch(f"{what}: server or core time beyond "
                             f"{TIME_RTOL} relative ({gaps['times']})")
    gaps["prov_core_s"] = abs(float(out.prov_core_s) - ref.prov_core_s) \
        / max(1.0, abs(ref.prov_core_s))
    if gaps["prov_core_s"] > PLANE_TOL:
        raise OracleMismatch(f"{what}: prov_core_s beyond {PLANE_TOL} "
                             f"relative ({gaps['prov_core_s']})")
    for name, ints, floats in (("telemetry", TEL_INT, TEL_FLOAT),
                               ("timeline", TL_INT, TL_FLOAT)):
        got, want = getattr(out, name), getattr(ref, name)
        if (got is None) != (want is None):
            raise OracleMismatch(f"{what}: {name} on one side only")
        if want is not None:
            gaps[name] = _planes_gap(got, want, ints, floats,
                                     f"{what}: the {name}'s")
    return gaps
