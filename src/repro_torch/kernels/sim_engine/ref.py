"""Plain torch version of the fused early-binding event loop.

The same function as the CUDA kernel (``csrc/sim_engine.cu``) with the
kernel's control flow: a loop over replications, then over arrivals,
each advance loop reading its own replication's predicate (no lockstep
masking, no scratch index, no pad column), and the balancers in the
kernel's form (LL and LOC as a first-index argmin of the load and of the
ring distance from the function's home, RR as LOC's from ``i % W``, R by
rank among the workers with a free slot, JSQ2 from two indices of one
uniform, H through the Hermes score, DD and SWARM as a first-index
argmin of an f64 key, HIKU from the head of its ready-ring).  A
carried-state balancer's choice reads its state, and its writes are
made after the choice (a HIKU pop, DD's charge of the estimate), as the
kernel's one thread makes them after its barrier; each completion then
applies ``on_complete`` with the task's nominal service and the worker's
active count after it.  It returns what the port's batched engine
(``core/simulator.py``, ``backend="torch"``) returns, bit for bit, and
the final balancer state.  The CPU tests and the chip check hold the
kernel against it.

Under a lifecycle (``cluster.lifecycle`` with a built-in keep-alive:
NONE, FIXED_TTL, HYBRID_HIST) it carries the kernel's life plane: the
choice reads the materialized warm column; placement takes its cold
start, its slot-pressure victim (the LRU materialized pool) and the
preset's cost over the worker's materialized pools, then HYBRID_HIST's
observation adds one bin and recomputes only that function's windows,
as the kernel's warp does (a prefix sum over the 32 bins, the first bin
at or above each quantile); a completion zeroes a stale pool, refreshes
its idle clock and holds the worker to ``max_idle``.  The final life
state comes back as ``life_<key>``.

Under telemetry or a fleet (a built-in autoscaler, speeds from a
built-in preset or an explicit vector; not a ``STATIC`` fleet of unit
speeds alone, whose outputs are the plane-off ones) it carries the
kernel's observation plane (:class:`ObsPlane`): every PS rate times the
worker's speed, SWARM and DD observing the service over the speed; per
advance iteration the busy and depth integrals of the workers with a
task; per completion past the warmup cutoff one count in each histogram
(the right-side search of the edges' bits); the cold, warm, eviction
and rejection counters and the decision counts; and under ``TARGET_P99``,
per arrival, the provisioned-time integral, then the gated decision
(the cooldown elapsed and a recorded completion since the snapshot: the
first bin whose cumulative count reaches ``ceil(0.99 · total)``, its
geometric midpoint against the host's band, the MIAD step, the clamp,
the snapshot) and the workers ``>= n_on`` read as slot-full at the
choice.  The telemetry comes back as ``tel_<key>`` (with ``telemetry``)
and the autoscaler's state as ``fleet_<key>``.

Under a timeline (a ``TimelineCfg``) the observation plane is on (its
telemetry work made here but not returned unless asked for) and each
replication carries the kernel's timeline plane, kept here by the numpy
updaters of :mod:`repro_torch.telemetry.timeline` at the batched engine's
sites and in its order: per arrival the provisioned core-seconds over the
gap (in the gap start's window), per advance iteration the busy integral
of each worker (the queue length is 0 under early binding), per
completion both coarse sketches, each budget eviction, ``TARGET_P99``'s
decision where it changed ``n_on`` (with the sensor p99 of its window),
the arrival and its ``n_on``, under H the pack/spread flip read on the
masked loads, each rejection and placement, and the drain's tail.  It
comes back as ``tl_<key>`` in :class:`~repro_torch.telemetry.timeline.
TimelineResult`'s shapes (``[R, K]``, ``[R, K, B]``, ``[R, K, W]``,
``[R, E]``, ``[R]``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import NotPortedError
from repro_torch import fleet as fleet_mod
from repro_torch.fleet.policies import _p99_bounds
from repro_torch.kernels.hermes_select.ref import hermes_select_ref
from repro_torch.lifecycle import is_builtin, resolve_lifecycle
from repro_torch.lifecycle.policies import (HIST_BINS, HIST_HEAD_Q,
                                            HIST_MARGIN, HIST_MIN_OBS,
                                            HIST_TAIL_Q, hybrid_params)
from repro_torch.policy import INIT_STATE
from repro_torch.policy.balancers import (
    _SW_COLD_DN, _SW_COLD_UP, _SW_EST_DN, _SW_EST_UP, _SW_HOT_DN,
    _SW_HOT_UP, DD_ALPHA, SWARM_WARM_N)
from repro_torch.telemetry import timeline as tln
from repro_torch.telemetry.engine import bin_index
from repro_torch.telemetry.sketch import N_BINS, hist_edges
from repro_torch.telemetry.state import warmup_cutoff
from repro_torch.telemetry.timeline_engine import widths

EPS = 1e-9
_BIG_TIME = 1e18
_BIG = 1 << 30
_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64
#: balancer name -> the kernel's code (``enum Balancer`` in the source)
BALANCER_CODES = {"H": 0, "LL": 1, "LOC": 2, "R": 3, "JSQ2": 4, "RR": 5,
                  "HIKU": 6, "DD": 7, "SWARM": 8}


def balancer_name(balance) -> str:
    """``balance`` (a balancer name or its enum) if the fused engine has
    it (:data:`BALANCER_CODES`); :class:`NotPortedError` otherwise.  Which
    policies take this engine is the policy table's decision
    (:func:`repro_torch.policy.engine`), not the kernel's."""
    name = str(getattr(balance, "value", balance)).strip().upper()
    if name not in BALANCER_CODES:
        raise NotPortedError(
            f"sim_engine runs the balancers {', '.join(BALANCER_CODES)}; "
            f"got {name!r}")
    return name


@dataclasses.dataclass(frozen=True)
class LifePlane:
    """The fused engine's lifecycle inputs: the preset's costs ``[F]``
    (``None``: the scalar penalty), the ``max_idle`` budget, whether the
    keep-alive is HYBRID_HIST with its bin width and fallback, and the
    initial state (``life_idle_since [R, W, F]`` at -1, ``life_pre`` and
    ``life_keep [R, F]``, HYBRID_HIST's ``life_hist [R, F, 32]`` and
    ``life_n_obs [R, F]``)."""

    costs: Optional[torch.Tensor]
    max_idle: int
    hybrid: bool
    bin_s: float
    ttl: float
    state: dict


def life_plane(cluster, R: int, W: int, F: int, device) -> \
        Optional[LifePlane]:
    """``cluster``'s life plane for the fused engine, ``None`` without a
    lifecycle; :class:`NotPortedError` for a keep-alive that is not a
    built-in (the batched engine runs those)."""
    lres = resolve_lifecycle(cluster, F, device)
    if lres is None:
        return None
    if not is_builtin(lres.cfg.keepalive):
        raise NotPortedError(
            f"sim_engine runs the built-in keep-alives NONE, FIXED_TTL and "
            f"HYBRID_HIST; got {lres.policy.name!r}")
    ka = lres.init_policy_state(R, W, F) or {}
    pre, keep = lres.windows(ka or None)
    state = {f"life_{k}": v for k, v in ka.items()}
    state.update(
        life_idle_since=torch.full((R, W, F), -1.0, dtype=_F64,
                                   device=device),
        life_pre=pre.to(_F64).expand(R, F).clone(),
        life_keep=keep.to(_F64).expand(R, F).clone())
    bin_s, ttl = hybrid_params(lres.cfg)
    return LifePlane(
        costs=None if lres.cold_costs is None else torch.as_tensor(
            lres.cold_costs, dtype=_F64, device=device),
        max_idle=lres.max_idle, hybrid=lres.observe is not None,
        bin_s=bin_s, ttl=ttl, state=state)


@dataclasses.dataclass(frozen=True)
class ObsPlane:
    """The fused engine's observation inputs: the speeds ``[W]`` f64
    (1.0 without a fleet), the sketch's edges ``[N_BINS + 1]`` f64, the
    warmup ``cutoff``, whether ``TARGET_P99`` runs (``auto``) with its
    band ``hi``/``lo``, ``min_workers`` and ``cooldown``, which state
    goes back to the caller (``tel``: telemetry was asked for), and the
    initial state: ``tel_slow_hist``/``tel_lat_hist [R, N_BINS]`` i64,
    ``tel_n_cold``/``tel_n_warm``/``tel_n_evict``/``tel_n_reject [R]``
    i64, ``tel_busy_time``/``tel_depth_time [R, W]`` f64,
    ``tel_qlen_time [R]`` f64 (0 under early binding),
    ``tel_decisions [R, W]`` i64, and for the autoscaler
    ``fleet_n_on [R]`` i32 (W), ``fleet_cool_until``/``fleet_prov_time
    [R]`` f64 and ``fleet_snap [R, N_BINS]`` i64, all zero but
    ``n_on``; and ``busy_iters [R]`` i64, the busy workers summed over the
    advance iterations with ``tau > 0`` (the integrals' updates, which a
    bound counts), returned whenever the plane is on.
    """

    speed: torch.Tensor
    edges: torch.Tensor
    cutoff: int
    auto: bool
    hi: float
    lo: float
    min_workers: int
    cooldown: float
    tel: bool
    state: dict

    def returned(self) -> dict:
        """The state the engine hands back: ``tel_*`` with telemetry,
        ``fleet_*`` under the autoscaler."""
        return {k: v for k, v in self.state.items()
                if (k.startswith("tel_") and self.tel)
                or (k.startswith("fleet_") and self.auto)
                or k == "busy_iters"}


def obs_plane(cluster, telemetry, R: int, N: int, W: int, device,
              timeline=None) -> Optional[ObsPlane]:
    """The observation plane for ``cluster``, ``telemetry`` (a
    ``TelemetryCfg`` or None) and ``timeline`` (a ``TimelineCfg`` or None),
    ``None`` without any, or with only a fleet that changes nothing
    (``STATIC``, every speed 1.0);
    :class:`NotPortedError` for an autoscaler or a speed preset a user
    registered (the batched engine runs those), ``ValueError`` for
    ``TARGET_P99`` without telemetry."""
    fl = cluster.fleet
    if telemetry is None and fl is None and timeline is None:
        return None
    if fl is not None and not (fleet_mod.is_builtin(fl.autoscale)
                               and fleet_mod.preset_is_builtin(fl)):
        raise NotPortedError(
            f"sim_engine runs the built-in autoscalers and speed presets "
            f"(or an explicit speed vector); got autoscale "
            f"{fl.autoscale!r}, preset {fl.preset!r}")
    auto = fl is not None and \
        str(fl.autoscale).strip().upper() != fleet_mod.STATIC
    if auto and telemetry is None:
        raise ValueError(
            f"autoscaler {fl.autoscale!r} reads the telemetry slowdown "
            f"sketch as its sensor; pass telemetry=TelemetryCfg()")
    speeds = None if fl is None else fleet_mod.speeds_for(fl, W)
    if telemetry is None and timeline is None and not auto and \
            bool((speeds == 1.0).all()):
        # a static fleet of unit speeds, no telemetry: the outputs are the
        # plane-off ones, so the plane stays off
        return None
    speed = torch.ones(W, dtype=_F64, device=device) if fl is None else \
        torch.tensor(speeds, dtype=_F64, device=device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {f"tel_{k}": zeros(R, _I64)
             for k in ("n_cold", "n_warm", "n_evict", "n_reject")}
    state.update(tel_slow_hist=zeros((R, N_BINS), _I64),
                 tel_lat_hist=zeros((R, N_BINS), _I64),
                 tel_busy_time=zeros((R, W), _F64),
                 tel_depth_time=zeros((R, W), _F64),
                 tel_qlen_time=zeros(R, _F64),
                 tel_decisions=zeros((R, W), _I64),
                 fleet_n_on=torch.full((R,), W, dtype=_I32, device=device),
                 fleet_cool_until=zeros(R, _F64),
                 fleet_prov_time=zeros(R, _F64),
                 fleet_snap=zeros((R, N_BINS), _I64),
                 busy_iters=zeros(R, _I64))
    hi, lo = _p99_bounds(fl) if auto else (0.0, 0.0)
    return ObsPlane(
        speed=speed, edges=torch.tensor(hist_edges(), dtype=_F64,
                                        device=device),
        cutoff=N if telemetry is None else warmup_cutoff(N, telemetry),
        auto=auto, hi=hi, lo=lo,
        min_workers=int(fl.min_workers) if auto else 1,
        cooldown=float(fl.cooldown_s) if auto else 0.0,
        tel=telemetry is not None, state=state)


def _materialized(idle, pre, keep, now):
    """Pools whose idle age ``now - idle`` lies in ``[pre, pre + keep]``."""
    age = now - idle
    return (age >= pre) & (age <= pre + keep)


def _observe(life, hist_f, n_obs, pre, keep, f, gap):
    """HYBRID_HIST's observation of an idle gap of function ``f``: one bin
    more, then ``f``'s windows alone from its 32 bins, as the kernel's
    warp computes them (the other functions' windows do not change)."""
    b = max(min(int(gap / life.bin_s), HIST_BINS - 1), 0)
    hist_f[b] += 1.0
    n_obs[f] += 1.0
    n = float(n_obs[f])
    cdf, head, tail = 0.0, None, None
    for k in range(HIST_BINS):
        cdf += float(hist_f[k])     # integer-valued: exact
        if head is None and cdf >= HIST_HEAD_Q * n:
            head = k
        if tail is None and cdf >= HIST_TAIL_Q * n:
            tail = k
    if n >= HIST_MIN_OBS:
        p = float(head) * life.bin_s * (1.0 - HIST_MARGIN)
        pre[f] = p
        keep[f] = (float(tail) + 1.0) * life.bin_s * (1.0 + HIST_MARGIN) - p
    else:
        pre[f] = 0.0
        keep[f] = life.ttl


def _choose(balance, state, active, warm_col, home_f, u, i, cores, slots):
    """Worker for arrival ``i``, or -1 if every worker is slot-full.
    Reads a carried-state balancer's ``state`` and changes nothing."""
    has_slot = active < slots
    if not bool(has_slot.any()):
        return -1
    W = active.shape[0]
    if balance == "H":
        choices, _ = hermes_select_ref(active, warm_col[None],
                                       cores=cores, slots=slots)
        return int(choices[0])
    if balance == "R":
        k = has_slot.sum()
        target = int(torch.minimum((u * k).to(_I32), k - 1))
        return int(torch.nonzero(has_slot)[target, 0])
    if balance in ("LOC", "RR"):
        # the first worker with a free slot on the ring from the home
        home = home_f if balance == "LOC" else i % W
        key = (torch.arange(W, dtype=_I64, device=active.device) - home) % W
        return int(torch.where(has_slot, key, _BIG).argmin())
    if balance == "JSQ2":
        x = float(u) * W
        a = min(int(x), W - 1)
        b = min(int((x - math.floor(x)) * W), W - 1)
        key = torch.where(has_slot, active, _BIG)
        w = b if bool(key[b] < key[a]) else a
        if bool(has_slot[w]):
            return w
    if balance == "HIKU" and int(state["tail"]) > int(state["head"]):
        cand = int(state["ring"][int(state["head"]) % W])
        if bool(has_slot[cand]):
            return cand
    if balance in ("DD", "SWARM"):
        if balance == "DD":
            key = state["ew"]
        else:
            inv = state["inv"]
            key = torch.where(active + 1 <= cores, inv,
                              (active.to(_F64) + 1.0) * inv)
        return int(torch.where(has_slot, key, torch.inf).argmin())
    # LL, and the least-loaded fallback of JSQ2 and HIKU
    return int(torch.where(has_slot, active, _BIG).argmin())


def _commit(balance, state, w, f):
    """A carried-state balancer's writes for a choice ``w`` of an arrival
    of function ``f``: HIKU's pop (even when its candidate was slot-full),
    DD's charge of the estimate; none for a rejection."""
    if w < 0:
        return
    if balance == "HIKU" and int(state["tail"]) > int(state["head"]):
        W = state["ring"].shape[0]
        state["in_ring"][int(state["ring"][int(state["head"]) % W])] = 0
        state["head"] += 1
    elif balance == "DD":
        state["ew"][w] = float(state["ew"][w]) + float(state["est"][f])


def _on_complete(balance, state, w, f, service, n_active_after):
    """A carried-state balancer's update for a completion on worker ``w``
    of a task of function ``f`` with nominal service ``service``."""
    if balance == "HIKU":
        if n_active_after == 0 and int(state["in_ring"][w]) == 0:
            W = state["ring"].shape[0]
            state["ring"][int(state["tail"]) % W] = w
            state["in_ring"][w] = 1
            state["tail"] += 1
    elif balance == "DD":
        est_f = float(state["est"][f])
        state["ew"][w] = max(float(state["ew"][w]) - est_f, 0.0)
        state["est"][f] = est_f + DD_ALPHA * (service - est_f)
    elif balance == "SWARM":
        est_f, inv_w = float(state["est"][f]), float(state["inv"][w])
        sample = service / est_f
        state["est"][f] = est_f * (_SW_EST_UP if service > est_f
                                   else _SW_EST_DN)
        hot = int(state["cnt"][w]) < SWARM_WARM_N
        if sample > inv_w:
            state["inv"][w] = inv_w * (_SW_HOT_UP if hot else _SW_COLD_UP)
        else:
            state["inv"][w] = inv_w * (_SW_HOT_DN if hot else _SW_COLD_DN)
        state["cnt"][w] += 1


def tl_planes(states: list, device) -> dict:
    """The per-replication numpy timeline states as ``tl_<key>`` tensors
    with a leading ``R`` axis."""
    return {f"tl_{k}": torch.as_tensor(np.stack([st[k] for st in states]),
                                       device=device)
            for k in states[0]}


def _fresh(balance, R, W, S, F, dev, life, obs, timeline, window_s,
           chunk: bool) -> dict:
    """The initial state of both modes, ``[R, …]`` tensors: the slot
    matrices, the warm pools ``[R, W, F]``, the clocks, the iteration
    counts, a carried-state balancer's ``lb_*``, the life plane's
    ``life_*``, the observation plane's whole state (``tel_*``,
    ``busy_iters``, ``fleet_*``) and the timeline's ``tl_*`` (widths
    ``window_s``); in chunk mode the slot mirrors ``task_fn``/``task_svc``
    and the counters ``stream_*``."""
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    st = dict(remaining=full((R, W, S), torch.inf, _F64),
              task_arr=full((R, W, S), 0.0, _F64),
              task_idx=full((R, W, S), -1, _I32),
              warm=full((R, W, F), 0, _I32),
              server_time=full((R,), 0.0, _F64),
              core_time=full((R,), 0.0, _F64),
              now=full((R,), 0.0, _F64),
              iters=full((R,), 0, _I64),
              active=full((R,), 0, _I64))
    if chunk:
        st.update(task_fn=full((R, W, S), 0, _I32),
                  task_svc=full((R, W, S), 0.0, _F64),
                  stream_n_done=full((R,), 0, _I64),
                  stream_n_obs=full((R,), 0, _I64),
                  stream_rec_since=full((R,), 0, _I64),
                  stream_resp_sum=full((R,), 0.0, _F64),
                  stream_slow_sum=full((R,), 0.0, _F64))
    lb = INIT_STATE[balance](R, W, F, dev) if balance in INIT_STATE else {}
    st.update({f"lb_{k}": v for k, v in lb.items()})
    if life is not None:
        st.update({k: v.clone() for k, v in life.state.items()})
    if obs is not None:
        st.update({k: v.clone() for k, v in obs.state.items()})
    if timeline is not None:
        st.update(tl_planes([tln.init_tl_np(W, timeline, float(w))
                             for w in window_s], dev))
    return st


def _run(balance, cluster, st, life, obs, timeline, arrival, func, service,
         u_lb, home, g0: int, drain: bool, out: dict, cutoff: int) -> None:
    """Arrivals ``g0, g0 + 1, …`` (the ``[R, n]`` inputs) from the state
    ``st`` (updated in place), then the drain if ``drain``.  Their outputs
    go to ``out``'s ``[R, n]`` planes ``cold``, ``rejected`` and
    ``worker_of``, and each response to ``out["resp"]`` when ``out`` has
    it (the monolithic run).  In chunk mode (``st`` has the slot mirrors)
    a completion reads its function and service from the mirrors and adds
    to the counters.  ``cutoff``: the warmup index of the sketches and the
    counters."""
    chunk = "task_fn" in st
    W, C, S = int(cluster.n_workers), int(cluster.cores), int(cluster.slots)
    R, n = arrival.shape
    dev = st["now"].device
    if obs is not None:
        ob = st                          # the observation state, in place
        ids = torch.arange(W, device=dev)
        if obs.auto:
            # TARGET_P99's numpy decide: the kernel's warp takes the same
            # integer decision from the same bits
            decide = fleet_mod.get_autoscaler(cluster.fleet.autoscale) \
                .make_np(cluster.fleet, W)
    c = torch.tensor(float(C), dtype=_F64, device=dev)
    pen = torch.tensor(float(cluster.cold_start_penalty), dtype=_F64,
                       device=dev)
    no_pen = torch.zeros((), dtype=_F64, device=dev)
    for r in range(R):
        remaining = st["remaining"][r].clone()
        task_arr, task_idx = st["task_arr"][r], st["task_idx"][r]
        warm = st["warm"][r]                          # views: in place
        if chunk:
            task_fn, task_svc = st["task_fn"][r], st["task_svc"][r]
            n_done = int(st["stream_n_done"][r])
            n_rec = int(st["stream_n_obs"][r])
            resp_sum = st["stream_resp_sum"][r].clone()
            slow_sum = st["stream_slow_sum"][r].clone()
        else:
            resp = out["resp"][r]
        now = st["now"][r].clone()
        server_time = st["server_time"][r].clone()
        core_time = st["core_time"][r].clone()
        iters, active_sum = int(st["iters"][r]), int(st["active"][r])
        state = {k[3:]: v[r] for k, v in st.items()
                 if k.startswith("lb_")}              # views: in place
        if life is not None:                          # views: in place
            idle = st["life_idle_since"][r]
            pre, keep = st["life_pre"][r], st["life_keep"][r]
            if life.hybrid:
                hist, n_obs = st["life_hist"][r], st["life_n_obs"][r]
        if obs is not None:
            n_on = int(ob["fleet_n_on"][r]) if obs.auto else W
            cool_until = ob["fleet_cool_until"][r].clone()
            prov = ob["fleet_prov_time"][r].clone()
        tl = None
        if timeline is not None:
            tl = {k[3:]: v[r].cpu().numpy().copy() for k, v in st.items()
                  if k.startswith("tl_")}
        for i in range(n + 1 if drain else n):
            dt_left = arrival[r, i] - now if i < n else \
                torch.tensor(_BIG_TIME, dtype=_F64, device=dev)
            if tl is not None:
                # provisioned core-seconds over the gap, in its start's
                # window (the drain's tail after the loop)
                t_gap = float(now)
                n_prov = float(n_on) if obs.auto else float(W)
                if i < n:
                    tln.tl_on_prov_np(tl, t_gap, (float(arrival[r, i])
                                                  - t_gap) * n_prov * C)
            if obs is not None and obs.auto:
                # provisioned time over the gap (to the drain's end after
                # the last arrival: t_last is now)
                t_last = now
                if i < n:
                    prov = prov + (arrival[r, i] - now) * float(n_on)
            while True:
                active = task_idx >= 0
                pending = bool((active & (remaining <= EPS)).any())
                if not (bool(active.any()) and (bool(dt_left > 0)
                                                or pending)):
                    break
                iters += 1
                n_w = active.sum(dim=1)
                active_sum += int(n_w.sum())
                rate = torch.clamp(c / n_w.clamp(min=1).to(_F64), max=1.0)
                rates = torch.where(active, rate[:, None], 0.0)
                if obs is not None:
                    rates = rates * obs.speed[:, None]
                t_done = torch.where(rates > 0, remaining / rates, torch.inf)
                tmin = t_done.amin()
                j = int(t_done.view(-1).argmin())
                wj, sj = divmod(j, S)
                tau = torch.minimum(dt_left, tmin)
                tau = torch.where(torch.isfinite(tau) & (tau > 0), tau, 0.0)
                server_time = server_time + tau * (n_w > 0).sum()
                core_time = core_time + tau * n_w.clamp(max=C).sum()
                if obs is not None:
                    ob["tel_busy_time"][r] += tau * (n_w > 0).to(_F64)
                    ob["tel_depth_time"][r] += tau * n_w.to(_F64)
                    if bool(tau > 0):
                        ob["busy_iters"][r] += int((n_w > 0).sum())
                if tl is not None:
                    tln.tl_on_advance_np(tl, float(now), float(tau),
                                         (n_w > 0).cpu().numpy(), 0)
                now = now + tau
                tid = int(task_idx[wj, sj])
                completed = bool(tmin <= dt_left) or (
                    tid >= 0 and bool(remaining[wj, sj] <= EPS))
                remaining = remaining - rates * tau
                if completed and tid >= 0:
                    response = now - task_arr[wj, sj]
                    if chunk:
                        f, svc_nom = int(task_fn[wj, sj]), task_svc[wj, sj].clone()
                    else:
                        resp[tid] = response
                        f, svc_nom = int(func[r, tid]), service[r, tid]
                    slow = response / torch.clamp(svc_nom, min=1e-12)
                    if obs is not None and tid >= cutoff:
                        for hist_key, x in (("tel_slow_hist", slow),
                                            ("tel_lat_hist", response)):
                            b = int(bin_index(x.reshape(1), obs.edges))
                            ob[hist_key][r, b] += 1
                    if chunk:
                        # the exact counters, in completion order
                        n_done += 1
                        if tid >= cutoff:
                            n_rec += 1
                            resp_sum = resp_sum + response
                            slow_sum = slow_sum + slow
                    if tl is not None:
                        tln.tl_on_complete_np(tl, float(now), float(response),
                                              float(svc_nom))
                    if life is not None:
                        # a stale pool restarts from 0; the budget evicts
                        # the worker's LRU materialized pool
                        if bool(now - idle[wj, f] > pre[f] + keep[f]):
                            warm[wj, f] = 0
                        warm[wj, f] += 1
                        idle[wj, f] = now
                        if life.max_idle > 0:
                            eff = torch.where(_materialized(
                                idle[wj], pre, keep, now), warm[wj], 0)
                            if int(eff.sum()) > life.max_idle:
                                warm[wj, int(torch.where(
                                    eff > 0, idle[wj],
                                    torch.inf).argmin())] -= 1
                                if obs is not None:
                                    ob["tel_n_evict"][r] += 1
                                if tl is not None:
                                    tln.tl_on_evict_np(tl, float(now))
                    else:
                        warm[wj, f] += 1
                    remaining[wj, sj] = torch.inf
                    task_idx[wj, sj] = -1
                    svc = svc_nom if obs is None else svc_nom / obs.speed[wj]
                    _on_complete(balance, state, wj, f, float(svc),
                                 int((task_idx[wj] >= 0).sum()))
                dt_left = dt_left - tau
            if i == n:
                if obs is not None and obs.auto:
                    prov = prov + (now - t_last) * float(n_on)
                if tl is not None:
                    tln.tl_on_prov_np(tl, t_gap,
                                      (float(now) - t_gap) * n_prov * C)
                break
            now = arrival[r, i]
            f = int(func[r, i])
            active = (task_idx >= 0).sum(dim=1).to(_I32)
            warm_col = warm[:, f]
            if life is not None:
                warm_col = torch.where(
                    _materialized(idle[:, f], pre[f], keep[f], now),
                    warm_col, 0)
            if obs is not None and obs.auto:
                window = ob["tel_slow_hist"][r] - ob["fleet_snap"][r]
                if bool(now >= cool_until) and int(window.sum()) >= 1:
                    n_new = decide(n_on, window.cpu().numpy())
                    if tl is not None and n_new != n_on:
                        tln.tl_event_np(tl, float(now), tln.EV_AUTOSCALE,
                                        n_new, tln.sensor_p99_np(
                                            window.cpu().numpy()))
                    n_on = n_new
                    cool_until = now + obs.cooldown
                    ob["fleet_snap"][r] = ob["tel_slow_hist"][r]
                # workers past n_on read as slot-full
                active = torch.where(ids < n_on, active, S).to(_I32)
            if tl is not None:
                t_i = float(now)
                tln.tl_on_arrival_np(tl, t_i, n_on if obs.auto else W)
                if balance == "H":
                    # Hermes packs while a worker it sees has a free core
                    mode = int(bool((active < C).any()))
                    if mode != int(tl["mode"]):
                        tln.tl_event_np(tl, t_i, tln.EV_MODE_FLIP, mode,
                                        float("nan"))
                    tl["mode"] = np.int32(mode)
            w = _choose(balance, state, active, warm_col, home[r, f],
                        u_lb[r, i], g0 + i, C, S)
            _commit(balance, state, w, f)
            out["rejected"][r, i] = w < 0
            if w < 0:
                if obs is not None:
                    ob["tel_n_reject"][r] += 1
                if tl is not None:
                    tln.tl_on_reject_np(tl, t_i)
                continue
            row, warm_row = task_idx[w], warm[w]
            cost = pen
            if life is not None:
                # the worker's materialized pools decide; the victim is
                # the LRU one
                eff = torch.where(_materialized(idle[w], pre, keep, now),
                                  warm_row, 0)
                is_cold = bool(eff[f] == 0)
                victim = int(torch.where(eff > 0, idle[w],
                                         torch.inf).argmin())
                n_idle = int(eff.sum())
                if life.costs is not None:
                    cost = life.costs[f]
            else:
                is_cold = bool(warm_row[f] == 0)
                victim = int(warm_row.argmax())
                n_idle = int(warm_row.sum())
            need_evict = is_cold and int((row >= 0).sum()) + n_idle >= S
            if not is_cold:
                warm_row[f] -= 1
            if need_evict:
                warm_row[victim] -= 1
            if obs is not None:
                ob["tel_n_cold" if is_cold else "tel_n_warm"][r] += 1
                ob["tel_n_evict"][r] += int(need_evict)
                ob["tel_decisions"][r, w] += 1
            if tl is not None:
                tln.tl_on_place_np(tl, t_i, is_cold, need_evict)
            if life is not None and life.hybrid and float(idle[w, f]) >= 0:
                _observe(life, hist[f], n_obs, pre, keep, f,
                         max(float(now - idle[w, f]), 0.0))
            slot = int((row < 0).to(_I32).argmax())
            remaining[w, slot] = service[r, i] + (cost if is_cold else no_pen)
            task_arr[w, slot] = now
            task_idx[w, slot] = g0 + i
            if chunk:
                task_fn[w, slot] = f
                task_svc[w, slot] = service[r, i]
            out["cold"][r, i] = is_cold
            out["worker_of"][r, i] = w
        st["remaining"][r] = remaining
        st["server_time"][r] = server_time
        st["core_time"][r] = core_time
        st["now"][r] = now
        st["iters"][r] = iters
        st["active"][r] = active_sum
        if chunk:
            st["stream_n_done"][r] = n_done
            st["stream_n_obs"][r] = n_rec
            st["stream_resp_sum"][r] = resp_sum
            st["stream_slow_sum"][r] = slow_sum
            if obs is not None and obs.auto:
                # the kernel's O(1) gate: recorded since the snapshot
                st["stream_rec_since"][r] = \
                    ob["tel_slow_hist"][r].sum() - ob["fleet_snap"][r].sum()
        if obs is not None:
            ob["fleet_n_on"][r] = n_on
            ob["fleet_cool_until"][r] = cool_until
            ob["fleet_prov_time"][r] = prov
        if tl is not None:
            for k, v in tl.items():
                st[f"tl_{k}"][r] = torch.as_tensor(np.asarray(v))


def sim_engine_ref(balance, cluster, arrival, func, service, u_lb, home,
                   telemetry=None, timeline=None, keep_state=False):
    """Early binding with PS under the balancer ``balance`` (a name of
    :data:`BALANCER_CODES`), with ``telemetry`` (a ``TelemetryCfg``) or
    None and ``timeline`` (a ``TimelineCfg``) or None.  arrival, service,
    u_lb ``[R, N]`` f64; func ``[R, N]`` i32; home ``[R, F]`` i32 → dict of ``resp [R, N]``
    f64 (NaN until completed), ``cold``/``rejected [R, N]`` bool,
    ``worker_of [R, N]`` i32, ``server_time``/``core_time``/``now [R]``
    f64, ``iters [R]`` i64 (advance iterations per replication),
    ``active [R]`` i64 (the active tasks summed over those iterations:
    the slots a scan reads), for a carried-state balancer its final
    state as ``lb_<key>`` (``[R, …]``, the keys of its ``init_state``),
    under a lifecycle the final life state as ``life_<key>`` (see
    :class:`LifePlane`), with telemetry ``tel_<key>`` and under an
    autoscaler ``fleet_<key>`` (see :class:`ObsPlane`), with a timeline
    ``tl_<key>``; with ``keep_state`` also the final slot matrices
    ``remaining``/``task_arr [R, W, S]`` f64, ``task_idx [R, W, S]`` i32
    and the warm pools ``warm [R, W, F]`` i32."""
    balance = balancer_name(balance)
    W, S = int(cluster.n_workers), int(cluster.slots)
    R, N = arrival.shape
    F = home.shape[1]
    dev = arrival.device
    life = life_plane(cluster, R, W, F, dev)
    obs = obs_plane(cluster, telemetry, R, N, W, dev, timeline)
    ws = None
    if timeline is not None:
        tln.validate_timeline(timeline)
        ws = widths(arrival, timeline)
    st = _fresh(balance, R, W, S, F, dev, life, obs, timeline, ws,
                chunk=False)
    out = dict(
        resp=torch.full((R, N), torch.nan, dtype=_F64, device=dev),
        cold=torch.zeros((R, N), dtype=torch.bool, device=dev),
        rejected=torch.zeros((R, N), dtype=torch.bool, device=dev),
        worker_of=torch.full((R, N), -1, dtype=_I32, device=dev))
    _run(balance, cluster, st, life, obs, timeline, arrival, func, service,
         u_lb, home, 0, True, out, N if obs is None else obs.cutoff)
    keys = ["server_time", "core_time", "now", "iters", "active"]
    keys += [k for k in st if k.startswith(("lb_", "life_"))]
    if obs is not None:
        keys += [k for k in obs.returned()]
    if timeline is not None:
        keys += [k for k in st if k.startswith("tl_")]
    if keep_state:
        keys += ["remaining", "task_arr", "task_idx", "warm"]
    out.update({k: st[k] for k in keys})
    return out


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """What every chunk of a stream shares, made once: the balancer, the
    cluster, ``R``, ``F``, the device, the telemetry and timeline configs
    and the life and observation planes' constants (their ``state`` is the
    fresh carry's)."""

    balance: str
    cluster: object
    n_reps: int
    n_functions: int
    device: torch.device
    telemetry: object
    timeline: object
    life: Optional[LifePlane]
    obs: ObsPlane


def chunk_plan(balance, cluster, R: int, F: int, device, telemetry,
               timeline=None) -> ChunkPlan:
    """The plan of a stream of ``R`` replications of ``F`` functions on
    ``device``.  A stream reads its percentiles from the sketches, so the
    observation plane is always on: ``telemetry`` is required."""
    if telemetry is None:
        raise ValueError("sim_engine's chunk mode reads its percentiles "
                         "from the sketches: pass telemetry=TelemetryCfg()")
    if timeline is not None:
        tln.validate_timeline(timeline)
    W = int(cluster.n_workers)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return ChunkPlan(
        balance=balancer_name(balance), cluster=cluster, n_reps=int(R),
        n_functions=int(F), device=dev, telemetry=telemetry,
        timeline=timeline, life=life_plane(cluster, R, W, F, dev),
        obs=obs_plane(cluster, telemetry, R, 0, W, dev, timeline))


def chunk_init(plan: ChunkPlan, window_s=None) -> dict:
    """The fresh carry of a stream: the state of :func:`_fresh` in chunk
    mode, without ``fleet_*`` unless ``TARGET_P99`` runs; ``window_s
    [R]`` (host numbers) are the timeline's widths from the horizon."""
    cl = plan.cluster
    if plan.timeline is not None and window_s is None:
        raise ValueError("a stream with a timeline needs its widths")
    ws = None if window_s is None else np.asarray(
        window_s.cpu() if torch.is_tensor(window_s) else window_s,
        dtype=np.float64)
    st = _fresh(plan.balance, plan.n_reps, int(cl.n_workers),
                int(cl.slots), plan.n_functions, plan.device, plan.life,
                plan.obs, plan.timeline, ws, chunk=True)
    if not plan.obs.auto:
        st = {k: v for k, v in st.items() if not k.startswith("fleet_")}
    return st


def sim_engine_chunk_ref(plan: ChunkPlan, carry, arrival, func, service,
                         u_lb, home, g0: int, drain: bool, cutoff: int,
                         window_s=None):
    """One chunk of a stream: the arrivals ``g0, g0 + 1, …`` (``[R, n]``
    inputs as :func:`sim_engine_ref`'s, any ``n >= 0``) from ``carry``
    (None: a fresh start, the timeline's widths from ``window_s``), then
    the drain if ``drain``.  ``cutoff`` is the horizon's warmup index.
    Returns the new carry (``carry`` is not changed) and the chunk's
    ``rejected``/``cold [R, n]`` bool and ``worker_of [R, n]`` i32."""
    st = chunk_init(plan, window_s) if carry is None else \
        {k: v.clone() for k, v in carry.items()}
    R, n = plan.n_reps, arrival.shape[1]
    dev = plan.device
    out = dict(rejected=torch.zeros((R, n), dtype=torch.bool, device=dev),
               cold=torch.zeros((R, n), dtype=torch.bool, device=dev),
               worker_of=torch.full((R, n), -1, dtype=_I32, device=dev))
    obs = plan.obs
    if not obs.auto:
        # the plane's fleet entries, unused without TARGET_P99
        st.update({k: v.clone() for k, v in obs.state.items()
                   if k.startswith("fleet_")})
    _run(plan.balance, plan.cluster, st, plan.life, obs, plan.timeline,
         arrival, func, service, u_lb, home, int(g0), bool(drain), out,
         int(cutoff))
    if not obs.auto:
        st = {k: v for k, v in st.items() if not k.startswith("fleet_")}
    return st, out
