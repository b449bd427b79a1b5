"""Horizon-scale streaming: :func:`simulate_stream` (counterpart of
``repro/core/streaming.py``).

:func:`simulate_stream` runs the program of
:func:`repro_torch.core.simulator.simulate_many` over fixed-size chunks
of arrivals instead of the whole horizon at once, handing the whole carry
(slot matrices, warm pools, clocks, the balancer's, life, telemetry,
fleet and timeline state) across each chunk boundary:

* no plane of the horizon's length is resident: the per-arrival outputs
  leave with each chunk (and are dropped unless ``collect_outputs``),
  completions read the occupant's function and service from per-slot
  mirrors written at placement, and the metrics accumulate online, the
  percentiles in the telemetry sketches and the means in exact counters
  (``n_done``, ``n_obs``, ``resp_sum``, ``slow_sum``, summed in
  completion order);
* the route is :func:`repro_torch.policy.engine`'s: on the card, E/<B>/PS
  runs the fused ``sim_engine`` kernel in its chunk mode, one launch per
  chunk resuming from the carry the last one left (the drain rides on the
  last chunk's launch); every other policy, and every CPU run, takes the
  batched engine's stream mode;
* each arrival makes the operations the monolithic run makes at it, so
  the final carry and every pooled metric are bit-equal to the monolithic
  engine's for any chunk size (:func:`final_states_equal`, over the planes
  both carry).

Without ``chunk_callback`` or ``collect_outputs`` the fused route enqueues
its chunks with no host sync between them: each chunk's inputs go to the
card from pinned host memory without blocking.

``mesh`` (:func:`repro_torch.launch.mesh.make_rep_mesh`) splits the
replications into contiguous shards, one per device
(:mod:`repro_torch.distribution.sim_shard`); each shard's chunks run on
its device, chunk by chunk in turn, and the results are concatenated.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sim_engine import ops as sim_engine_ops
from repro_torch.policy import engine
from repro_torch.policy.registry import check_balancer, check_engine_backend
from repro_torch.telemetry import engine as tel_engine
from repro_torch.telemetry import timeline_engine as tl_engine
from repro_torch.telemetry.spans import get_tracer
from repro_torch.telemetry.state import (TelemetryCfg, TelemetryResult,
                                         warmup_cutoff)
from repro_torch.telemetry.timeline import (TimelineCfg, TimelineResult,
                                            validate_timeline)

from .cluster import ClusterCfg
from .simulator import (LoopStats, _build_engine, _check_autoscale,
                        _check_stream, _prov_core_s, _tel_of, _tl_of)
from .taxonomy import PolicySpec, parse_policy
from .workload import Workload, WorkloadBatch, stack_workloads

_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64

#: carry planes that only one of the two modes has, left out of the
#: bit-equality contract: the monolithic run's per-arrival planes and
#: queue, the stream's slot mirrors and counters
_MODE_ONLY_PLANES = frozenset({
    "q", "resp", "cold", "rejected", "worker_of",
    "task_fn", "task_svc", "stream_cutoff", "stream_n_done",
    "stream_n_obs", "stream_resp_sum", "stream_slow_sum",
    "stream_rec_since",
})


@dataclasses.dataclass(frozen=True)
class StreamOutput:
    """Results of a chunked streaming run (leading axis ``R``).

    No per-task arrays by default: percentiles come from the telemetry
    sketches, means from the exact online counters.  ``collect_outputs``
    (small horizons) adds the per-arrival ``cold``/``rejected``/``worker``
    planes.
    """

    #: the pooled sketches, counters and integrals
    telemetry: TelemetryResult
    n_done: np.ndarray       # [R] i64, completions over the horizon
    n_observed: np.ndarray   # [R] i64, post-warmup completions
    resp_mean: np.ndarray    # [R] f64, exact mean post-warmup response
    slow_mean: np.ndarray    # [R] f64, exact mean post-warmup slowdown
    server_time: np.ndarray  # [R] f64
    core_time: np.ndarray    # [R] f64
    end_time: np.ndarray     # [R] f64
    prov_core_s: np.ndarray  # [R] f64
    n_arrivals: int
    chunk_size: int
    n_chunks: int
    #: per-arrival planes ([R, N]; None unless ``collect_outputs``)
    cold: np.ndarray | None = None
    rejected: np.ndarray | None = None
    worker: np.ndarray | None = None
    #: the carry after the drain, a dict of ``[R, …]`` tensors (None unless
    #: ``keep_final_state``)
    final_state: dict | None = None
    #: the windowed flight recorder (None unless ``timeline=``): it rides
    #: the carry, so it is the monolithic run's for any chunk size
    timeline: TimelineResult | None = None

    @property
    def n_reps(self) -> int:
        return int(self.n_done.shape[0])


# -- the chunk programs, one per (policy, cluster, chunk, F, R, device) --

_CACHE: collections.OrderedDict = collections.OrderedDict()
_CACHE_CAPACITY = 64
_CACHE_STATS = {"hits": 0, "misses": 0}


def stream_cache_stats() -> dict:
    """Entries and lifetime hits and misses of the chunk-program cache."""
    return dict(entries=len(_CACHE), **_CACHE_STATS)


def clear_stream_cache() -> None:
    _CACHE.clear()
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0


class _Batched:
    """The batched engine's stream mode (every route but the fused one)."""

    def __init__(self, policy, cluster, F, R, dev, backend, telemetry,
                 timeline):
        self.init, self._chunk, self._drain = _build_engine(
            policy, cluster, 0, F, R, dev, backend, telemetry, timeline,
            stream=True)
        self.func_dtype = _I64

    def chunk(self, st, g0, ins, homes, drain, cutoff, stats):
        st, ys = self._chunk(st, g0, *ins, homes, stats)
        return (self._drain(st, stats) if drain else st), ys

    def drain(self, st, cutoff, stats):
        return self._drain(st, stats)


class _Fused:
    """The fused kernel's chunk mode (its plain version on the CPU)."""

    def __init__(self, balance, cluster, F, R, dev, telemetry, timeline):
        self.plan = sim_engine_ops.chunk_plan(balance, cluster, R, F, dev,
                                              telemetry, timeline)
        self.func_dtype = _I32

    def init(self, cutoff, window_s):
        return sim_engine_ops.chunk_init(self.plan, window_s)

    def chunk(self, carry, g0, ins, homes, drain, cutoff, stats):
        carry, ys = sim_engine_ops.sim_engine_chunk(
            self.plan, carry, *ins, homes, g0=g0, drain=drain,
            cutoff=cutoff)
        stats.arrivals += int(ins[0].shape[1])
        return carry, (ys["rejected"], ys["cold"], ys["worker_of"])

    def drain(self, carry, cutoff, stats):
        R = self.plan.n_reps
        dev = self.plan.device
        empty = [torch.empty((R, 0), dtype=dt, device=dev)
                 for dt in (_F64, _I32, _F64, _F64)]
        carry, _ = sim_engine_ops.sim_engine_chunk(
            self.plan, carry, *empty, None, g0=0, drain=True, cutoff=cutoff)
        return carry


def _get_stream_engine(policy, cluster: ClusterCfg, chunk: int,
                       n_functions: int, n_reps: int, device,
                       backend: str, telemetry, timeline=None):
    """The cached chunk program for ``policy`` on ``cluster`` at chunk size
    ``chunk``: ``(engine, fresh)``, ``fresh`` a cache miss.  The key holds
    the chunk size, never the horizon: one program serves any ``N``."""
    if int(chunk) < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk}")
    if isinstance(policy, str):
        policy = parse_policy(policy)
    dev = resolve_device(device)
    key = (str(policy), repr(cluster), int(chunk), int(n_functions),
           int(n_reps), str(dev), backend, repr(telemetry), repr(timeline))
    eng = _CACHE.get(key)
    if eng is not None:
        _CACHE_STATS["hits"] += 1
        _CACHE.move_to_end(key)
        return eng, False
    _CACHE_STATS["misses"] += 1
    with get_tracer().span("engine.build", backend=backend, stream=True,
                           chunk=int(chunk)):
        if engine(policy, dev, backend, cluster) == "sim_engine":
            eng = _Fused(check_balancer(policy.balance), cluster,
                         n_functions, n_reps, dev, telemetry, timeline)
        else:
            eng = _Batched(policy, cluster, n_functions, n_reps, dev,
                           backend, telemetry, timeline)
    _CACHE[key] = eng
    while len(_CACHE) > _CACHE_CAPACITY:
        _CACHE.popitem(last=False)
    return eng, True


# -- the stream itself ---------------------------------------------------

def _host(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _put(x, dtype, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``; to a card from pinned memory, without blocking."""
    t = _host(x, dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class _Run:
    """One shard's stream: its engine, carry and collected outputs."""

    def __init__(self, policy, cluster, wb, k, dev, backend, telemetry,
                 timeline, cutoff):
        self.wb, self.dev, self.cutoff = wb, dev, cutoff
        self.eng, self.fresh = _get_stream_engine(
            policy, cluster, k, wb.n_functions, wb.n_reps, dev, backend,
            telemetry, timeline)
        # the widths from the whole horizon (its last arrival), on the
        # host: the monolithic engines' bits
        ws = None if timeline is None else tl_engine.widths(
            _host(wb.arrival[:, -1:], _F64), timeline).to(dev)
        self.carry = self.eng.init(cutoff, ws)
        self.homes = _put(wb.func_home, _I32, dev)
        self.outs: list = []
        self.stats = LoopStats()

    def chunk(self, sl: slice, drain: bool, collect: bool) -> None:
        wb, dev = self.wb, self.dev
        ins = (_put(wb.arrival[:, sl], _F64, dev),
               _put(wb.func[:, sl], self.eng.func_dtype, dev),
               _put(wb.service[:, sl], _F64, dev),
               _put(wb.u_lb[:, sl], _F64, dev))
        self.carry, ys = self.eng.chunk(self.carry, sl.start, ins,
                                        self.homes, drain, self.cutoff,
                                        self.stats)
        if collect:
            self.outs.append(tuple(y.cpu().numpy() for y in ys))

    def drain(self) -> None:
        self.carry = self.eng.drain(self.carry, self.cutoff, self.stats)


def _concat(states: list) -> dict:
    """One carry from the shards' (on the CPU when they are several)."""
    if len(states) == 1:
        return states[0]
    return {k: torch.cat([s[k].cpu() for s in states]) for k in states[0]}


def simulate_stream(policy: PolicySpec, cluster: ClusterCfg, workloads, *,
                    chunk_size: int, device=None, backend: str = "auto",
                    telemetry: TelemetryCfg | None = None,
                    timeline: TimelineCfg | None = None,
                    collect_outputs: bool = False, mesh=None,
                    keep_final_state: bool = False,
                    chunk_callback: Callable[[int, dict], None]
                    | None = None) -> StreamOutput:
    """Run stacked replications through the chunked engine.

    ``workloads`` is a :class:`Workload`, a sequence of them or a
    :class:`WorkloadBatch`.  Any ``chunk_size >= 1`` gives the monolithic
    engine's bits (a last chunk shorter than the others runs its own
    length).  ``telemetry`` defaults to an enabled :class:`TelemetryCfg`:
    the stream reads its percentiles from the sketches.  ``device=None``
    is CUDA; ``backend`` as in :func:`~repro_torch.core.simulator.
    simulate_many`.  Late binding is refused: its controller queue grows
    with the horizon.

    ``mesh`` (:func:`repro_torch.launch.mesh.make_rep_mesh`) splits the
    replications over its devices (their count must divide ``R``) and
    overrides ``device``.  ``chunk_callback(chunk_idx, carry)`` sees the
    carry after each chunk (before the drain); the next chunk updates the
    fused engine's carry in place, so a callback copies what it keeps.
    """
    _check_stream(policy)
    check_engine_backend(backend)
    if isinstance(policy, str):
        policy = parse_policy(policy)
    if isinstance(workloads, Workload):
        workloads = [workloads]
    wb = workloads if isinstance(workloads, WorkloadBatch) \
        else stack_workloads(workloads)
    if telemetry is None:
        telemetry = TelemetryCfg()
    if timeline is not None:
        validate_timeline(timeline)
    cluster.validate()
    _check_autoscale(policy, cluster, telemetry)
    k = int(chunk_size)
    if k < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    N, R = wb.n, wb.n_reps
    cutoff = warmup_cutoff(N, telemetry)
    if mesh is not None:
        from repro_torch.distribution.sim_shard import shard_reps
        homes = shard_reps(wb.func_home, mesh)   # the named errors
        per = R // len(homes)
        parts = [(h.device, slice(i * per, (i + 1) * per))
                 for i, h in enumerate(homes)]
    else:
        parts = [(resolve_device(device), slice(0, R))]
    runs = [_Run(policy, cluster, wb[sl], k, dev, backend, telemetry,
                 timeline, cutoff) for dev, sl in parts]
    n_chunks = -(-N // k)
    # the drain rides on the last chunk, unless a callback reads the carry
    # between the last chunk and the drain
    drain_last = chunk_callback is None
    with get_tracer().span(
            "engine.first_run" if runs[0].fresh else "engine.run",
            policy=str(policy), backend=backend, n=N, reps=R, chunk=k,
            chunks=n_chunks):
        for c in range(n_chunks):
            sl = slice(c * k, min((c + 1) * k, N))
            last = c == n_chunks - 1
            for run in runs:
                run.chunk(sl, last and drain_last, collect_outputs)
            if chunk_callback is not None:
                chunk_callback(c, _concat([run.carry for run in runs]))
        if not drain_last:
            for run in runs:
                run.drain()
    st = _concat([run.carry for run in runs])
    n_obs = st["stream_n_obs"].cpu().numpy()
    denom = np.maximum(n_obs, 1).astype(np.float64)
    cold = rej = wkr = None
    if collect_outputs:
        planes = [np.concatenate([np.concatenate([run.outs[c][p]
                                                  for c in range(n_chunks)],
                                                 axis=1) for run in runs])
                  for p in range(3)]
        rej, cold, wkr = planes
    tl = None
    if timeline is not None:
        tl = _tl_of(st)
        # the batched engine's planes carry their spare rows
        tl = tl_engine.result_of(tl, timeline) \
            if tl["n_on"].shape[1] > timeline.n_windows \
            else TimelineResult.from_state(
                {k_: v.cpu().numpy() for k_, v in tl.items()}, cfg=timeline)
    return StreamOutput(
        telemetry=tel_engine.result_of(_tel_of(st), telemetry),
        n_done=st["stream_n_done"].cpu().numpy(), n_observed=n_obs,
        resp_mean=st["stream_resp_sum"].cpu().numpy() / denom,
        slow_mean=st["stream_slow_sum"].cpu().numpy() / denom,
        server_time=st["server_time"].cpu().numpy(),
        core_time=st["core_time"].cpu().numpy(),
        end_time=st["now"].cpu().numpy(),
        prov_core_s=_prov_core_s(st, cluster),
        n_arrivals=N, chunk_size=k, n_chunks=n_chunks,
        cold=cold, rejected=rej, worker=wkr,
        final_state=st if keep_final_state else None, timeline=tl)


def monolithic_state(policy: PolicySpec, cluster: ClusterCfg, workloads, *,
                     device=None, backend: str = "auto",
                     telemetry: TelemetryCfg | None = None,
                     timeline: TimelineCfg | None = None) -> dict:
    """The monolithic run's final state on the route a stream of the same
    arguments takes (the fused kernel's with its slot matrices and warm
    pools, or the batched engine's), for :func:`final_states_equal`."""
    if isinstance(policy, str):
        policy = parse_policy(policy)
    if isinstance(workloads, Workload):
        workloads = [workloads]
    wb = workloads if isinstance(workloads, WorkloadBatch) \
        else stack_workloads(workloads)
    if telemetry is None:
        telemetry = TelemetryCfg()
    check_engine_backend(backend)
    dev = resolve_device(device)
    cluster.validate()
    if engine(policy, dev, backend, cluster) == "sim_engine":
        return sim_engine_ops.sim_engine(
            check_balancer(policy.balance), cluster, _put(wb.arrival, _F64, dev),
            _put(wb.func, _I32, dev), _put(wb.service, _F64, dev),
            _put(wb.u_lb, _F64, dev), _put(wb.func_home, _I32, dev),
            telemetry=telemetry, timeline=timeline, keep_state=True)
    run = _build_engine(policy, cluster, wb.n, wb.n_functions, wb.n_reps, dev,
                        backend, telemetry, timeline)
    return run(_put(wb.arrival, _F64, dev), _put(wb.func, _I64, dev),
               _put(wb.service, _F64, dev), _put(wb.u_lb, _F64, dev),
               _put(wb.func_home, _I32, dev), LoopStats())


def final_states_equal(a: dict, b: dict) -> tuple[bool, list[str]]:
    """Bitwise comparison of the carry planes two final states share.

    The planes of :data:`_MODE_ONLY_PLANES` are skipped; every other plane
    (slot matrices, warm pools, clocks and time integrals, the balancer's,
    life, telemetry, fleet and timeline state) must be in both, with the
    same shape, dtype and bits (NaN equals NaN).  Returns ``(ok, the
    names of the planes that differ)``.
    """
    bad: list[str] = []
    for name in sorted(set(a) | set(b)):
        if name in _MODE_ONLY_PLANES:
            continue
        if name not in a or name not in b:
            bad.append(f"{name} (in one state only)")
            continue
        u, v = a[name].cpu().numpy(), b[name].cpu().numpy()
        eq = u.shape == v.shape and u.dtype == v.dtype
        if eq:
            eq = np.array_equal(u, v) or (
                np.issubdtype(u.dtype, np.floating)
                and np.array_equal(u, v, equal_nan=True))
        if not eq:
            bad.append(name)
    return (not bad, bad)
