"""Telemetry plane 4, the windowed flight recorder: the torch side
(counterpart of ``repro/telemetry/timeline_engine.py``).

The batched engine's twins of :mod:`.timeline`'s numpy updaters.  Each
takes the timeline state, a dict of ``[R, …]`` tensors (one row per
replication), plus the event's ``[R]`` operands and a per-replication
``mask`` (``None``: every row), and returns the updated dict; the engine
keeps it under ``tl_<key>``.  Behind ``if tl_on:`` gates, so an engine
without a timeline makes exactly the operations it made before the plane
existed.

* Window: ``floor(now / window_s)`` as one IEEE f64 division of two
  tensors, floored, clipped to ``[0, K - 1]`` in f64 and only then made an
  integer (the numpy side's exact ``math.floor`` and clip; an integer
  cast first would wrap a huge quotient); window 0 when the width is not
  positive.
* Every per-window plane carries one spare window row ``K`` and the
  event log one spare entry ``E``: a row whose event did not happen (its
  mask is off, or the log is full) writes there, and :func:`result_of`
  slices the spare off.  A clamped index that lands on a real row would
  corrupt it; the spare row never does.
* Coarse bins are the fine bin (:func:`.engine.bin_index`, the edges'
  bits) integer-divided by ``N_BINS // B``; the slowdown is the IEEE
  division ``response / max(service, 1e-12)`` of two tensors.
* Integrals are ``x + tau * occupancy``, a product then a sum, in f64
  (an occupancy cast to f64 first: an int tensor times a Python float
  is f32 in torch).
"""
from __future__ import annotations

import torch

from .engine import bin_index
from .sketch import N_BINS, bin_midpoints
from .timeline import TimelineCfg, TimelineResult

_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64
#: per-window planes ``[R, K + 1, …]`` (the spare row last)
WINDOW_KEYS = ("arrivals", "n_cold", "n_warm", "n_evict", "n_reject",
               "slow_hist", "lat_hist", "busy_time", "qlen_time",
               "prov_core", "n_on")
#: the bounded decision log ``[R, E + 1]`` (the spare entry last)
EVENT_KEYS = ("ev_t", "ev_kind", "ev_val", "ev_p99")


def init_state(n_reps: int, n_workers: int, cfg: TimelineCfg, window_s,
               device) -> dict:
    """Zeroed ``[R, …]`` state, the twin of ``timeline.init_tl_np`` with
    the spare rows; ``window_s [R]`` f64 is each replication's width
    (:func:`.timeline.auto_window_s`)."""
    R, W = n_reps, n_workers
    K, B, E = int(cfg.n_windows), int(cfg.coarse_bins), int(cfg.max_events)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    st = {k: zeros((R, K + 1), _I64)
          for k in ("arrivals", "n_cold", "n_warm", "n_evict", "n_reject")}
    st.update(
        window_s=torch.as_tensor(window_s, dtype=_F64,
                                 device=device).reshape(R).clone(),
        # an empty cluster is low-load: no flip on the first arrival
        mode=torch.ones(R, dtype=_I32, device=device),
        slow_hist=zeros((R, K + 1, B), _I64),
        lat_hist=zeros((R, K + 1, B), _I64),
        busy_time=zeros((R, K + 1, W), _F64),
        qlen_time=zeros((R, K + 1), _F64),
        prov_core=zeros((R, K + 1), _F64),
        n_on=zeros((R, K + 1), _I32),
        ev_t=zeros((R, E + 1), _F64),
        ev_kind=zeros((R, E + 1), _I32),
        ev_val=zeros((R, E + 1), _I32),
        ev_p99=torch.full((R, E + 1), torch.nan, dtype=_F64, device=device),
        ev_count=zeros(R, _I64))
    return st


def window_index(now, window_s, n_windows: int):
    """Twin of ``timeline.window_index_np`` over ``[R]`` tensors."""
    pos = window_s > 0.0
    safe = torch.where(pos, window_s, torch.ones_like(window_s))
    k = torch.floor(now / safe).clamp(0.0, float(n_windows - 1)).to(_I64)
    return torch.where(pos, k, torch.zeros_like(k))


def _k(tl: dict, t, mask=None):
    """Each row's window of ``t [R]``; the spare row ``K`` where ``mask``
    is off."""
    K = tl["arrivals"].shape[1] - 1
    k = window_index(t, tl["window_s"], K)
    return k if mask is None else torch.where(mask, k, K)


def _rows(tl: dict):
    return torch.arange(tl["window_s"].shape[0],
                        device=tl["window_s"].device)


def _add(x, rows, k, v):
    """``x[rows, k] += v`` (each row's own index, so no duplicates)."""
    return x.index_put((rows, k), x[rows, k] + v)


def on_arrival(tl: dict, t, n_on, mask=None) -> dict:
    """Count an arrival; last-write-wins the active-worker level."""
    rows, k = _rows(tl), _k(tl, t, mask)
    n_on = torch.as_tensor(n_on, dtype=_I32,
                           device=k.device).expand(k.shape[0])
    return dict(tl, arrivals=_add(tl["arrivals"], rows, k, 1),
                n_on=tl["n_on"].index_put((rows, k), n_on))


def on_place(tl: dict, t, is_cold, evicted, mask=None) -> dict:
    """One placement per row (accepted arrivals only)."""
    rows, k = _rows(tl), _k(tl, t, mask)
    cold = is_cold.to(_I64)
    return dict(tl, n_cold=_add(tl["n_cold"], rows, k, cold),
                n_warm=_add(tl["n_warm"], rows, k, 1 - cold),
                n_evict=_add(tl["n_evict"], rows, k, evicted.to(_I64)))


def on_advance(tl: dict, t, tau, active, qlen, mask=None) -> dict:
    """Busy (``active [R, W]``, a worker with a task) and queue-length
    (``qlen [R]``) integrals over ``tau [R]``, credited to the window of
    the interval start ``t``."""
    rows, k = _rows(tl), _k(tl, t, mask)
    return dict(
        tl, busy_time=_add(tl["busy_time"], rows, k,
                           tau[:, None] * active.to(_F64)),
        qlen_time=_add(tl["qlen_time"], rows, k, tau * qlen.to(_F64)))


def on_complete(tl: dict, t, response, service, completed, edges) -> dict:
    """A (masked) completion per row into both coarse sketches, in the
    window of the completion time ``t``; every completion, no warmup
    cutoff."""
    group = N_BINS // tl["slow_hist"].shape[2]
    rows, k = _rows(tl), _k(tl, t, completed)
    slow = response / torch.clamp(service, min=1e-12)
    sb = bin_index(slow, edges) // group
    lb = bin_index(response, edges) // group
    sh, lh = tl["slow_hist"], tl["lat_hist"]
    return dict(tl, slow_hist=sh.index_put((rows, k, sb), sh[rows, k, sb] + 1),
                lat_hist=lh.index_put((rows, k, lb), lh[rows, k, lb] + 1))


def on_evict(tl: dict, t, count, mask=None) -> dict:
    """Add ``count [R]`` keep-alive budget evictions."""
    rows, k = _rows(tl), _k(tl, t, mask)
    return dict(tl, n_evict=_add(tl["n_evict"], rows, k, count.to(_I64)))


def on_reject(tl: dict, t, rejected, mask=None) -> dict:
    rows, k = _rows(tl), _k(tl, t, mask)
    return dict(tl, n_reject=_add(tl["n_reject"], rows, k,
                                  rejected.to(_I64)))


def on_prov(tl: dict, t, core_s, mask=None) -> dict:
    """Provisioned core-seconds ``core_s [R]`` over an interval starting
    at ``t``."""
    rows, k = _rows(tl), _k(tl, t, mask)
    return dict(tl, prov_core=_add(tl["prov_core"], rows, k, core_s))


def on_event(tl: dict, record, t, kind: int, val, p99) -> dict:
    """Append to the bounded decision log where ``record [R]`` holds (the
    spare entry ``E`` when not recording or when the log is full); the
    count rises on every recorded event, so truncation stays visible."""
    rows = _rows(tl)
    E = tl["ev_t"].shape[1] - 1
    c = tl["ev_count"]
    idx = torch.where(record & (c < E), c, E)
    n = rows.shape[0]

    def col(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=c.device).expand(n)

    return dict(
        tl, ev_t=tl["ev_t"].index_put((rows, idx), col(t, _F64)),
        ev_kind=tl["ev_kind"].index_put((rows, idx), col(kind, _I32)),
        ev_val=tl["ev_val"].index_put((rows, idx), col(val, _I32)),
        ev_p99=tl["ev_p99"].index_put((rows, idx), col(p99, _F64)),
        ev_count=c + record.to(_I64))


def sensor_p99(window, mids):
    """Twin of ``timeline.sensor_p99_np`` over ``window [R, N_BINS]``:
    the first bin whose cumulative count reaches ``clamp(ceil(0.99 ·
    total), 1, total)`` and its geometric midpoint, read from ``mids``
    (:func:`midpoints_for`).  A row with an empty window (never logged)
    reads the last bin."""
    window = window.to(_I64)
    total = window.sum(dim=1)
    k = torch.ceil(0.99 * total.to(_F64)).to(_I64)
    k = torch.minimum(torch.clamp(k, min=1), torch.clamp(total, min=1))
    b = torch.searchsorted(window.cumsum(dim=1), k[:, None], right=False)
    return mids[b[:, 0].clamp(max=N_BINS - 1)]


def midpoints_for(device) -> torch.Tensor:
    """The bins' midpoints (:func:`.sketch.bin_midpoints`' numpy bits) on
    ``device``: torch's CPU ``sqrt`` is not always correctly rounded."""
    return torch.tensor(bin_midpoints(), dtype=_F64, device=device)


def result_of(tl: dict, cfg: TimelineCfg) -> TimelineResult:
    """The host-side :class:`TimelineResult` of a state (the spare rows
    sliced off), numpy, leading axis ``R``."""
    out = {}
    for key, v in tl.items():
        if key in WINDOW_KEYS or key in EVENT_KEYS:
            v = v[:, :-1]
        out[key] = v
    return TimelineResult.from_state(out, cfg=cfg)


def widths(arrival: torch.Tensor, cfg: TimelineCfg) -> torch.Tensor:
    """Each replication's window width ``[R]`` f64 from ``arrival [R,
    N]``: the configured one, or the last arrival over ``K``, one IEEE
    f64 division of two tensors (:func:`.timeline.auto_window_s`'s
    bits)."""
    R = arrival.shape[0]
    if float(cfg.window_s) > 0.0:
        return torch.full((R,), float(cfg.window_s), dtype=_F64,
                          device=arrival.device)
    # a full [R] divisor: torch's CUDA division by a CPU scalar is a
    # product with its reciprocal
    k = torch.full((R,), float(int(cfg.n_windows)), dtype=_F64,
                   device=arrival.device)
    return arrival[:, -1].to(_F64) / k
