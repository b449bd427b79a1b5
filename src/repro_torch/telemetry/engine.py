"""Telemetry plane 1, streaming in-engine metrics: the torch side
(counterpart of ``repro/telemetry/engine.py``).

The batched engine's twins of :mod:`.state`'s numpy updaters.  Each takes
the telemetry state, a dict of ``[R, …]`` tensors (one row per
replication), plus the event's ``[R]`` operands and returns the updated
dict; the engine keeps it under ``tel_<key>`` and merges rows whose
event did not happen (its lockstep masking).  Behind ``if tel_on:``
gates, so an engine without telemetry makes exactly the operations it
made before the plane existed.

* Bins: ``torch.searchsorted(edges, x, right=True) - 1``, clamped, over
  the float64 edges of :func:`.sketch.hist_edges`: the same binary
  search over the same bits as the numpy side and the kernel, so the
  histograms are equal bit for bit.
* The histograms carry one dropped bin (``[R, N_BINS + 1]``): a row
  whose completion is not recorded (warmup, or no completion) adds to
  bin ``N_BINS``, which :func:`result_of` slices off.
* The slowdown is the IEEE f64 division ``response / max(service,
  1e-12)`` of two tensors (``python_number / tensor`` would be a
  reciprocal product in torch).
* Time integrals are ``x + tau * occupancy``, a product and then a sum,
  as the kernel makes them with ``__dmul_rn``/``__dadd_rn``.
"""
from __future__ import annotations

import torch

from .sketch import N_BINS, hist_edges
from .state import TelemetryCfg, TelemetryResult

_F64, _I64 = torch.float64, torch.int64
#: the state's keys, in the order of :class:`.state.TelemetryResult`
KEYS = ("slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict", "n_reject",
        "busy_time", "depth_time", "qlen_time", "decisions")


def init_state(n_reps: int, n_workers: int, device) -> dict:
    """Zeroed ``[R, …]`` state, the twin of ``state.init_np`` (the
    histograms with their dropped bin)."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    R, W = n_reps, n_workers
    return {
        "slow_hist": zeros((R, N_BINS + 1), _I64),
        "lat_hist": zeros((R, N_BINS + 1), _I64),
        "n_cold": zeros(R, _I64), "n_warm": zeros(R, _I64),
        "n_evict": zeros(R, _I64), "n_reject": zeros(R, _I64),
        "busy_time": zeros((R, W), _F64), "depth_time": zeros((R, W), _F64),
        "qlen_time": zeros(R, _F64), "decisions": zeros((R, W), _I64),
    }


def edges_for(device) -> torch.Tensor:
    """The shared bin edges (:func:`.sketch.hist_edges`' bits) on
    ``device``."""
    return torch.tensor(hist_edges(), dtype=_F64, device=device)


def bin_index(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Clamped right-searchsorted bin, the twin of
    ``sketch.bin_index_np``."""
    return (torch.searchsorted(edges, x.contiguous(), right=True) - 1
            ).clamp(0, N_BINS - 1)


def on_place(tel: dict, rows, worker, is_cold, evicted) -> dict:
    """One placement per row (``worker [R]`` valid; the engine keeps the
    rows that placed)."""
    cold = is_cold.to(_I64)
    dec = tel["decisions"]
    return dict(tel, n_cold=tel["n_cold"] + cold,
                n_warm=tel["n_warm"] + (1 - cold),
                n_evict=tel["n_evict"] + evicted.to(_I64),
                decisions=dec.index_put((rows, worker),
                                        dec[rows, worker] + 1))


def on_advance(tel: dict, tau, active, depth, qlen) -> dict:
    """Pre-advance occupancy integrals over ``tau [R]``: ``active``,
    ``depth [R, W]`` (busy flag, running tasks), ``qlen [R]``."""
    t = tau[:, None]
    return dict(tel, busy_time=tel["busy_time"] + t * active.to(_F64),
                depth_time=tel["depth_time"] + t * depth.to(_F64),
                qlen_time=tel["qlen_time"] + tau * qlen.to(_F64))


def on_complete(tel: dict, rows, response, service, arr_idx, completed,
                cutoff: int, edges) -> dict:
    """A (masked) completion per row into both histograms: recorded
    where ``completed`` and ``arr_idx >= cutoff``, else into the dropped
    bin."""
    rec = completed & (arr_idx >= cutoff)
    slow = response / torch.clamp(service, min=1e-12)
    drop = torch.full_like(rec, N_BINS, dtype=_I64)
    slow_bin = torch.where(rec, bin_index(slow, edges), drop)
    lat_bin = torch.where(rec, bin_index(response, edges), drop)
    sh, lh = tel["slow_hist"], tel["lat_hist"]
    return dict(tel,
                slow_hist=sh.index_put((rows, slow_bin),
                                       sh[rows, slow_bin] + 1),
                lat_hist=lh.index_put((rows, lat_bin), lh[rows, lat_bin] + 1))


def on_evict(tel: dict, count) -> dict:
    """Add ``count [R]`` keep-alive budget evictions."""
    return dict(tel, n_evict=tel["n_evict"] + count.to(_I64))


def on_reject(tel: dict, rejected) -> dict:
    return dict(tel, n_reject=tel["n_reject"] + rejected.to(_I64))


def result_of(tel: dict, cfg: TelemetryCfg) -> TelemetryResult:
    """The host-side :class:`TelemetryResult` of a state (the dropped bin
    sliced off), numpy, leading axis ``R``."""
    arrays = {k: tel[k].cpu().numpy() for k in KEYS}
    for k in ("slow_hist", "lat_hist"):
        arrays[k] = arrays[k][:, :N_BINS]
    return TelemetryResult.from_state(arrays, cfg=cfg)
