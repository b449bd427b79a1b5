"""Built-in autoscale policies: ``STATIC`` and ``TARGET_P99``
(counterpart of ``repro/fleet/policies.py``).

``STATIC`` keeps the whole fleet active: a ``FleetCfg`` with the
default autoscale is heterogeneity only.

``TARGET_P99`` is the closed loop: grow the active worker set when the
observed p99 slowdown (read from the telemetry sketch window) overshoots,
shrink it when the fleet is over-provisioned, with a hysteresis
dead-band and a cooldown (enforced by the engines) between decisions.
The internal setpoint is ``target_p99 / 2`` (the sensor lags: it reports
an excursion only once it has hurt the tail), and growth is
multiplicative (``n_on += max(1, n_on // 2)``) while shrink is additive
(``-1``): the MIAD asymmetry.

The percentile read follows :func:`repro_torch.telemetry.sketch.
sketch_percentile` op for op (the ``ceil`` rank, the left search of the
cumulative counts, the geometric midpoint), and the band edges come from
:func:`_p99_bounds` in Python, so the numpy and torch decides and the
fused kernel's compare the same bits and take the same integer
decisions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.telemetry.sketch import bin_midpoints, hist_edges

from .config import FleetCfg, STATIC
from .registry import BUILTINS, AUTOSCALERS, register_autoscaler


def _static_np(cfg: FleetCfg, n_workers: int):
    def decide(n_on, window):
        return int(n_on)
    return decide


def _static_torch(cfg: FleetCfg, n_workers: int, device):
    def decide(n_on, window):
        return n_on.to(torch.int32)
    return decide


def _p99_bounds(cfg: FleetCfg) -> tuple[float, float]:
    """The hysteresis band's edges ``(hi, lo)`` around the setpoint
    ``target_p99 / 2``, computed once in Python so that every backend
    compares against the same bits."""
    t = float(cfg.target_p99) * 0.5
    h = float(cfg.hysteresis)
    return t * (1.0 + h), t * (1.0 - h)


def _target_p99_np(cfg: FleetCfg, n_workers: int):
    edges = hist_edges()
    hi, lo = _p99_bounds(cfg)
    min_w = int(cfg.min_workers)

    def decide(n_on, window):
        window = np.asarray(window, dtype=np.int64)
        total = int(window.sum())
        if total < 1:                  # the engines gate on this too
            return int(n_on)
        # sketch_percentile's op sequence (q = 99)
        k = min(max(int(math.ceil(0.99 * total)), 1), total)
        b = int(np.searchsorted(np.cumsum(window), k, side="left"))
        p99 = math.sqrt(float(edges[b]) * float(edges[b + 1]))
        if p99 > hi:                   # MIAD: multiplicative grow
            n_new = int(n_on) + max(1, int(n_on) // 2)
        elif p99 < lo:                 # additive shrink
            n_new = int(n_on) - 1
        else:
            n_new = int(n_on)
        return int(min(max(n_new, min_w), n_workers))
    return decide


def _target_p99_torch(cfg: FleetCfg, n_workers: int, device):
    # the bins' midpoints from numpy: torch's CPU sqrt is not always the
    # correctly rounded root the numpy decide and the kernel take
    mids = torch.tensor(bin_midpoints(), dtype=torch.float64, device=device)
    hi, lo = _p99_bounds(cfg)
    min_w = int(cfg.min_workers)
    last = mids.shape[0] - 1           # the last bin

    def decide(n_on, window):
        window = window.to(torch.int64)
        total = window.sum(dim=-1)                             # [R]
        k = torch.ceil(0.99 * total.to(torch.float64)).to(torch.int64)
        k = torch.minimum(torch.clamp(k, min=1), total.clamp(min=1))
        b = torch.searchsorted(window.cumsum(dim=-1), k[:, None])[:, 0]
        b = b.clamp(max=last)          # an empty window reads past the end
        p99 = mids[b]
        n_i = n_on.to(torch.int32)
        delta = torch.where(p99 > hi, torch.clamp(n_i // 2, min=1),
                            torch.where(p99 < lo, -1, 0).to(torch.int32))
        scaled = torch.clamp(n_i + delta, min_w, n_workers)
        # an empty window takes no decision (the engines gate on it too)
        return torch.where(total > 0, scaled, n_i).to(torch.int32)
    return decide


register_autoscaler(
    STATIC, make_np=_static_np, make_torch=_static_torch,
    needs_telemetry=False,
    doc="fixed fleet: all W workers stay active (no control loop)")
register_autoscaler(
    "TARGET_P99", make_np=_target_p99_np, make_torch=_target_p99_torch,
    doc="keep p99 slowdown under a target ceiling: telemetry-sketch "
        "sensor, half-target setpoint, MIAD grow/shrink, hysteresis "
        "band, engine cooldown")
BUILTINS.update(AUTOSCALERS)
