"""Worker selection with the historical call signatures: shims over the
policy table (counterpart of ``repro/core/policies.py``).

* :func:`select_worker_np` — one arrival's numpy selection, given the
  whole ``warm [W, F]`` matrix and a balancer (a ``LoadBalance`` member or
  a name); the numpy backend of :mod:`repro_torch.policy`.
* :func:`make_select_worker_torch` — the counterpart of the reference's
  ``make_select_worker_jax``: the 5-argument closure over the ``torch``
  backend, on ``device`` (``None`` = CUDA).
* :func:`hermes_score_np` — Hermes' lexicographic score (re-exported; the
  kernels' oracle).

Neither shim drives a carried-state balancer (HIKU, DD, SWARM): that
needs its state threaded through, which :func:`repro_torch.policy.
resolve` hands over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.policy import BALANCERS, INIT_STATE, np_select
from repro_torch.policy.balancers import hermes_score_np  # noqa: F401
from repro_torch.policy.registry import check_balancer


def _reject_stateful(balance) -> str:
    """The balancer's name; a named error if it carries state."""
    key = check_balancer(balance)
    if key in INIT_STATE:
        raise ValueError(
            f"balancer {key!r} carries state (init_state registered); "
            f"the stateless compat shims cannot drive it — use "
            f"repro_torch.policy.resolve and thread the state explicitly")
    return key


def select_worker_np(balance, active: np.ndarray, warm: np.ndarray,
                     func: int, func_home: np.ndarray, u: float, cores: int,
                     slots: int, idx: int = 0) -> int:
    """Select a worker with ``balance`` (name or enum); -1 when all full."""
    sel = np_select(_reject_stateful(balance), cores, slots)
    return sel(active, warm[:, func], func, func_home, u, idx)


def make_select_worker_torch(balance, cores: int, slots: int, device=None):
    """Build ``select(active, warm_col, func, func_home, u, idx=0) -> w``
    over the ``torch`` backend on ``device`` (``None`` = CUDA).

    ``active`` and ``warm_col`` are ``[W]`` (``warm_col`` is ``warm[:,
    func]``), ``func_home`` is ``[F]``; the result is a 0-d int32 tensor,
    -1 when every worker is full.  The same contract as the numpy select;
    ``idx`` defaults to 0, which only a balancer that reads it (``RR``)
    notices: pass the arrival index there.
    """
    key = _reject_stateful(balance)
    dev = resolve_device(device)
    make = BALANCERS[key][0]
    by_width = {}

    def select(active, warm_col, func, func_home, u, idx=0):
        active = torch.as_tensor(active, device=dev).to(torch.int32)
        W = int(active.shape[-1])
        if W not in by_width:
            by_width[W] = make(int(cores), int(slots), W, dev)
        warm_col = torch.as_tensor(warm_col, device=dev).to(torch.int32)
        f = torch.as_tensor(func, device=dev).to(torch.int64).reshape(1)
        home = torch.as_tensor(func_home, device=dev).to(torch.int32)
        uu = torch.as_tensor(u, device=dev).to(torch.float64).reshape(1)
        return by_width[W](active.reshape(1, W), warm_col.reshape(1, W), f,
                           home.reshape(1, -1), uu, idx)[0]
    return select
