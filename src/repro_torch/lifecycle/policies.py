"""Built-in keep-alive policies (counterpart of
``repro/lifecycle/policies.py``), batched over the replications.

* ``NONE`` — every executor is torn down at completion (``pre = keep =
  0``): the cold-start upper bound.
* ``FIXED_TTL`` — one idle timeout for every function (``keep =
  cfg.ttl_s``), the OpenWhisk/AWS-style default.
* ``HYBRID_HIST`` — the hybrid histogram policy of Shahrad et al.
  (ATC'20): per-function idle-time histograms choose a pre-warm window
  just below the head of the distribution and a keep-alive window up to
  its tail quantile; a function with fewer than ``HIST_MIN_OBS``
  observed gaps falls back to the fixed TTL.  Its state is ``hist [R, F,
  HIST_BINS]`` and ``n_obs [R, F]``, both f64 counts, and its float
  operations run in the reference's order, so the windows are bit-equal
  to the reference's ``np`` and ``jax`` backends.

Each policy also has the reference's numpy backend (``*_np``, one run on
the host: the oracle's), its state ``hist [F, HIST_BINS]`` and ``n_obs
[F]``, bit-equal to the reference's ``np`` backend.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import BUILTINS, register_keepalive

# HYBRID_HIST: HIST_BINS linear bins spanning HIST_RANGE_TTLS keep-alive
# units (cfg.ttl_s); longer gaps clamp into the last bin
HIST_BINS = 32
HIST_RANGE_TTLS = 4.0
HIST_MIN_OBS = 3
# head and tail quantiles of the idle-time distribution and the margin
# applied to them (ATC'20 §4.2)
HIST_HEAD_Q = 0.05
HIST_TAIL_Q = 0.99
HIST_MARGIN = 0.15

_F64 = torch.float64


def _const(pre_s: float, keep_s: float):
    def make(cfg, n_functions, device):
        pre = torch.full((n_functions,), pre_s, dtype=_F64, device=device)
        keep = torch.full((n_functions,), keep_s, dtype=_F64,
                          device=device)

        def windows(state):
            return pre, keep
        return windows, None
    return make


def _none(cfg, n_functions, device):
    return _const(0.0, 0.0)(cfg, n_functions, device)


def _fixed_ttl(cfg, n_functions, device):
    return _const(0.0, float(cfg.ttl_s))(cfg, n_functions, device)


def hybrid_params(cfg) -> tuple[float, float]:
    """(bin width, fallback keep-alive) in seconds, as the reference
    computes them."""
    bin_s = float(cfg.ttl_s) * HIST_RANGE_TTLS / HIST_BINS
    return bin_s, float(cfg.ttl_s)


def _hybrid_init(cfg, n_reps, n_workers, n_functions, device):
    return {"hist": torch.zeros((n_reps, n_functions, HIST_BINS),
                                dtype=_F64, device=device),
            "n_obs": torch.zeros((n_reps, n_functions), dtype=_F64,
                                 device=device)}


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 if none), as
    ``np.argmax`` of a boolean array."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _hybrid(cfg, n_functions, device):
    bin_s, ttl = hybrid_params(cfg)

    def windows(state):
        hist, n_obs = state["hist"], state["n_obs"]
        cdf = hist.cumsum(dim=-1)     # integer-valued: exact in any order
        # head: the first bin holding HEAD_Q of the mass, pre-warm just
        # below its lower edge; tail: the first holding TAIL_Q, keep
        # through its upper edge, padded by the margin
        head = _first(cdf >= HIST_HEAD_Q * n_obs[..., None])
        tail = _first(cdf >= HIST_TAIL_Q * n_obs[..., None])
        pre = head.to(_F64) * bin_s * (1.0 - HIST_MARGIN)
        end = (tail.to(_F64) + 1.0) * bin_s * (1.0 + HIST_MARGIN)
        learned = n_obs >= HIST_MIN_OBS
        pre = torch.where(learned, pre, 0.0)
        keep = torch.where(learned, end - pre, ttl)
        return pre, keep

    def observe(state, func, gap, mask):
        # IEEE division by a full tensor (a Python or 0-d divisor may be
        # taken as a multiplication by its reciprocal), then the cast to
        # an integer, then the clamp, in the reference's order
        q = gap / torch.full_like(gap, bin_s)
        b = q.to(torch.int64).clamp(max=HIST_BINS - 1).clamp(min=0)
        rows = torch.arange(func.shape[0], device=func.device)
        one = mask.to(_F64)
        hist, n_obs = state["hist"], state["n_obs"]
        hist = hist.index_put((rows, func, b), hist[rows, func, b] + one)
        n_obs = n_obs.index_put((rows, func), n_obs[rows, func] + one)
        return dict(state, hist=hist, n_obs=n_obs)

    return windows, observe


def _const_np(pre_s: float, keep_s: float):
    def make(cfg, n_functions):
        pre = np.full(n_functions, pre_s, dtype=np.float64)
        keep = np.full(n_functions, keep_s, dtype=np.float64)

        def windows(state):
            return pre, keep
        return windows, None
    return make


def _none_np(cfg, n_functions):
    return _const_np(0.0, 0.0)(cfg, n_functions)


def _fixed_ttl_np(cfg, n_functions):
    return _const_np(0.0, float(cfg.ttl_s))(cfg, n_functions)


def _hybrid_init_np(cfg, n_workers, n_functions):
    return {"hist": np.zeros((n_functions, HIST_BINS), dtype=np.float64),
            "n_obs": np.zeros(n_functions, dtype=np.float64)}


def _hybrid_np(cfg, n_functions):
    bin_s, ttl = hybrid_params(cfg)

    def windows(state):
        hist, n_obs = state["hist"], state["n_obs"]
        cdf = np.cumsum(hist, axis=1)
        head = np.argmax(cdf >= HIST_HEAD_Q * n_obs[:, None], axis=1)
        tail = np.argmax(cdf >= HIST_TAIL_Q * n_obs[:, None], axis=1)
        pre = head * bin_s * (1.0 - HIST_MARGIN)
        end = (tail + 1.0) * bin_s * (1.0 + HIST_MARGIN)
        learned = n_obs >= HIST_MIN_OBS
        pre = np.where(learned, pre, 0.0)
        keep = np.where(learned, end - pre, ttl)
        return pre, keep

    def observe(state, func, gap):
        b = min(int(gap / bin_s), HIST_BINS - 1)
        b = max(b, 0)
        hist = state["hist"].copy()
        hist[func, b] += 1.0
        n_obs = state["n_obs"].copy()
        n_obs[func] += 1.0
        return dict(state, hist=hist, n_obs=n_obs)

    return windows, observe


for _name, _doc, _make, _init, _make_np, _init_np in (
        ("NONE", "no keep-alive: executors torn down at completion "
                 "(cold-start upper bound)", _none, None, _none_np, None),
        ("FIXED_TTL", "fixed idle-timeout of cfg.ttl_s seconds for every "
                      "function (OpenWhisk-style)", _fixed_ttl, None,
         _fixed_ttl_np, None),
        ("HYBRID_HIST", "per-function idle-time histogram choosing "
                        "pre-warm + keep-alive windows (Shahrad et al. "
                        "ATC'20)", _hybrid, _hybrid_init, _hybrid_np,
         _hybrid_init_np)):
    BUILTINS[_name] = register_keepalive(
        _name, doc=_doc, make_torch=_make, init_state=_init,
        make_np=_make_np, init_np=_init_np)
