"""Fixed-bin log-spaced histogram sketch (counterpart of
``repro/telemetry/sketch.py``).

Percentiles accumulated *online*, per completion, inside the engines'
state instead of from a per-task slowdown array at the end.  The update
is one binary search and one increment, and every backend (numpy here,
torch in :mod:`.engine`, the CUDA kernel ``csrc/sim_engine.cu``) puts a
value in the same bin because each searches the same float64 edge array:
the numpy ``logspace`` bits of :func:`hist_edges`, which the card
receives as they are (never recomputed there with ``pow``).

Accuracy contract (documented tolerance): with ``N_BINS`` bins spanning
``[HIST_LO, HIST_HI]`` the bin-width ratio is
``r = (HIST_HI/HIST_LO)**(1/N_BINS)`` and a percentile read off the
sketch (geometric midpoint of the selected bin) is within a factor
``sqrt(r)`` of the true order statistic — ``r ≈ 1.0151`` for the
default 1536 bins over 10 decades, i.e. ≤ **0.76 %** relative error
inside the range, plus rank-interpolation slack vs ``np.percentile``'s
linear interpolation between adjacent order statistics.  The
REPRO-CHECK gate budgets 2 % total.  Values outside the range clamp to
the first/last bin (percentiles there are range-limited, not wrong by
more than the clamp).
"""
from __future__ import annotations

import math

import numpy as np

#: Number of histogram bins (shared by slowdown and latency sketches).
N_BINS = 1536
#: Histogram range (seconds for latency; dimensionless for slowdown).
#: 10 decades cover sub-millisecond services through multi-day backlogs.
HIST_LO = 1e-4
HIST_HI = 1e6

_EDGES: np.ndarray | None = None


def hist_edges() -> np.ndarray:
    """The shared ``[N_BINS + 1]`` float64 log-spaced bin-edge array.

    Computed once in numpy and handed as these bits to the torch engine
    and to the kernel, so bin assignment is the same binary search over
    the same bits everywhere.
    """
    global _EDGES
    if _EDGES is None:
        edges = np.logspace(math.log10(HIST_LO), math.log10(HIST_HI),
                            N_BINS + 1).astype(np.float64)
        edges.setflags(write=False)
        _EDGES = edges
    return _EDGES


def bin_midpoints() -> np.ndarray:
    """The ``[N_BINS]`` geometric midpoints ``sqrt(edges[b] * edges[b +
    1])``, a sketch's percentile read of bin ``b``, in numpy (IEEE
    product and square root).  The torch paths index these bits: torch's
    ``sqrt`` of a float64 CPU tensor is not always the correctly rounded
    root (8 of these 1536 are one ulp off), the card's ``__dsqrt_rn``
    and numpy's are."""
    e = hist_edges()
    return np.sqrt(e[:-1] * e[1:])


def bin_index_np(x, edges: np.ndarray | None = None):
    """Bin of value(s) ``x``: clamped ``searchsorted(edges, x, 'right')-1``.

    :func:`.engine.bin_index` mirrors it (``torch.searchsorted`` with
    ``right=True`` over the same edges).
    """
    if edges is None:
        edges = hist_edges()
    return np.clip(np.searchsorted(edges, x, side="right") - 1,
                   0, N_BINS - 1)


def sketch_percentile(counts: np.ndarray, q: float,
                      edges: np.ndarray | None = None) -> float:
    """Percentile ``q`` (0..100) estimated from histogram ``counts``.

    ``counts`` may carry leading batch axes (e.g. ``[R, B]`` from
    ``simulate_many``); they are summed first, so a batched sketch reads
    as the *pooled* population, as
    :func:`repro_torch.core.metrics.summarize_batch` pools percentiles.
    Returns the geometric midpoint of the bin holding the
    ``ceil(q/100 * total)``-th order statistic; NaN on an empty sketch.
    """
    if edges is None:
        edges = hist_edges()
    counts = np.asarray(counts, dtype=np.int64)
    if counts.ndim > 1:
        counts = counts.sum(axis=tuple(range(counts.ndim - 1)))
    total = int(counts.sum())
    if total == 0:
        return float("nan")
    k = min(max(int(math.ceil(q / 100.0 * total)), 1), total)
    b = int(np.searchsorted(np.cumsum(counts), k, side="left"))
    return float(math.sqrt(edges[b] * edges[b + 1]))


def sketch_count(counts: np.ndarray) -> int:
    """Total observations recorded in a (possibly batched) sketch."""
    return int(np.asarray(counts, dtype=np.int64).sum())
