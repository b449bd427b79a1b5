"""Digest-keyed cache of parsed traces (counterpart of
``repro/trace/cache.py``).

Real Azure dataset slices are tens of MB of CSV; benchmark sweeps and
CLI runs re-load the same files for every (policy × load × seed) cell.
Parsed :class:`~repro_torch.trace.schema.AzureTrace` objects are memoized
process-wide on the SHA-256 digest of the *file contents* (not paths or
mtimes — a rewritten file re-parses, a renamed copy hits), bounded LRU
so long multi-trace sweeps cannot grow it without limit.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

from .schema import AzureTrace, load_trace

#: Max parsed traces kept resident.  A full 14-day Azure sweep touches
#: 14 day-slices; 16 leaves headroom without letting a directory scan
#: pin hundreds of parsed traces.
TRACE_CACHE_MAX = 16

_TRACE_CACHE: "OrderedDict[tuple, AzureTrace]" = OrderedDict()
_HITS = 0
_MISSES = 0


def file_digest(path: str) -> str:
    """SHA-256 hex digest of a file's bytes (streamed, 1 MiB chunks)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_trace_cached(invocations_csv: str, durations_csv: str, *,
                      allow_missing_durations: bool = False) -> AzureTrace:
    """:func:`repro_torch.trace.schema.load_trace` through the digest
    cache."""
    global _HITS, _MISSES
    key = (file_digest(invocations_csv), file_digest(durations_csv),
           allow_missing_durations)
    trace = _TRACE_CACHE.get(key)
    if trace is not None:
        _HITS += 1
        _TRACE_CACHE.move_to_end(key)
        return trace
    _MISSES += 1
    trace = load_trace(invocations_csv, durations_csv,
                       allow_missing_durations=allow_missing_durations)
    _TRACE_CACHE[key] = trace
    while len(_TRACE_CACHE) > TRACE_CACHE_MAX:
        _TRACE_CACHE.popitem(last=False)
    return trace


def trace_cache_stats() -> dict:
    return {"entries": len(_TRACE_CACHE), "hits": _HITS,
            "misses": _MISSES, "capacity": TRACE_CACHE_MAX}


def clear_trace_cache() -> None:
    global _HITS, _MISSES
    _TRACE_CACHE.clear()
    _HITS = _MISSES = 0
