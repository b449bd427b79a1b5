"""Azure-schema trace ingestion and non-stationary replay (counterpart
of ``repro/trace``).

The paper's policy exploration (§3) and Hermes evaluation (§6) are driven
by the 14-day Azure Functions 2019 trace.  This package makes trace-shaped
load a workload source for the port's simulator, with every array
bit-equal to the reference's for the same arguments:

* :mod:`repro_torch.trace.schema` — parsing + validation of the released
  Azure Functions 2019 dataset layout (per-function per-minute invocation
  counts; per-function execution-duration percentiles).
* :mod:`repro_torch.trace.synth_trace` — a deterministic generator that
  *emits* trace files in the Azure schema (diurnal / bursty /
  cold-start-heavy / flash-crowd presets), so the repo is self-contained
  without shipping the 1 GB+ dataset.  A small fixture slice lives under
  ``repro_torch/trace/data/``.
* :mod:`repro_torch.trace.replay` — per-minute-count-exact non-stationary
  arrival reconstruction + Log-normal duration sampling fitted to the
  trace percentiles, emitting :class:`~repro_torch.core.workload.Workload`
  arrays that go straight into ``simulate`` / ``simulate_many``.
* :mod:`repro_torch.trace.catalog` — named scenario registry; merged into
  ``repro_torch.core.WORKLOADS`` (``azure-diurnal``, ``azure-bursty``,
  ...).
* :mod:`repro_torch.trace.cache` — parsed-trace cache keyed by file
  digest.

Generation is numpy on the host, like the synthetic generators of
:mod:`repro_torch.core.workload`; the device enters at ``simulate_many``.

Import-order note: :mod:`repro_torch.core` imports
:mod:`repro_torch.trace.catalog` to merge the scenario registry into
``WORKLOADS``, and :mod:`repro_torch.trace.replay` imports workload
dataclasses from :mod:`repro_torch.core.workload` — so ``catalog`` (and
this ``__init__``) stay import-light and everything heavier is loaded
lazily via PEP 562.
"""
from __future__ import annotations

from .catalog import TRACE_SCENARIOS, DATA_DIR  # noqa: F401  (core-free)

_LAZY = {
    "schema": ".schema",
    "synth_trace": ".synth_trace",
    "replay": ".replay",
    "cache": ".cache",
}

_LAZY_SYMBOLS = {
    "AzureTrace": "schema", "TraceFunction": "schema", "load_trace": "schema",
    "synthesize_trace": "synth_trace", "write_trace_csvs": "synth_trace",
    "SCENARIOS": "synth_trace",
    "replay_trace": "replay", "resample_workloads": "replay",
    "per_minute_counts": "replay", "fit_lognormal_from_percentiles": "replay",
    "load_trace_cached": "cache", "file_digest": "cache",
}

__all__ = ["TRACE_SCENARIOS", "DATA_DIR", "catalog", *_LAZY,
           *_LAZY_SYMBOLS]


def __getattr__(name: str):
    import importlib
    if name in _LAZY:
        return importlib.import_module(_LAZY[name], __name__)
    if name in _LAZY_SYMBOLS:
        mod = importlib.import_module("." + _LAZY_SYMBOLS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
