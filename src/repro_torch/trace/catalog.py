"""Named trace-replay scenarios, merged into
``repro_torch.core.WORKLOADS`` (counterpart of ``repro/trace/catalog.py``).

Every entry has the standard workload-generator signature
``(cluster, load, n_arrivals, seed) -> Workload`` used throughout the
repo (benchmark sweeps, ``replicate_workload`` grids, ``--workload``
CLI flags), so trace scenarios are drop-in replacements for the
synthetic §6.1 generators — stackable into one
:class:`~repro_torch.core.workload.WorkloadBatch` across loads and
seeds.

Two scenario families:

* ``azure-diurnal`` / ``azure-bursty`` / ``azure-cold-heavy`` /
  ``azure-flash-crowd`` — synthesize an Azure-schema trace on the fly
  (deterministic in ``seed``; sized ~25 % above ``n_arrivals`` so tiling
  is the exception) and replay it at the requested offered load.  The
  same seed yields the same underlying trace at every load, so load
  sweeps use common random numbers and differ only in time compression.
* ``azure-fixture`` — replays the bundled dataset slice under
  ``repro_torch/trace/data/`` (byte-for-byte the reference's) through
  the full CSV → schema → cache → replay path (the exact pipeline a real
  dataset slice takes).

Import-order contract: this module is imported from
``repro_torch/core/__init__.py`` *while that package is still
initializing*, and ``repro_torch.trace.replay`` imports
``repro_torch.core.workload`` — so all ``repro_torch.trace`` /
``repro_torch.core`` imports here live inside the scenario functions,
never at module level.
"""
from __future__ import annotations

import os

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
FIXTURE_INVOCATIONS = os.path.join(DATA_DIR, "azure_fixture_invocations.csv")
FIXTURE_DURATIONS = os.path.join(DATA_DIR, "azure_fixture_durations.csv")

# Replay RNG is decoupled from trace-synthesis RNG so trace shape and
# within-minute jitter vary independently across seeds.
_REPLAY_SEED_OFFSET = 7919


def _synth_scenario(scenario: str):
    def workload_fn(cluster, load, n_arrivals, seed=0):
        from .replay import replay_trace
        from .synth_trace import synthesize_trace
        trace = synthesize_trace(
            scenario, total_invocations=max(int(n_arrivals * 1.25), 64),
            seed=seed)
        return replay_trace(trace, cluster, load=load,
                            n_arrivals=n_arrivals,
                            seed=seed + _REPLAY_SEED_OFFSET,
                            name=f"azure-{scenario}")
    workload_fn.__name__ = f"azure_{scenario.replace('-', '_')}"
    workload_fn.__doc__ = (
        f"Trace replay of the synthetic Azure-schema {scenario!r} "
        f"scenario (see repro_torch.trace.synth_trace).")
    return workload_fn


def azure_fixture(cluster, load, n_arrivals, seed=0):
    """Replay the bundled Azure-schema fixture slice (CSV → cache path)."""
    from .cache import load_trace_cached
    from .replay import replay_trace
    trace = load_trace_cached(FIXTURE_INVOCATIONS, FIXTURE_DURATIONS)
    return replay_trace(trace, cluster, load=load, n_arrivals=n_arrivals,
                        seed=seed + _REPLAY_SEED_OFFSET,
                        name="azure-fixture")


TRACE_SCENARIOS = {
    "azure-diurnal": _synth_scenario("diurnal"),
    "azure-bursty": _synth_scenario("bursty"),
    "azure-cold-heavy": _synth_scenario("cold-heavy"),
    "azure-flash-crowd": _synth_scenario("flash-crowd"),
    "azure-fixture": azure_fixture,
}
