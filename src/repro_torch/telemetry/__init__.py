"""``repro_torch.telemetry`` — observability (counterpart of
``repro.telemetry``, without its timeline).

Plane 1, in-engine streaming metrics (:mod:`.state`, :mod:`.sketch`; the
torch twins in :mod:`.engine`): opt-in ``TelemetryCfg`` state carried
through the engines: log-spaced slowdown/latency histogram sketches,
cold/warm/evict/reject counters, per-worker busy-time and queue-depth
integrals, balancer decision counts.  The batched engine carries it as
``[R, …]`` tensors, and the fused ``sim_engine`` kernel in its
observation plane.

Plane 2, host-side span tracing (:mod:`.spans`): zero-dependency nested
spans exported as Perfetto-loadable Chrome trace JSON, with an optional
``torch.profiler.record_function`` bridge.

Plane 3, run provenance (:mod:`.manifest`): ``RunManifest``.

The windowed flight recorder (the reference's ``timeline``) is not
ported yet.  :mod:`.engine` (torch) is not imported here; the simulator
imports it.
"""
from .manifest import RunManifest, collect as collect_manifest, \
    wall_split_from_aggregate
from .sketch import (HIST_HI, HIST_LO, N_BINS, bin_index_np, hist_edges,
                     sketch_count, sketch_percentile)
from .spans import (Tracer, configure_tracing, get_tracer, set_tracer,
                    span)
from .state import (TelemetryCfg, TelemetryResult, WarmupMismatchError,
                    init_np, on_advance_np, on_complete_np, on_evict_np,
                    on_place_np, on_reject_np, warmup_cutoff)

__all__ = [
    "N_BINS", "HIST_LO", "HIST_HI", "hist_edges", "bin_index_np",
    "sketch_percentile", "sketch_count",
    "TelemetryCfg", "TelemetryResult", "WarmupMismatchError", "init_np",
    "warmup_cutoff",
    "on_place_np", "on_advance_np", "on_complete_np", "on_evict_np",
    "on_reject_np",
    "Tracer", "configure_tracing", "get_tracer", "set_tracer", "span",
    "RunManifest", "collect_manifest", "wall_split_from_aggregate",
]
