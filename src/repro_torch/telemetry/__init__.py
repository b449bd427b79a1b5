"""``repro_torch.telemetry`` — observability (counterpart of
``repro.telemetry``).

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

Plane 4, the windowed time-series flight recorder (:mod:`.timeline`; the
torch twins in :mod:`.timeline_engine`): an opt-in fixed-``K``-window
``TimelineCfg`` plane carried next to the telemetry state: per-window
arrival/cold/evict/reject counts, coarse slowdown/latency sketches,
busy/queue/provisioned integrals, the active-worker trajectory and a
bounded autoscaler/mode-flip decision log, exported as CSV, OpenMetrics
and Perfetto counter tracks.  The batched engine carries it as ``[R, …]``
tensors, the fused ``sim_engine`` kernel in its timeline plane.

:mod:`.engine` and :mod:`.timeline_engine` (torch) are not imported
here; the simulator imports them.
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
from .timeline import (TimelineCfg, TimelineResult, auto_window_s,
                       coarse_edges, coarse_group, validate_timeline,
                       window_index_np)

__all__ = [
    "N_BINS", "HIST_LO", "HIST_HI", "hist_edges", "bin_index_np",
    "sketch_percentile", "sketch_count",
    "TelemetryCfg", "TelemetryResult", "WarmupMismatchError", "init_np",
    "warmup_cutoff",
    "on_place_np", "on_advance_np", "on_complete_np", "on_evict_np",
    "on_reject_np",
    "TimelineCfg", "TimelineResult", "auto_window_s", "coarse_edges",
    "coarse_group", "validate_timeline", "window_index_np",
    "Tracer", "configure_tracing", "get_tracer", "set_tracer", "span",
    "RunManifest", "collect_manifest", "wall_split_from_aggregate",
]
