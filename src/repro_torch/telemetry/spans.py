"""Host-side span tracing, observability plane 2 (counterpart of
``repro/telemetry/spans.py``).

A zero-dependency tracer: nested :meth:`Tracer.span` context managers
record wall-clock intervals (``time.perf_counter`` based) and export
them as Chrome trace-event JSON — load the file at https://ui.perfetto.dev
(or ``chrome://tracing``) to see engine build/compile/dispatch phases,
benchmark figures and serving-platform task lifecycles on one timeline.

Design constraints:

* **Opt-in and near-free when off.**  The process-wide tracer starts
  disabled; a disabled ``span()`` returns a shared no-op context
  manager (no allocation, no clock read), so instrumented hot paths —
  the engine-cache lookup, every ``simulate`` call — cost nothing in
  ordinary runs.
* **Host-side only.**  Spans wrap host code, never a kernel's inside.
  Device-side visibility comes from the optional :mod:`torch.profiler`
  bridge: with ``torch_bridge=True`` every span also opens a
  ``torch.profiler.record_function`` range, so spans show up inside
  PyTorch profiles (and their CUDA timelines) too.
* **Two clock domains.**  ``span()`` measures real wall time;
  :meth:`Tracer.event_at` records *virtual-time* events (the serving
  platform's simulated task lifecycles) under a separate pid so the
  two timelines never interleave confusingly in Perfetto.

Typical use::

    from repro_torch.telemetry import configure_tracing, get_tracer, span

    configure_tracing(True)
    with span("fig2", loads=7):
        ...
    get_tracer().export("experiments/trace_bench.json")
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator

#: pid used for real wall-clock spans in the exported trace.
WALL_PID = 1
#: pid used for virtual-time events (simulated task lifecycles).
VIRTUAL_PID = 2


class Tracer:
    """Collects spans/events; exports Chrome trace-event JSON."""

    def __init__(self, enabled: bool = True, torch_bridge: bool = False):
        self.enabled = enabled
        self.torch_bridge = torch_bridge
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        self._epoch0 = time.time()
        self._depth = 0

    # ------------------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """Record a nested wall-clock span around the ``with`` body."""
        if not self.enabled:
            yield
            return
        bridge = None
        if self.torch_bridge:
            try:
                import torch.profiler
                bridge = torch.profiler.record_function(name)
                bridge.__enter__()
            except Exception:
                bridge = None
        ts = self._now_us()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self._events.append({
                "name": name, "ph": "X", "ts": ts,
                "dur": self._now_us() - ts,
                "pid": WALL_PID, "tid": 0,
                "args": {k: _jsonable(v) for k, v in args.items()},
            })
            if bridge is not None:
                bridge.__exit__(None, None, None)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker on the wall-clock timeline."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "g",
            "pid": WALL_PID, "tid": 0,
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    def event_at(self, name: str, ts_s: float, dur_s: float, *,
                 tid: int = 0, **args: Any) -> None:
        """A retrospective *virtual-time* complete event.

        Used for simulated timelines (e.g. one event per serving-platform
        task: ``ts_s`` = arrival, ``dur_s`` = response time, ``tid`` =
        worker).  Virtual seconds map 1:1 onto trace microseconds×1e6
        under :data:`VIRTUAL_PID`, separate from the wall-clock track.
        """
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "X", "ts": ts_s * 1e6,
            "dur": max(dur_s, 0.0) * 1e6,
            "pid": VIRTUAL_PID, "tid": int(tid),
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    def counter_at(self, name: str, ts_s: float, value: float, *,
                   tid: int = 0) -> None:
        """A *virtual-time* counter sample (Perfetto counter track).

        Used by the timeline exporter to merge per-window metrics into
        the span trace: one ``ph: "C"`` sample per window start renders
        as a stepped counter track under :data:`VIRTUAL_PID`, aligned
        with the serving platform's task events."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "C", "ts": ts_s * 1e6,
            "pid": VIRTUAL_PID, "tid": int(tid),
            "args": {"value": float(value)},
        })

    # ------------------------------------------------------------------
    @property
    def events(self) -> list[dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def aggregate(self) -> dict:
        """``{span name: {"count": n, "total_s": s}}`` over wall spans."""
        agg: dict[str, dict] = {}
        for ev in self._events:
            if ev.get("ph") != "X" or ev.get("pid") != WALL_PID:
                continue
            a = agg.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += ev.get("dur", 0.0) / 1e6
        for a in agg.values():
            a["total_s"] = round(a["total_s"], 6)
        return agg

    def export(self, path: str) -> str:
        """Write Chrome trace-event JSON (Perfetto-loadable)."""
        doc = {
            "traceEvents": self._events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch0": self._epoch0,
                "process_names": {str(WALL_PID): "wall-clock",
                                  str(VIRTUAL_PID): "virtual-time"},
            },
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# --------------------------------------------------------------------------
# Process-wide default tracer (disabled until configured).
# --------------------------------------------------------------------------

_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    old = _TRACER
    _TRACER = tracer
    return old


def configure_tracing(enabled: bool = True, *,
                      torch_bridge: bool = False) -> Tracer:
    """Swap in a fresh process-wide tracer; returns it."""
    tracer = Tracer(enabled=enabled, torch_bridge=torch_bridge)
    set_tracer(tracer)
    return tracer


def span(name: str, **args: Any):
    """Convenience: a span on the process-wide tracer."""
    return _TRACER.span(name, **args)
