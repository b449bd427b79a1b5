"""Telemetry plane 3, run provenance (counterpart of
``repro/telemetry/manifest.py``).

A :class:`RunManifest` pins down *what produced a report*: git revision,
library versions (torch, its CUDA, numpy), platform and devices (the
CUDA cards' names), the seeds and CLI args in play, the engine counters
and the compile-vs-run wall split derived from the tracer's span
aggregate.

Everything here degrades gracefully: no git checkout, no card, no
tracer: the corresponding fields just read ``None``/empty.
"""
from __future__ import annotations

import dataclasses
import datetime
import platform
import subprocess
import sys
from typing import Any, Mapping


@dataclasses.dataclass
class RunManifest:
    git_sha: str | None
    git_dirty: bool | None
    python: str
    platform: str
    torch_version: str | None
    cuda_version: str | None
    numpy_version: str | None
    devices: list[str]
    started_at: str
    duration_s: float | None = None
    seeds: dict = dataclasses.field(default_factory=dict)
    args: dict = dataclasses.field(default_factory=dict)
    engine_cache: dict = dataclasses.field(default_factory=dict)
    wall_split: dict = dataclasses.field(default_factory=dict)
    #: windowed flight-recorder digest (``TimelineResult.summary()``);
    #: empty when the run had no timeline plane
    timeline: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _git(*argv: str) -> str | None:
    try:
        out = subprocess.run(["git", *argv], capture_output=True,
                             text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else None
    except Exception:
        return None


def collect(seeds: Mapping[str, Any] | None = None,
            args: Mapping[str, Any] | None = None) -> RunManifest:
    """Snapshot provenance at run start; fill timing/cache fields later."""
    torch_version = cuda_version = None
    devices: list[str] = []
    try:
        import torch
        torch_version = torch.__version__
        cuda_version = torch.version.cuda
        if torch.cuda.is_available():
            devices = [torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())]
    except Exception:
        pass
    numpy_version = None
    try:
        import numpy
        numpy_version = numpy.__version__
    except Exception:
        pass
    dirty = _git("status", "--porcelain")
    return RunManifest(
        git_sha=_git("rev-parse", "HEAD"),
        git_dirty=None if dirty is None else bool(dirty),
        python=sys.version.split()[0],
        platform=platform.platform(),
        torch_version=torch_version,
        cuda_version=cuda_version,
        numpy_version=numpy_version,
        devices=devices,
        started_at=datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        seeds=dict(seeds or {}),
        args=dict(args or {}),
    )


def wall_split_from_aggregate(agg: Mapping[str, Mapping[str, Any]]) -> dict:
    """Compile-vs-run wall split from a tracer span aggregate.

    ``engine.build`` spans cover engine construction (and a kernel's
    first build); ``engine.first_run`` covers a first dispatch;
    ``engine.run`` covers steady-state dispatches.
    """
    def _get(name: str) -> tuple[int, float]:
        a = agg.get(name, {})
        return int(a.get("count", 0)), float(a.get("total_s", 0.0))

    n_build, t_build = _get("engine.build")
    n_first, t_first = _get("engine.first_run")
    n_run, t_run = _get("engine.run")
    return {
        "build_s": round(t_build, 6), "builds": n_build,
        "first_run_s": round(t_first, 6), "first_runs": n_first,
        "run_s": round(t_run, 6), "runs": n_run,
        "compile_heavy_s": round(t_build + t_first, 6),
        "steady_state_s": round(t_run, 6),
    }


# ------------------------------------------------------------------
# Peak-memory probes of this process (a horizon run's host budget).
# ------------------------------------------------------------------

def reset_peak_rss() -> bool:
    """Reset this process's peak-RSS high-water mark (Linux only).

    Writes ``"5"`` to ``/proc/self/clear_refs`` so the next
    :func:`peak_rss_mb` read reflects only allocations made after this
    call.  Returns False (and changes nothing) where the proc file is
    unavailable — callers then get the process-lifetime peak, which is
    still a valid *upper bound* for the budget gate.
    """
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def peak_rss_mb() -> float:
    """Peak resident set size in MiB (``VmHWM``; ``ru_maxrss`` fallback)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
