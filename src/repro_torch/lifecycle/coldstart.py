"""Per-function cold-start latency presets.

Counterpart of ``repro/lifecycle/coldstart.py``.  A preset maps a
function count ``F`` to a deterministic vector of cold-start latencies,
in seconds; the engines charge ``cost[f]`` for a cold start of function
``f`` in place of the scalar ``ClusterCfg.cold_start_penalty``.

Each spread is drawn from ``np.random.default_rng(zlib.crc32(name))``,
the reference's seed, so the costs are bit-equal to the reference's in
every process.  The name ``"scalar"`` keeps the single penalty:
:func:`cold_costs_for` returns ``None`` for it.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np

#: name of the pass-through preset (the scalar penalty)
SCALAR = "scalar"


@dataclasses.dataclass(frozen=True)
class ColdStartPreset:
    """A registered cold-start model: ``make(F) -> np.ndarray [F]``, the
    per-function latencies in seconds, deterministic in ``F``."""

    name: str
    doc: str = ""
    make: Callable[[int], np.ndarray] = None


COLD_PRESETS: dict[str, ColdStartPreset] = {}


def register_cold_preset(name: str, make, *, doc: str = "",
                         overwrite: bool = False) -> ColdStartPreset:
    name = name.strip().lower()
    if not name or "/" in name:
        raise ValueError(f"invalid cold-start preset name {name!r}")
    if not overwrite and name in COLD_PRESETS:
        raise ValueError(f"cold-start preset {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    p = ColdStartPreset(name=name, doc=doc, make=make)
    COLD_PRESETS[name] = p
    return p


def cold_preset_names() -> tuple[str, ...]:
    return (SCALAR,) + tuple(COLD_PRESETS)


def get_cold_preset(name) -> ColdStartPreset:
    key = str(name).strip().lower()
    try:
        return COLD_PRESETS[key]
    except KeyError:
        raise ValueError(
            f"unknown cold-start preset {key!r}; registered cold-start "
            f"presets: "
            f"{', '.join(sorted(cold_preset_names()))}") from None


def parse_cold_preset(name: str) -> str:
    """The canonical name of a preset token (``"scalar"`` or a registered
    preset); a named ``ValueError`` listing the presets otherwise."""
    key = str(name).strip().lower()
    if key == SCALAR:
        return SCALAR
    return get_cold_preset(key).name


def cold_costs_for(name: str, n_functions: int):
    """Per-function cold-start costs ``[F]`` f64, or ``None`` for
    ``scalar``."""
    key = str(name).strip().lower()
    if key == SCALAR:
        return None
    return np.asarray(get_cold_preset(key).make(int(n_functions)),
                      dtype=np.float64)


def _spread(name: str, base_s: float, sigma: float):
    """Log-normal per-function spread around the median ``base_s``."""
    def make(F: int) -> np.ndarray:
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        return base_s * np.exp(sigma * rng.standard_normal(F))
    return make


register_cold_preset(
    "paper-sim", lambda F: np.zeros(F),
    doc="the paper's simulator: container start-up not modeled (0 s)")
register_cold_preset(
    "openwhisk", lambda F: np.full(F, 0.5),
    doc="constant 0.5 s spin-up, the paper's OpenWhisk testbed figure")
register_cold_preset(
    "aws-lambda", _spread("aws-lambda", 0.25, 0.6),
    doc="median 0.25 s with per-function log-normal spread (sigma 0.6)")
register_cold_preset(
    "azure-functions", _spread("azure-functions", 0.5, 0.8),
    doc="median 0.5 s with a heavier per-function spread (sigma 0.8)")
