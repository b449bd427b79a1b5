"""Lifecycle configuration record: the ``ClusterCfg.lifecycle`` field.

Counterpart of ``repro/lifecycle/config.py``, the same record with the
same defaults.  It imports nothing of the port, because
:mod:`repro_torch.core.cluster` embeds it in :class:`ClusterCfg`, and it
holds only hashable primitives.
"""
from __future__ import annotations

from typing import NamedTuple


class LifecycleCfg(NamedTuple):
    """Container-lifecycle knobs.

    ``keepalive`` names a policy of the keep-alive registry
    (:func:`repro_torch.lifecycle.register_keepalive`): ``NONE`` tears
    every executor down at completion, ``FIXED_TTL`` keeps idle executors
    for ``ttl_s`` seconds, ``HYBRID_HIST`` learns per-function pre-warm
    and keep-alive windows from an idle-time histogram (Shahrad et al.,
    ATC'20).  ``ttl_s`` is the ``FIXED_TTL`` window and ``HYBRID_HIST``'s
    fallback and bin unit.  ``max_idle`` caps the idle executors a worker
    keeps (``0``: bounded only by slot pressure).  ``coldstart`` names a
    per-function cold-start latency preset
    (:mod:`repro_torch.lifecycle.coldstart`); ``"scalar"`` keeps the
    single ``ClusterCfg.cold_start_penalty``.

    ``ClusterCfg(lifecycle=None)``, the default, is the model without a
    lifecycle: a warm set that never expires and the scalar penalty.
    """

    keepalive: str = "FIXED_TTL"
    ttl_s: float = 60.0
    max_idle: int = 0
    coldstart: str = "scalar"
