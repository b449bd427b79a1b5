"""Taxonomy of serverless scheduling policies (paper §3.1).

Counterpart of ``repro/core/taxonomy.py``.  A policy is a triple
``T/LB/S`` of registry names: binding time (``E`` early / ``L`` late),
load balancer (``LOC``, ``R``, ``LL``, ``H`` and the zoo names) and
intra-worker scheduler (``PS``, ``FCFS``, ``SRPT``).  The enums are typed
aliases whose values ARE the names, so specs built from enums or plain
strings compare and hash equal.
"""
from __future__ import annotations

import enum
from typing import NamedTuple


class Binding(str, enum.Enum):
    EARLY = "E"
    LATE = "L"


class LoadBalance(str, enum.Enum):
    LOCALITY = "LOC"      # OpenWhisk-style sticky hashing (LOC)
    RANDOM = "R"          # uniform over workers with free capacity (R)
    LEAST_LOADED = "LL"   # join-shortest-queue by active invocations (LL)
    HYBRID = "H"          # Hermes (H): pack at low load, LL at high load


class WorkerSched(str, enum.Enum):
    PS = "PS"      # processor sharing: each active task gets min(1, C/n)
    FCFS = "FCFS"  # first C tasks in arrival order run at rate 1
    SRPT = "SRPT"  # C tasks with smallest remaining work run at rate 1


def _value(x) -> str:
    return x.value if isinstance(x, enum.Enum) else str(x)


class PolicySpec(NamedTuple):
    """A policy as a triple of registry names (or their enum aliases)."""

    binding: str
    balance: str
    sched: str

    @property
    def name(self) -> str:
        return f"{_value(self.binding)}/{_value(self.balance)}/" \
               f"{_value(self.sched)}"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


_BINDING_ENUM = {b.value: b for b in Binding}
_LB_ENUM = {lb.value: lb for lb in LoadBalance}
_S_ENUM = {s.value: s for s in WorkerSched}


def parse_policy(text: str) -> PolicySpec:
    """Parse ``"E/LL/PS"``-style notation into a :class:`PolicySpec`.

    Every name the reference registers parses, ported or not (resolving
    an unported balancer raises later, in
    :func:`repro_torch.policy.resolve`).  ``"L/*/*"`` is an alias of
    ``"L/LL/FCFS"``.
    """
    from repro_torch.policy.registry import (check_balancer, check_binding,
                                             check_sched)

    parts = text.strip().upper().split("/")
    if len(parts) != 3:
        raise ValueError(f"policy {text!r} is not of the form T/LB/S "
                         f"(e.g. 'E/LL/PS')")
    t, lb, s = parts
    late = check_binding(t)
    if late and (lb == "*" or s == "*"):
        return LATE_BINDING
    check_balancer(lb)
    check_sched(s)
    return PolicySpec(_BINDING_ENUM.get(t, t), _LB_ENUM.get(lb, lb),
                      _S_ENUM.get(s, s))


LATE_BINDING = PolicySpec(Binding.LATE, LoadBalance.LEAST_LOADED,
                          WorkerSched.FCFS)
E_LL_PS = PolicySpec(Binding.EARLY, LoadBalance.LEAST_LOADED, WorkerSched.PS)
E_LL_FCFS = PolicySpec(Binding.EARLY, LoadBalance.LEAST_LOADED,
                       WorkerSched.FCFS)
E_LOC_PS = PolicySpec(Binding.EARLY, LoadBalance.LOCALITY,
                      WorkerSched.PS)           # vanilla OpenWhisk
E_LOC_FCFS = PolicySpec(Binding.EARLY, LoadBalance.LOCALITY,
                        WorkerSched.FCFS)
E_R_PS = PolicySpec(Binding.EARLY, LoadBalance.RANDOM, WorkerSched.PS)
E_R_FCFS = PolicySpec(Binding.EARLY, LoadBalance.RANDOM, WorkerSched.FCFS)
E_LL_SRPT = PolicySpec(Binding.EARLY, LoadBalance.LEAST_LOADED,
                       WorkerSched.SRPT)
HERMES = PolicySpec(Binding.EARLY, LoadBalance.HYBRID, WorkerSched.PS)

FIG2_POLICIES = (
    LATE_BINDING, E_LL_FCFS, E_LL_PS, E_LOC_FCFS, E_LOC_PS, E_R_FCFS, E_R_PS,
)
EVAL_POLICIES = (E_LOC_PS, LATE_BINDING, E_LL_PS, HERMES)  # paper §6 baselines

# The policy zoo (registry balancers beyond the paper), swept by fig11.
# HIKU, DD and SWARM carry balancer state through the engines
# (repro_torch.policy.balancers).
E_JSQ2_PS = PolicySpec(Binding.EARLY, "JSQ2", WorkerSched.PS)
E_RR_PS = PolicySpec(Binding.EARLY, "RR", WorkerSched.PS)
E_HIKU_PS = PolicySpec(Binding.EARLY, "HIKU", WorkerSched.PS)
E_DD_PS = PolicySpec(Binding.EARLY, "DD", WorkerSched.PS)
E_SWARM_PS = PolicySpec(Binding.EARLY, "SWARM", WorkerSched.PS)
ZOO_POLICIES = (E_R_PS, E_RR_PS, E_JSQ2_PS, E_HIKU_PS, E_DD_PS,
                E_SWARM_PS, E_LL_PS, HERMES)
