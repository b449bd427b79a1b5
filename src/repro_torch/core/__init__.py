"""Core of the port: cluster, policy taxonomy, workloads, metrics.

The engine lives in :mod:`repro_torch.core.simulator` (imported on its
own, as in the reference).  ``WORKLOADS`` holds the synthetic §6.1
generators and the trace-replay scenarios of
:mod:`repro_torch.trace.catalog`.
"""
from .cluster import ClusterCfg, PAPER_LARGE, PAPER_SMALL, PAPER_TESTBED
from ..fleet.config import FleetCfg
from ..lifecycle.config import LifecycleCfg
from .metrics import (BatchSummary, Stat, Summary, summarize,
                      summarize_batch, summarize_batch_sim, summarize_sim)
from .taxonomy import (Binding, LoadBalance, PolicySpec, WorkerSched,
                       parse_policy, FIG2_POLICIES, EVAL_POLICIES, HERMES,
                       LATE_BINDING, E_LL_PS, E_LL_FCFS, E_LL_SRPT, E_LOC_PS,
                       E_LOC_FCFS, E_R_PS, E_R_FCFS, E_JSQ2_PS, E_RR_PS,
                       E_HIKU_PS, E_DD_PS, E_SWARM_PS, ZOO_POLICIES)
from .workload import (AZURE_MU, AZURE_SIGMA, WORKLOADS, Workload,
                       WorkloadBatch, bimodal_exec, homogeneous_exec,
                       lognormal_mean, ms_representative, ms_trace,
                       multi_balanced, replicate_workload, single_function,
                       stack_workloads, synth_workload, validate_workload)

# Trace-replay scenarios (repro_torch.trace) join the synthetic generators.
# catalog imports nothing of repro_torch.core at module level, so this
# cannot cycle.
from ..trace.catalog import TRACE_SCENARIOS
WORKLOADS.update(TRACE_SCENARIOS)

__all__ = [
    "ClusterCfg", "FleetCfg", "LifecycleCfg", "PAPER_LARGE", "PAPER_SMALL",
    "PAPER_TESTBED",
    "BatchSummary", "Stat", "Summary", "summarize", "summarize_batch",
    "summarize_batch_sim", "summarize_sim",
    "Binding", "LoadBalance", "PolicySpec", "WorkerSched", "parse_policy",
    "FIG2_POLICIES", "EVAL_POLICIES", "HERMES", "LATE_BINDING", "E_LL_PS",
    "E_LL_FCFS", "E_LL_SRPT", "E_LOC_PS", "E_LOC_FCFS", "E_R_PS", "E_R_FCFS",
    "E_JSQ2_PS", "E_RR_PS", "E_HIKU_PS", "E_DD_PS", "E_SWARM_PS",
    "ZOO_POLICIES",
    "AZURE_MU", "AZURE_SIGMA", "WORKLOADS", "Workload", "WorkloadBatch",
    "bimodal_exec", "homogeneous_exec", "lognormal_mean",
    "ms_representative", "ms_trace", "multi_balanced", "replicate_workload",
    "single_function", "stack_workloads", "synth_workload",
    "validate_workload",
]
