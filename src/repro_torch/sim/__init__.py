"""The event-driven cluster simulator, its workloads, churn schedules and
trace files, copied from the JAX package so that the port stands alone."""

from repro_torch.sim.churn import (
    ChurnEvent,
    churn_schedule,
    partition_schedule,
    validate_schedule,
)
from repro_torch.core.telemetry import SimReport, TraceConfig
from repro_torch.sim.engine import JobRecord, SimResult, Simulation
from repro_torch.sim.tracefile import (
    TraceFormatError,
    load_jobs,
    synthesize_poisson_trace,
    trace_task_count,
    write_trace,
)
from repro_torch.sim.workload import (
    arrival_rate_timeline,
    bursty_trace_workload,
    fleet_scaled_rate,
    fleet_workload,
    poisson_workload,
)

__all__ = [
    "ChurnEvent",
    "JobRecord",
    "SimReport",
    "SimResult",
    "Simulation",
    "TraceConfig",
    "TraceFormatError",
    "arrival_rate_timeline",
    "bursty_trace_workload",
    "churn_schedule",
    "fleet_scaled_rate",
    "fleet_workload",
    "load_jobs",
    "partition_schedule",
    "poisson_workload",
    "synthesize_poisson_trace",
    "trace_task_count",
    "validate_schedule",
    "write_trace",
]
