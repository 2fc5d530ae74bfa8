"""Navigator core, copied from the JAX package so that the port stands
alone: DFG/ADFG types, the profile repository and upward ranks (Eq. 1),
the four schedulers (Navigator, JIT, HEFT, Hash), the GPU memory manager,
the shared state table and its gossip plane, the prefetch plane, the
flight recorder and the health plane.  Everything here is plain Python
and numpy, but ``torch_planner`` (the vectorized Navigator planner, the
counterpart of the reference's ``jax_planner``), which is not imported
here.  The reference's ``TPU_V5E_CLUSTER`` has no copy: it describes a
TPU; ``H100_CLUSTER`` (one HGX H100 node, its link and power read on the
card) takes its place.
"""

from repro_torch.core.healthplane import (
    CalibrationReport,
    HealthConfig,
    HealthEvent,
    HealthMonitor,
    QuantileSketch,
    calibrate,
)
from repro_torch.core.memory import CacheStats, GpuMemoryManager
from repro_torch.core.netmodel import (
    AcceleratorLink,
    ClusterSpec,
    H100_CLUSTER,
    LinkSpec,
    NetworkModel,
    NetworkState,
    Topology,
)
from repro_torch.core.prefetch import (
    PrefetchConfig,
    PrefetchIntent,
    PrefetchPlane,
    PrefetchStats,
)
from repro_torch.core.profiles import (
    FLEETS,
    ProfileRepository,
    RACK_FLEETS,
    WorkerProfile,
    build_fleet,
    fleet,
    rack_topology,
)
from repro_torch.core.scheduler import (
    HEFTScheduler,
    HashScheduler,
    JITScheduler,
    NavigatorConfig,
    NavigatorScheduler,
    SCHEDULERS,
    Scheduler,
    make_scheduler,
)
from repro_torch.core.sst_exchange import GossipConfig, GossipPlane
from repro_torch.core.telemetry import (
    CandidateCost,
    FlightRecorder,
    MetricsRegistry,
    PlacementDecision,
    SimReport,
    TraceConfig,
    validate_schema,
)
from repro_torch.core.state import (
    ALIVE,
    DEAD,
    LeaseConfig,
    SharedStateTable,
    SSTRow,
    SUSPECT,
)
from repro_torch.core.types import ADFG, DFG, GB, Job, MB, MLModel, TaskSpec

__all__ = [
    "ADFG",
    "ALIVE",
    "AcceleratorLink",
    "CacheStats",
    "CalibrationReport",
    "CandidateCost",
    "ClusterSpec",
    "DEAD",
    "DFG",
    "FLEETS",
    "FlightRecorder",
    "GB",
    "GossipConfig",
    "GossipPlane",
    "GpuMemoryManager",
    "H100_CLUSTER",
    "HEFTScheduler",
    "HashScheduler",
    "HealthConfig",
    "HealthEvent",
    "HealthMonitor",
    "JITScheduler",
    "Job",
    "LeaseConfig",
    "LinkSpec",
    "MB",
    "MLModel",
    "MetricsRegistry",
    "NavigatorConfig",
    "NavigatorScheduler",
    "NetworkModel",
    "NetworkState",
    "PlacementDecision",
    "PrefetchConfig",
    "PrefetchIntent",
    "PrefetchPlane",
    "PrefetchStats",
    "ProfileRepository",
    "QuantileSketch",
    "RACK_FLEETS",
    "SCHEDULERS",
    "SSTRow",
    "SUSPECT",
    "Scheduler",
    "SharedStateTable",
    "SimReport",
    "TaskSpec",
    "Topology",
    "TraceConfig",
    "WorkerProfile",
    "build_fleet",
    "calibrate",
    "fleet",
    "make_scheduler",
    "rack_topology",
    "validate_schema",
]
