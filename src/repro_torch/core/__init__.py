"""Navigator core, copied from the JAX package so that the port stands
alone: DFG/ADFG types, the profile repository and upward ranks (Eq. 1),
the four schedulers (Navigator, JIT, HEFT, Hash), the GPU memory manager
and the shared state table.  Everything here is plain Python and numpy.
"""

from repro_torch.core.memory import CacheStats, GpuMemoryManager
from repro_torch.core.netmodel import (
    AcceleratorLink,
    ClusterSpec,
    LinkSpec,
    NetworkModel,
    NetworkState,
    Topology,
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
from repro_torch.core.state import (
    ALIVE,
    DEAD,
    LeaseConfig,
    SharedStateTable,
    SSTRow,
    SUSPECT,
)
from repro_torch.core.telemetry import CandidateCost, PlacementDecision
from repro_torch.core.types import ADFG, DFG, GB, Job, MB, MLModel, TaskSpec

__all__ = [
    "ADFG",
    "ALIVE",
    "AcceleratorLink",
    "CacheStats",
    "CandidateCost",
    "ClusterSpec",
    "DEAD",
    "DFG",
    "FLEETS",
    "GB",
    "GpuMemoryManager",
    "HEFTScheduler",
    "HashScheduler",
    "JITScheduler",
    "Job",
    "LeaseConfig",
    "LinkSpec",
    "MB",
    "MLModel",
    "NavigatorConfig",
    "NavigatorScheduler",
    "NetworkModel",
    "NetworkState",
    "PlacementDecision",
    "ProfileRepository",
    "RACK_FLEETS",
    "SCHEDULERS",
    "SSTRow",
    "SUSPECT",
    "Scheduler",
    "SharedStateTable",
    "TaskSpec",
    "Topology",
    "WorkerProfile",
    "build_fleet",
    "fleet",
    "make_scheduler",
    "rack_topology",
]
