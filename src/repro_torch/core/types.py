"""Core datatypes for the Navigator scheduler.

The paper (§2.1) represents ML applications as acyclic dataflow graphs
(DFGs).  Vertices are ML computations annotated with the ML model object
they depend on (the "diamond box"), expected runtimes and input/output
object sizes.  A triggering event creates a *job instance*; the planning
phase produces an *Activated DFG* (ADFG): a map from task id to worker id
that is piggybacked from task to task and may be dynamically adjusted
(§3.2, §4.3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

GB = 1024.0**3
MB = 1024.0**2

# The SST encoding uses a 64-bit integer bitmap for cache contents, hence
# model ids live in a small id space (paper §3.3 / §5.2: "currently 0..63").
MAX_MODEL_ID = 63


@dataclasses.dataclass(frozen=True)
class MLModel:
    """An ML model object: the cacheable unit managed by the GPU memory
    manager.  ``size_bytes`` is the decompressed in-GPU footprint used for
    cache accounting and fetch-time estimation (``TD_model``)."""

    model_id: int
    name: str
    size_bytes: float

    def __post_init__(self) -> None:
        if not (0 <= self.model_id <= MAX_MODEL_ID):
            raise ValueError(
                f"model_id {self.model_id} outside the 0..{MAX_MODEL_ID} "
                f"SST bitmap id space (paper §5.2)"
            )
        if self.size_bytes < 0:
            raise ValueError("model size must be non-negative")


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """A DFG vertex.

    ``runtime_s`` is the profiled expected execution time R(t) (§4.1); the
    per-worker R(t, w) is derived by the profile repository (workers may
    have a speed factor).  ``model_id`` is None for lightweight host-side
    tasks (e.g. the "aggregate translations" exit vertex) that need no GPU
    model object.
    """

    task_id: str
    runtime_s: float
    model_id: Optional[int] = None
    output_bytes: float = 1.0 * MB
    input_bytes: float = 1.0 * MB  # external input (entry tasks)

    def __post_init__(self) -> None:
        if self.runtime_s < 0:
            raise ValueError("runtime must be non-negative")


class DFG:
    """Directed acyclic dataflow graph G = (V, E).

    Edges are precedence constraints: output of the upstream task becomes
    input of the downstream task (§2.1).  The DFGs a deployment might see
    are small and static and available on all workers (§2.2), so rank
    computation (Eq. 1) is done once and cached in the profile repository.
    """

    def __init__(
        self,
        name: str,
        tasks: Sequence[TaskSpec],
        edges: Sequence[Tuple[str, str]],
    ) -> None:
        self.name = name
        self.tasks: Dict[str, TaskSpec] = {t.task_id: t for t in tasks}
        if len(self.tasks) != len(tasks):
            raise ValueError("duplicate task ids")
        self.edges: List[Tuple[str, str]] = list(edges)
        self.succs: Dict[str, List[str]] = {t: [] for t in self.tasks}
        self.preds: Dict[str, List[str]] = {t: [] for t in self.tasks}
        for u, v in self.edges:
            if u not in self.tasks or v not in self.tasks:
                raise ValueError(f"edge ({u},{v}) references unknown task")
            self.succs[u].append(v)
            self.preds[v].append(u)
        self._topo = self._toposort()

    # -- graph structure ---------------------------------------------------
    def _toposort(self) -> List[str]:
        indeg = {t: len(p) for t, p in self.preds.items()}
        frontier = sorted(t for t, d in indeg.items() if d == 0)
        order: List[str] = []
        while frontier:
            t = frontier.pop(0)
            order.append(t)
            for s in self.succs[t]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
            frontier.sort()
        if len(order) != len(self.tasks):
            raise ValueError(f"DFG {self.name!r} contains a cycle")
        return order

    @property
    def topo_order(self) -> List[str]:
        return list(self._topo)

    @property
    def entry_tasks(self) -> List[str]:
        return [t for t in self._topo if not self.preds[t]]

    @property
    def exit_tasks(self) -> List[str]:
        return [t for t in self._topo if not self.succs[t]]

    def is_join(self, task_id: str) -> bool:
        """Join tasks (>1 predecessor) cannot be moved during dynamic
        adjustment without coordination across predecessors (§4.3)."""
        return len(self.preds[task_id]) > 1

    def model_ids(self) -> List[int]:
        out = sorted(
            {t.model_id for t in self.tasks.values() if t.model_id is not None}
        )
        return out

    # -- lower bound (§6.1) --------------------------------------------------
    def lower_bound_latency(self) -> float:
        """Length of the critical path assuming maximum task parallelism,
        all models cached on GPU and zero data-transfer delay — the (possibly
        unachievable) latency lower bound used by the slowdown factor."""
        finish: Dict[str, float] = {}
        for t in self._topo:
            start = max((finish[p] for p in self.preds[t]), default=0.0)
            finish[t] = start + self.tasks[t].runtime_s
        return max(finish.values()) if finish else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DFG({self.name!r}, |V|={len(self.tasks)}, |E|={len(self.edges)})"


@dataclasses.dataclass
class Job:
    """A job instance: one triggering event for one DFG (§2.1)."""

    job_id: int
    dfg: DFG
    arrival_time: float
    # Actual (sampled) external input size; the profile holds the expected one.
    input_bytes: Optional[float] = None

    def lower_bound(self) -> float:
        return self.dfg.lower_bound_latency()


class ADFG:
    """Activated DFG: the per-job-instance task→worker assignment map
    produced by the planning phase and adjusted at runtime (§3.2)."""

    def __init__(self, job: Job) -> None:
        self.job = job
        self.assignment: Dict[str, int] = {}
        # Planner's estimated finish time per task (used for AT_input, Eq. 3).
        self.planned_ft: Dict[str, float] = {}

    def __getitem__(self, task_id: str) -> int:
        return self.assignment[task_id]

    def __setitem__(self, task_id: str, worker: int) -> None:
        self.assignment[task_id] = worker

    def __contains__(self, task_id: str) -> bool:
        return task_id in self.assignment

    def items(self) -> Iterable[Tuple[str, int]]:
        return self.assignment.items()

    def workers_used(self) -> List[int]:
        return sorted(set(self.assignment.values()))

    def copy(self) -> "ADFG":
        new = ADFG(self.job)
        new.assignment = dict(self.assignment)
        new.planned_ft = dict(self.planned_ft)
        return new


def models_from_specs(
    specs: Mapping[int, Tuple[str, float]]
) -> Dict[int, MLModel]:
    """Helper: {id: (name, size_bytes)} → {id: MLModel}."""
    return {
        mid: MLModel(model_id=mid, name=name, size_bytes=size)
        for mid, (name, size) in specs.items()
    }
