"""Placement provenance records that the schedulers build for each
decision: the per-candidate Eq. 2 cost vector and the decision that picked
from it.  The flight recorder that stores them comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """Per-candidate Eq. 2 cost vector for one placement decision.

    All terms are seconds.  ``total_s`` is the selection cost the argmin
    ran over: ``max(queue_s, input_s) + model_s + runtime_s +
    liveness_s (+ staleness_margin_s where the decision applies one)``.
    ``intent_discount_s`` is how much the prefetch-intent lane shaved
    off the undiscounted model term (0 when inert).
    """

    worker: int
    queue_s: float            # published FT(w) queue-drain estimate (abs)
    input_s: float            # AT_allInputs / data-path term (abs arrival)
    model_s: float            # Eq. 2 TD_model actually charged
    intent_discount_s: float  # fetch seconds saved by the intent lane
    runtime_s: float          # R(t, w)
    liveness_s: float         # membership penalty (inf = DEAD in view)
    total_s: float            # selection cost (argmin input)
    staleness_margin_s: float = 0.0  # hysteresis margin applied (adjust)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (repr(v) if v in (float("inf"),) else v)
                for k, v in d.items()}


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """One planner decision with its full candidate table."""

    t: float
    job_id: int
    task_id: str
    phase: str                # plan | jit | adjust | recovery
    scheduler: str
    reader: int               # worker whose SST replica was read
    chosen: int
    candidates: Tuple[CandidateCost, ...]
    note: str = ""            # e.g. herd-sticky override, hysteresis hold

    def candidate(self, worker: int) -> Optional[CandidateCost]:
        for c in self.candidates:
            if c.worker == worker:
                return c
        return None

    def explain(self) -> str:
        lines = [
            f"[{self.phase}] job {self.job_id} task {self.task_id!r} "
            f"@t={self.t:.6f}s  scheduler={self.scheduler}  "
            f"reader=w{self.reader}  chosen=w{self.chosen}"
            + (f"  ({self.note})" if self.note else "")
        ]
        lines.append(
            "  worker   queue_s   input_s   model_s  -intent_s runtime_s"
            "    live_s   total_s"
        )
        for c in sorted(self.candidates, key=lambda c: c.worker):
            mark = "→" if c.worker == self.chosen else " "
            lines.append(
                f" {mark}w{c.worker:<4d}"
                + "".join(
                    f"{v:>10.4f}" if v != float("inf") else f"{'inf':>10}"
                    for v in (
                        c.queue_s, c.input_s, c.model_s, c.intent_discount_s,
                        c.runtime_s, c.liveness_s, c.total_s,
                    )
                )
            )
        return "\n".join(lines)
