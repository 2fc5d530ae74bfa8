"""The bytes the profiled deck's decode steps need (each weight a step
needs once, of an MoE layer the distinct experts its rows are routed to
by the reference's routing of the same tokens; the cache read and
written), as a share of what the card's memory moves in the device time
of those steps: the profiler's records inside the engine's ``run_task``."""

from perfbench import counting

UNIT = "%"
LAYER = "model step"
MOVES = "generated_tokens_per_s"


def read(run):
    if run.trace is None or run.trace.step_busy_s <= 0:
        return None
    total = 0.0
    for t in run.trace.tasks:
        m = run.models[t.model_id]
        if m["arch_type"] == "moe" and t.experts is None:
            return None
        for p in range(t.steps):
            per = None if t.experts is None else [int(e) for e in t.experts[:, p]]
            total += counting.step_bytes(m, t.rows, p, per)
    if not total:
        return None
    return 100.0 * total / (run.trace.step_busy_s * counting.HBM_BYTES_PER_S)
