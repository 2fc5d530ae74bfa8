"""The profiled deck's decode steps' operations, counted from the models'
sizes (an MoE layer: its top-k experts), as a share of what the card's
bf16 peak does in the device time of those steps: the profiler's records
inside the engine's ``run_task``."""

from perfbench import counting

UNIT = "%"
LAYER = "model step"
MOVES = "generated_tokens_per_s"


def read(run):
    if run.trace is None or run.trace.step_busy_s <= 0:
        return None
    flops = 0.0
    for t in run.trace.tasks:
        m = run.models[t.model_id]
        flops += sum(counting.step_flops(m, t.rows, p) for p in range(t.steps))
    if not flops:
        return None
    return 100.0 * flops / (run.trace.step_busy_s * counting.PEAK_FLOPS["bfloat16"])
