"""Milliseconds of ``ExecutionEngine.run_task`` a decode step: its wall
time summed over the window, over the graph replays the engine counted."""

UNIT = "ms"
LAYER = "execution engine"
MOVES = "generated_tokens_per_s"


def read(run):
    if not run.timers or not run.replays:
        return None
    return run.timers["run_task_s"] / run.replays * 1e3
