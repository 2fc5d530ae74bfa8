"""Milliseconds a request spends in ``ServingCluster.submit`` outside
``plan`` and the engine's ``run_task``: the state table, the memory
manager, the planes and the bookkeeping, by the harness's timers."""

UNIT = "ms"
LAYER = "cluster front end"
MOVES = "request_p95_s"


def read(run):
    t = run.timers
    if not t or not run.requests:
        return None
    return (t["submit_s"] - t["plan_s"] - t["run_task_s"]) / len(run.requests) * 1e3
