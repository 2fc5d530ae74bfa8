"""Milliseconds a request spends in the scheduler's ``plan``, timed by
the harness around the call, summed over the window and divided by the
requests."""

UNIT = "ms"
LAYER = "scheduler"
MOVES = "request_p95_s"


def read(run):
    if not run.timers or not run.requests:
        return None
    return run.timers["plan_s"] / len(run.requests) * 1e3
