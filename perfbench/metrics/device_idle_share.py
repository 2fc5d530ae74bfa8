"""The share of the profiled deck's wall time in which nothing ran on the
card: one minus the union of its records' intervals over the window."""

UNIT = "%"
LAYER = "device"
MOVES = "generated_tokens_per_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
