"""The 95th percentile of the latency of every request the window
finished, each timed on the host around ``ServingCluster.submit``."""

UNIT = "s"
LAYER = None
MOVES = None


def read(run):
    from perfbench.harness import p95

    return p95([r.latency_s for r in run.done])
