"""Seconds from the process's start to the window's first request:
imports, kernel loading (and in a fresh checkout their build), weights,
the cluster, and the warm-up requests that capture every graph."""

UNIT = "s"
LAYER = None
MOVES = None


def read(run):
    return run.setup_s
