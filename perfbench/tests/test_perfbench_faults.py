"""The check catches a broken timed path: a whole run, its look for a card
skipped, on the CPU at reduced sizes, comes out correct, and comes out
not correct with each fault a served cell can have planted under it.
The control (the reference in float8 in the program's place) fails the
limits that the program in bfloat16 meets.

A cell on one card has no exchange between cards: that fault has no
place to be planted here."""

import numpy as np
import pytest
import torch

from perfbench import harness as hb
from perfbench import run as run_py
from perfbench.tests import small

CELLS = [w["name"] for w in hb.spec()["workloads"]]
#: The CPU stand-in's limit on the widest gap, between its two readings:
#: the program in bfloat16 reads at most 0.0070 on seeds 1-3 at these
#: sizes, the float8 control at least 0.0398 on its attention models.
SMALL_GAP = 0.02


def small_run(cell, seed=2**31 + 17, dtype="float32", gap=1e-3):
    bench = hb.spec()
    w = hb.workload(cell, bench)
    cfg = small.small_config(hb.config(w["config"]), dtype)
    tr = small.small_traffic(hb.traffic(w["traffic"]))
    result, rows = run_py.run_cell(bench, w, seed, 0.2, False, "cpu", age=lambda: 0.0, cfg=cfg,
                                   traffic=tr, limits=small.small_limits(cfg, gap))
    return result, rows


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, rows = small_run(cell)
    assert result["correct"], rows
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["metrics"]) == {"request_p95_s", "generated_tokens_per_s", "setup_s"}


def altered_token(monkeypatch):
    """Each task's last token of its first row, altered where the engine
    produces it."""
    from repro_torch.serving.engine import ExecutionEngine

    inner = ExecutionEngine.run_task

    def run_task(self, mid, prompt):
        toks, wall = inner(self, mid, prompt)
        toks = toks.copy()
        toks[0, -1] = (toks[0, -1] + 1) % self.models[mid].cfg.vocab
        return toks, wall
    monkeypatch.setattr(ExecutionEngine, "run_task", run_task)


def state_unchanged(monkeypatch):
    """Each decode step leaves its cache (and position) as it found it."""
    from repro_torch.serving import engine

    inner = engine.decode_step

    def decode_step(params, cache, tokens, cfg, **kw):
        return inner(params, {k: v.clone() for k, v in cache.items()}, tokens, cfg, **kw)
    monkeypatch.setattr(engine, "decode_step", decode_step)


def half_batch(monkeypatch):
    """Only the first half of each task's rows is served; their tokens
    stand in for the rest."""
    from repro_torch.serving.engine import ExecutionEngine

    inner = ExecutionEngine.run_task

    def run_task(self, mid, prompt):
        half = prompt.shape[0] // 2
        toks, wall = inner(self, mid, prompt[:half])
        return np.concatenate([toks, toks[: prompt.shape[0] - half]], axis=0), wall
    monkeypatch.setattr(ExecutionEngine, "run_task", run_task)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered_token, state_unchanged, half_batch],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, rows = small_run(cell)
    assert not result["correct"], rows
    assert result["failed"] == 0
    assert max(v["value"] for k, v in rows.items() if k.startswith("logit_gap")) > 1e-3


def test_failed_request_is_not_correct(monkeypatch):
    from repro_torch.serving.engine import ExecutionEngine

    calls = {"n": 0}
    inner = ExecutionEngine.run_task

    def run_task(self, mid, prompt):
        calls["n"] += 1
        if calls["n"] == 12:  # past the warm-up requests (10 tasks)
            raise RuntimeError("lost")
        return inner(self, mid, prompt)
    monkeypatch.setattr(ExecutionEngine, "run_task", run_task)
    result, rows = small_run(CELLS[0])
    assert result["failed"] == 1 and rows["failed"]["value"] == 1.0
    assert not result["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    """Through the run's own check and verdict (``check_sides``,
    ``passed``): the program in bfloat16 comes out correct on every seed;
    the float8 reference's tokens in the served tokens' place come out not
    correct on every seed."""
    w = hb.workload(cell)
    cfg = small.small_config(hb.config(w["config"]), "bfloat16")
    tr = dict(hb.traffic(w["traffic"]), prompt_lengths=[8, 16], decode_tokens=8)
    limits = dict(small.small_limits(cfg, SMALL_GAP), sample_requests=4)
    for seed in (1, 2, 3):
        dep = hb.Deployment(cfg, tr, seed, "cpu")
        requests = []
        hb.serve_deck(dep, hb.Traffic(tr, cfg, seed), requests)
        sides = hb.check_sides(dep, requests, limits, seed, ("program", "control"))
        assert hb.passed(sides["program"]), sides["program"]
        assert not hb.passed(sides["control"]), sides["control"]
        assert {k: v["limit"] for k, v in sides["control"].items()} == {
            k: v["limit"] for k, v in sides["program"].items()}
