"""A model family brought as a new file: a configuration that names
``families/<name>.py`` is drawn, served, checked and counted through it,
with no edit to a file the benchmark has.  The family here is the tests'
``moe_shared`` (the built-in ``moe`` with one always-on shared expert),
in a copy of the benchmark, at reduced sizes on the CPU."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from perfbench import counting, families, reference
from perfbench import harness as hb
from perfbench import run as run_py
from perfbench.tests import small
from perfbench.weights import layout

CELL = {"name": "qwen3shared.chat", "config": "qwen3shared", "traffic": "chat", "chips": 1}


@pytest.fixture
def shared(tmp_path, monkeypatch):
    """The configuration ``qwen3shared``, in a copy of the benchmark whose
    files the harness and the family loader read."""
    bench = tmp_path / "perfbench"
    shutil.copytree(hb.BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = small.add_family(bench, hb.config("qwen3moe"))
    monkeypatch.setattr(hb, "BENCH", bench)
    monkeypatch.setattr(families, "DIR", bench / "families")
    return cfg


def moe_sizes(cfg):
    return next(m["config"] for m in cfg["models"] if m["config"]["arch_type"] == "moe")


def built_in(sizes):
    """The same sizes with no family: the built-in ``moe``'s."""
    return {k: v for k, v in sizes.items() if k != "family"}


def served(cfg, seed):
    """A small float32 deployment of ``cfg`` and one deck it served."""
    tr = small.small_traffic(hb.traffic("chat"))
    scfg = small.small_config(cfg)
    dep = hb.Deployment(scfg, tr, seed, "cpu")
    requests = []
    hb.serve_deck(dep, hb.Traffic(tr, scfg, seed), requests)
    assert requests and all(r.ok for r in requests) and hb.malformed(dep, requests) == 0
    return dep, [t for r in requests for t in r.tasks]


def test_no_benchmark_model_names_a_family():
    """Every model of today's configurations runs a built-in family."""
    for entry in hb.spec()["configs"]:
        for m in hb.config(entry["name"])["models"]:
            assert families.of(m["config"]) is None


def test_family_never_reaches_the_program(shared):
    from repro_torch.models import ModelConfig

    sizes = moe_sizes(shared)
    assert "family" not in {f.name for f in dataclasses.fields(ModelConfig)}
    assert hb.model_config(sizes) == hb.model_config(built_in(sizes))
    assert hb.model_config(sizes).n_shared_experts == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_layout_is_the_programs(shared, dtype):
    from repro_torch.models.model import param_spec

    sizes = small.reduced(moe_sizes(shared), dtype)
    assert sizes["name"] == "qwen3-moe-shared-small" and sizes["family"] == "moe_shared"

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", (tuple(v[0]), str(v[1]).replace("torch.", ""), v[2])
    ours = layout(sizes)
    assert dict(flat(param_spec(hb.model_config(sizes)))) == ours
    extra = set(ours) - set(layout(built_in(sizes)))
    assert extra == {f"layers.moe.shared_{k}" for k in ("wg", "wu", "wd")}


def test_family_served_tokens_are_its_references(shared):
    """The program serves the family's model as the family's reference
    chooses, token for token; the built-in ``moe`` reference, which has no
    shared expert, does not."""
    dep, tasks = served(shared, seed=2**31 + 41)
    mid = next(m for m, s in dep.sizes.items() if s.get("family"))
    mine = [t for t in tasks if t.model_id == mid]
    assert mine
    off = 0
    for _, tokens, want, chosen in hb.batches(mine):
        tok, wm = torch.as_tensor(tokens), torch.as_tensor(want)
        logits, _ = reference.forward(dep.sizes[mid], dep.weights[mid].views, tok, wm)
        assert np.array_equal(logits.argmax(-1).numpy(), chosen)
        plain, _ = reference.forward(built_in(dep.sizes[mid]), dep.weights[mid].views, tok, wm)
        off += int((plain.argmax(-1).numpy() != chosen).sum())
    assert off > 0
    got = hb.readings(dep, tasks)
    assert set(got) == set(dep.sizes)
    assert all(r["program"] == 0.0 and r["program_flips"] == 0 for r in got.values())


def test_family_run_is_correct_and_a_fault_is_not(shared, monkeypatch):
    """A whole run of the family's cell, its look for a card skipped, comes
    out correct; with a served token altered, not correct."""
    from repro_torch.serving.engine import ExecutionEngine

    def run():
        cfg = small.small_config(hb.config("qwen3shared"))
        tr = small.small_traffic(hb.traffic("chat"))
        return run_py.run_cell(hb.spec(), CELL, 2**31 + 43, 0.2, False, "cpu",
                               age=lambda: 0.0, cfg=cfg, traffic=tr,
                               limits=small.small_limits(cfg))

    result, rows = run()
    assert result["correct"], rows
    assert "logit_gap.qwen3-moe-shared-small" in rows
    inner = ExecutionEngine.run_task

    def run_task(self, mid, prompt):
        toks, wall = inner(self, mid, prompt)
        toks = toks.copy()
        toks[0, -1] = (toks[0, -1] + 1) % self.models[mid].cfg.vocab
        return toks, wall
    monkeypatch.setattr(ExecutionEngine, "run_task", run_task)
    result, rows = run()
    assert not result["correct"], rows


def test_step_metrics_read_the_familys_counts(shared):
    """``routed_experts`` takes the family's ``experts_read``; ``step_mfu``
    and ``step_hbm_share`` count the family's operations and bytes, which
    exceed the built-in ``moe``'s by the shared expert exactly."""
    dep, tasks = served(shared, seed=2**31 + 47)
    hb.routed_experts(dep, tasks)
    mid = next(m for m, s in dep.sizes.items() if s.get("family"))
    sizes = dep.sizes[mid]
    fam = families.of(sizes)
    for t in tasks:
        if t.model_id != mid:
            assert t.experts is None
            continue
        assert t.experts.shape == (sizes["n_layers"], t.steps)
        assert (t.experts >= sizes["top_k"]).all()
        assert (t.experts <= min(sizes["n_experts"], t.rows * sizes["top_k"])).all()
    run = hb.Run(dep.sizes, [], 1.0, 1.0)
    run.trace = hb.Trace([], [], 1.0, 1.0, 2.0, tasks)
    one = 3 * sizes["d_model"] * sizes["d_ff_expert"]  # one shared expert's weights
    flops = nbytes = 0.0
    family_steps = 0
    for t in tasks:
        m = dep.sizes[t.model_id]
        for p in range(t.steps):
            per = None if t.experts is None else [int(e) for e in t.experts[:, p]]
            flops += counting.step_flops(m, t.rows, p)
            nbytes += counting.step_bytes(m, t.rows, p, per)
            if m is not sizes:
                continue
            family_steps += 1
            assert counting.step_flops(m, t.rows, p) == fam.step_flops(m, t.rows, p)
            assert counting.step_bytes(m, t.rows, p, per) == fam.step_bytes(m, t.rows, p, per)
            assert fam.step_flops(m, t.rows, p) - counting.step_flops(built_in(m), t.rows, p) \
                == 2 * one * t.rows * m["n_layers"]
            assert fam.step_bytes(m, t.rows, p, per) - counting.step_bytes(
                built_in(m), t.rows, p, per) == one * counting.ITEMSIZE[m["dtype"]] * m["n_layers"]
    assert family_steps
    mfu = hb.metric("step_mfu").read(run)
    hbm = hb.metric("step_hbm_share").read(run)
    assert mfu == pytest.approx(100.0 * flops / (2.0 * counting.PEAK_FLOPS["bfloat16"]), rel=1e-12)
    assert hbm == pytest.approx(100.0 * nbytes / (2.0 * counting.HBM_BYTES_PER_S), rel=1e-12)
