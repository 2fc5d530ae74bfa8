"""The benchmark is driven by data: every configuration, traffic mix,
check and metric that ``BENCHMARK.json`` names is a file of its own,
found by name; a new one is found the same way, with no edit to a file
that is there."""

import dataclasses
import json
import re
import shutil

import pytest

from perfbench import counting, families
from perfbench import harness as hb
from perfbench.tests import small
from perfbench.weights import layout

BENCH = hb.spec()


def test_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "request_p95_s", "generated_tokens_per_s", "setup_s"}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_contract_limits():
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for e in BENCH["configs"]:
        assert one_line(e["why"]) and one_line(e["source"]) and len(e["reduced"]) <= 16
        assert all(NAME.match(r) for r in e["reduced"])
        assert any(w["config"] == e["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert one_line(w["why"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert one_line(m["layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    cfg = hb.config(entry["name"])
    assert f"perfbench/configs/{entry['name']}.json" == entry["file"]
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for d in cfg["dfgs"]:
        hb.build_dfg(d)  # the program takes every pipeline


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_found_by_name(w):
    cfg, tr, lim = hb.config(w["config"]), hb.traffic(w["traffic"]), hb.checks(w["name"])
    gen = hb.Traffic(tr, cfg, seed=2**31 + 5)
    assert len(gen.kinds) == len(cfg["dfgs"]) * len(tr["prompt_lengths"])
    fewest_tasks = min(sum(t["model_id"] is not None for t in d["tasks"]) for d in cfg["dfgs"])
    per_task = tr["rows"] * tr["decode_tokens"]
    assert lim["least_sampled_tokens"] <= lim["sample_requests"] * fewest_tasks * per_task
    names = {m["config"]["name"] for m in cfg["models"]}
    assert set(lim["logit_gap"]) == names
    assert lim["sample_requests"] >= 2


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_readers_found_by_name(kind):
    for entry in BENCH[kind]:
        mod = hb.metric(entry["name"])
        assert callable(mod.read)
        assert mod.UNIT == entry["unit"]
        assert mod.LAYER == entry.get("layer")
        assert mod.MOVES == entry.get("moves")


def test_per_layer_metrics_name_reported_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells and m["moves"] in e2e


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_sizes_are_the_programs(entry):
    """Each model's sizes in the file are the program's registry entry,
    but for the cuts ``reduced`` names and the values the file takes from
    the source where the registry differs (``registry`` holds the
    registry's)."""
    from repro_torch.configs import ARCHS

    cfg = hb.config(entry["name"])
    for m in cfg["models"]:
        sizes = m["config"]
        arch = ARCHS[sizes["name"]]
        ours = hb.model_config(sizes)
        changed = {f.name for f in dataclasses.fields(arch)
                   if getattr(arch, f.name) != getattr(ours, f.name)}
        registry = m.get("registry", {})
        for key in changed:
            if key in registry:
                assert registry[key] == getattr(arch, key)
                continue
            assert f"{sizes['name']}.{key}" in cfg["reduced"]
            assert m["published"][key] == getattr(arch, key)
        assert set(registry) <= changed


def test_new_files_found_without_edits(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a check, a metric and a model
    family added as new files are found by name."""
    bench = tmp_path / "perfbench"
    shutil.copytree(hb.BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shared = small.add_family(bench, hb.config("qwen3moe"))
    cfg = hb.config("trio")
    cfg["name"] = "trio_b"
    (bench / "configs" / "trio_b.json").write_text(json.dumps(cfg))
    tr = dict(hb.traffic("chat"), prompt_lengths=[128])
    (bench / "traffic" / "long.json").write_text(json.dumps(tr))
    (bench / "checks" / "trio_b.long.json").write_text(json.dumps(hb.checks("trio.chat")))
    (bench / "metrics" / "requests.py").write_text(
        'UNIT = "requests"\nLAYER = "client"\nMOVES = "request_p95_s"\n\n\n'
        'def read(run):\n    return len(run.requests) or None\n')
    monkeypatch.setattr(hb, "BENCH", bench)
    monkeypatch.setattr(families, "DIR", bench / "families")
    assert hb.config("trio_b")["name"] == "trio_b"
    assert hb.config("qwen3shared") == shared
    sizes = shared["models"][1]["config"]
    fam = families.of(sizes)
    assert fam is families.load("moe_shared") and fam.__file__ == str(
        bench / "families" / "moe_shared.py")
    assert families.of(hb.config("qwen3moe")["models"][1]["config"]) is None
    assert "layers.moe.shared_wg" in layout(sizes)
    assert counting.step_flops(sizes, 4, 9) == fam.step_flops(sizes, 4, 9)
    assert hb.checks("qwen3shared.chat")["logit_gap"]["qwen3-moe-shared"] == hb.checks(
        "qwen3moe.chat")["logit_gap"]["qwen3-moe-30b-a3b"]
    assert hb.traffic("long")["prompt_lengths"] == [128]
    assert hb.checks("trio_b.long")["sample_requests"] >= 2
    run = hb.Run({}, [hb.Request(0, "describe", 128, 1.0, True)], 1.0, 1.0)
    got = hb.read_metrics(run, [{"name": "requests", "unit": "requests"}])
    assert got == {"requests": {"value": 1.0, "unit": "requests"}}


def test_traffic_decks_hold_the_mix_in_a_seeded_order():
    cfg, tr = hb.config("trio"), hb.traffic("chat")
    a, b = hb.Traffic(tr, cfg, seed=7), hb.Traffic(tr, cfg, seed=7)
    c = hb.Traffic(tr, cfg, seed=8)
    decks_a = [a.deck() for _ in range(4)]
    assert decks_a == [b.deck() for _ in range(4)]
    assert decks_a != [c.deck() for _ in range(4)]
    for deck in decks_a:
        assert sorted(deck) == sorted(a.kinds)
    p = a.prompts(("speculative_serving", 64))
    assert set(p) == {"draft"} and p["draft"].shape == (tr["rows"], 64)
    assert p["draft"].max() < cfg["models"][0]["config"]["vocab"]


def test_chat_lengths_follow_the_published_distribution():
    """The chat mix's lengths: the log-normal's 10-90 % points about the
    published medians, cut 16-fold."""
    tr = hb.traffic("chat")
    assert tr["prompt_lengths"] == [18, 38, 64, 108, 230]
    assert tr["decode_tokens"] == 8
    explicit = hb.resolved(dict(tr, prompt_lengths=[5], decode_tokens=2))
    assert explicit["prompt_lengths"] == [5] and explicit["decode_tokens"] == 2
    given = {k: v for k, v in tr.items()
             if k not in ("prompt_lengths", "decode_tokens", "traced_lengths")}
    half = hb.resolved(dict(given, cut=8))
    assert half["prompt_lengths"] == [35, 75, 128, 215, 459] and half["decode_tokens"] == 16
    assert tr["traced_lengths"] == [38, 64, 108] and half["traced_lengths"] == [75, 128, 215]
    gen = hb.Traffic(tr, hb.config("trio"), seed=2**31 + 9)
    traced = gen.traced_deck()
    assert sorted(traced) == sorted(k for k in gen.kinds if k[1] in (38, 64, 108))


def test_generator_refuses_what_it_cannot_drive():
    cfg, tr = hb.config("trio"), hb.traffic("chat")
    with pytest.raises(ValueError):
        hb.Traffic(dict(tr, loop="open"), cfg, seed=1)
    with pytest.raises(ValueError):
        hb.Traffic(dict(tr, dfg_weights={"nope": 1}), cfg, seed=1)
