"""The plain reference and the seeded weights, held to the program on the
CPU at reduced sizes in float32: the served tokens are the reference's
greedy choices, token for token."""

import numpy as np
import pytest
import torch

from perfbench import harness as hb
from perfbench import reference
from perfbench.tests import small
from perfbench.weights import Weights, layout, model_seed

CELLS = [w["name"] for w in hb.spec()["workloads"]]
FAMILIES = ["mamba2-780m", "mistral-nemo-12b", "granite-20b", "qwen3-moe-30b-a3b"]


def sizes_of(name):
    for entry in hb.spec()["configs"]:
        for m in hb.config(entry["name"])["models"]:
            if m["config"]["name"] == name:
                return m["config"]
    raise KeyError(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_layout_is_the_programs(name):
    from repro_torch.models.model import param_spec

    sizes = small.reduced(sizes_of(name), "bfloat16")
    spec = param_spec(hb.model_config(sizes))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", (tuple(v[0]), str(v[1]).replace("torch.", ""), v[2])
    assert dict(flat(spec)) == layout(sizes)


def test_weights_follow_the_seed():
    sizes = small.reduced(sizes_of("mamba2-780m"))
    a = Weights(sizes, "cpu").fill(11)
    b = Weights(sizes, "cpu").fill(11)
    c = Weights(sizes, "cpu").fill(12)
    for p in a.views:
        assert torch.equal(a.views[p], b.views[p])
        base = a.buffers[a.leaves[p][1]].data_ptr()
        assert (a.views[p].data_ptr() - base) % 512 == 0
    assert not torch.equal(a.views["layers.w_in"], c.views["layers.w_in"])
    assert torch.equal(a.views["layers.d_skip"], torch.ones_like(a.views["layers.d_skip"]))
    assert model_seed(2**33 + 1, 0) != model_seed(2**33 + 1, 1)


def test_ssd_quadratic_form_is_the_recurrence():
    """The reference's SSD (quadratic form) against the step-by-step
    recurrence the decode path runs, in float64."""
    torch.manual_seed(0)
    n, l, h, p, s = 2, 7, 3, 4, 5
    x = torch.randn(n, l, h, p, dtype=torch.float64)
    b, c = torch.randn(n, l, h, s, dtype=torch.float64), torch.randn(n, l, h, s, dtype=torch.float64)
    dt = torch.rand(n, l, h, dtype=torch.float64)
    a = -torch.rand(h, dtype=torch.float64)
    state = torch.zeros(n, h, p, s, dtype=torch.float64)
    want = []
    for t in range(l):
        state = torch.exp(a * dt[:, t])[..., None, None] * state \
            + (dt[:, t, :, None, None] * x[:, t, :, :, None]) * b[:, t, :, None, :]
        want.append(torch.einsum("nhps,nhs->nhp", state, c[:, t]))
    acum = torch.cumsum(a * dt, dim=1)
    seg = acum[:, :, None] - acum[:, None]
    later = torch.ones(l, l, dtype=torch.bool).triu(1)
    decay = torch.exp(seg.masked_fill(later[None, :, :, None], float("-inf")))
    got = torch.einsum("ntsh,nshp->nthp",
                       decay * torch.einsum("nthk,nshk->ntsh", c, b) * dt[:, None], x)
    assert torch.allclose(got, torch.stack(want, 1), atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_are_the_references(cell):
    w = hb.workload(cell)
    cfg = small.small_config(hb.config(w["config"]))
    tr = small.small_traffic(hb.traffic(w["traffic"]))
    dep = hb.Deployment(cfg, tr, seed=2**31 + 99, device="cpu")
    gen = hb.Traffic(tr, cfg, seed=2**31 + 99)
    requests = []
    hb.serve_deck(dep, gen, requests)
    assert all(r.ok for r in requests) and hb.malformed(dep, requests) == 0
    tasks = [t for r in requests for t in r.tasks]
    for mid, sizes in dep.sizes.items():
        mine = [t for t in tasks if t.model_id == mid]
        assert mine
        for _, tokens, want, chosen in hb.batches(mine):
            logits, _ = reference.forward(sizes, dep.weights[mid].views,
                                          torch.as_tensor(tokens), torch.as_tensor(want))
            assert np.array_equal(logits.argmax(-1).numpy(), chosen)
    got = hb.readings(dep, tasks)
    assert set(got) == set(dep.sizes)
    assert all(r["program"] == 0.0 and r["program_flips"] == 0 for r in got.values())


def test_downstream_prompt_is_the_predecessors_outputs():
    w = hb.workload(CELLS[0])
    cfg = small.small_config(hb.config(w["config"]))
    tr = small.small_traffic(hb.traffic(w["traffic"]))
    dep = hb.Deployment(cfg, tr, seed=3, device="cpu")
    gen = hb.Traffic(tr, cfg, seed=3)
    req = dep.submit(("speculative_serving", 5), gen.prompts(("speculative_serving", 5)), 0)
    by = {t.task_id: t for t in req.tasks}
    assert np.array_equal(by["verify"].prompt, by["draft"].served)
    assert np.array_equal(by["refine"].prompt, by["verify"].served)
    assert by["draft"].steps == 5 + tr["decode_tokens"]


def test_routed_experts_count_distinct_experts():
    w = [c for c in hb.spec()["workloads"] if c["config"] == "qwen3moe"][0]
    cfg = small.small_config(hb.config(w["config"]))
    tr = small.small_traffic(hb.traffic(w["traffic"]))
    dep = hb.Deployment(cfg, tr, seed=5, device="cpu")
    gen = hb.Traffic(tr, cfg, seed=5)
    requests = []
    hb.serve_deck(dep, gen, requests)
    tasks = [t for r in requests for t in r.tasks]
    hb.routed_experts(dep, tasks)
    moe = [t for t in tasks if t.model_id == 1]
    assert moe and all(t.experts is None for t in tasks if t.model_id != 1)
    for t in moe:
        sizes = dep.sizes[1]
        assert t.experts.shape == (sizes["n_layers"], t.steps)
        assert (t.experts >= sizes["top_k"]).all() and (
            t.experts <= min(sizes["n_experts"], t.rows * sizes["top_k"])).all()
