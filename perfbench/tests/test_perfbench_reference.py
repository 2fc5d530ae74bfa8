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
#: Every model of every configuration ``BENCHMARK.json`` names.
FAMILIES = list(dict.fromkeys(m["config"]["name"] for entry in hb.spec()["configs"]
                              for m in hb.config(entry["name"])["models"]))


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


#: The built-in families' small reference (float32, weights from seed
#: 2**31 + 7, two rows of nine tokens, logits at positions 4-8), pinned to
#: what it read before family files existed: the logits of the first three
#: wanted positions at ids 0-4, the sum of every logit's size, the argmax
#: of each position (its top two lie at least 0.4 % of the largest logit
#: apart) and an MoE model's first layer's experts at the first row's
#: first four positions.
PINNED_LOGITS = {
    "mamba2-780m": dict(
        corner=[[0.0836009755730629, -0.06250635534524918, -0.03745005652308464,
                 -0.18027035892009735, 0.1756591945886612],
                [0.08696647733449936, 0.054065026342868805, 0.023065565153956413,
                 0.02940111979842186, -0.3052063584327698],
                [-0.04607953131198883, 0.21085737645626068, -0.004428524523973465,
                 -0.2577306032180786, -0.29808393120765686]],
        abs_sum=1287.6176875509555, argmax=[501, 445, 442, 305, 148, 330, 303, 84, 456, 50]),
    "mistral-nemo-12b": dict(
        corner=[[0.0397745780646801, -0.04382368549704552, -0.32725948095321655,
                 0.22801899909973145, 0.24823038280010223],
                [-0.1308722347021103, -0.0961969643831253, -0.5416735410690308,
                 0.40650445222854614, 0.029360594227910042],
                [-0.04144768789410591, -0.02940744161605835, -0.6134735345840454,
                 0.2720074951648712, 0.029439210891723633]],
        abs_sum=1276.8307796492372, argmax=[97, 445, 445, 490, 445, 188, 438, 438, 188, 18]),
    "granite-20b": dict(
        corner=[[0.21964670717716217, 0.05084078013896942, -0.11318165808916092,
                 0.2587757110595703, -0.20652997493743896],
                [0.17381349205970764, 0.2947893738746643, -0.1330227106809616,
                 0.40534651279449463, -0.2023615688085556],
                [0.1363821029663086, 0.24915070831775665, 0.01051553525030613,
                 -0.04639117419719696, -0.14571437239646912]],
        abs_sum=1297.4396761149183, argmax=[118, 118, 118, 6, 420, 341, 341, 341, 495, 341]),
    "qwen3-moe-30b-a3b": dict(
        corner=[[0.1916942298412323, 0.0029303806368261576, -0.5259941220283508,
                 0.34342506527900696, 0.14160993695259094],
                [0.1689407080411911, 0.05750521644949913, -0.5009427070617676,
                 0.3823849558830261, -0.026758408173918724],
                [0.06358039379119873, 0.031744588166475296, -0.6637229919433594,
                 0.2927612066268921, 0.011611181311309338]],
        abs_sum=1282.721103067206, argmax=[97, 445, 490, 434, 490, 438, 234, 417, 422, 422],
        routes0=[[2, 1], [3, 2], [0, 3], [2, 3]]),
}


def small_logits(sizes):
    """The small reference's logits and routes of ``sizes`` at
    ``PINNED_LOGITS``'s inputs."""
    w = Weights(sizes, "cpu").fill(2**31 + 7)
    tok = torch.as_tensor(np.random.default_rng(5).integers(0, sizes["vocab"], size=(2, 9)))
    want = torch.zeros(2, 9, dtype=torch.bool)
    want[:, 4:] = True
    return w, tok, want, reference.forward(sizes, w.views, tok, want, routing=True)


@pytest.mark.parametrize("name", sorted(PINNED_LOGITS))
def test_built_in_reference_is_pinned(name):
    pin = PINNED_LOGITS[name]
    _, _, _, (logits, routes) = small_logits(small.reduced(sizes_of(name)))
    scale = float(logits.abs().max())
    assert torch.allclose(logits[:3, :5], torch.tensor(pin["corner"]), rtol=0, atol=1e-5 * scale)
    assert float(logits.double().abs().sum()) == pytest.approx(pin["abs_sum"], rel=1e-6)
    assert logits.argmax(-1).tolist() == pin["argmax"]
    if "routes0" in pin:
        assert routes[0][0, :4].tolist() == pin["routes0"]
    else:
        assert routes == []


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_is_the_programs_forward(name):
    """The program's whole-sequence forward over the benchmark's weights
    and the plain reference (through a family file where the sizes name
    one) agree in float32 on the CPU."""
    from repro_torch.models import ParamTree
    from repro_torch.models.model import forward

    sizes = small.reduced(sizes_of(name))
    w, tok, want, (ref, _) = small_logits(sizes)
    with torch.no_grad():
        logits, _ = forward(ParamTree(w.tree()), {"tokens": tok}, hb.model_config(sizes),
                            moe_dispatch="scan")
    got = logits.float()[want]
    assert torch.allclose(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
