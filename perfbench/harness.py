"""The benchmark's harness: one cell of ``BENCHMARK.json``, run once.

Everything a cell is made of is found by name: its configuration in
``configs/<config>.json`` (the hosted models' sizes, the pipelines, the
emulated cluster), its traffic in ``traffic/<traffic>.json`` (one general
generator reads it), the limits of its check in ``checks/<cell>.json``,
each metric's reader in ``metrics/<metric>.py``, and the weights' layout,
plain reference and step counts of a model whose sizes name a
``family`` in ``families/<family>.py``.

A run: the weights are drawn on the device from the seed; the program's
``ServingCluster`` is built over them; one warm-up request of every
(pipeline, prompt length) the traffic sends captures every CUDA graph the
window replays; then one closed-loop client submits whole decks of
requests (every kind the mix holds, in an order drawn from the seed)
until the window's seconds have passed, each timed on the host around
``submit``.  With tracing on, the scheduler's ``plan`` and the engine's
``run_task`` are timed too, and one more deck runs under the profiler.
The check then compares what the window served with the plain reference.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from perfbench import families

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Top-level modules the process may not hold once the window has closed.
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
#: Sequences the reference runs at once: a block's activations and
#: logits stay a few GB at the served widths.
BLOCK_ROWS = 64


# -- the files a cell is made of ----------------------------------------------------
def load_json(path: Path) -> Any:
    return json.loads(path.read_text())


def spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: Optional[Mapping] = None) -> Dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    """The mix ``traffic/<name>.json``, its lengths resolved."""
    return resolved(load_json(BENCH / "traffic" / f"{name}.json"))


def resolved(tr: Mapping) -> Dict:
    """``tr`` with ``prompt_lengths`` and ``decode_tokens`` filled in where
    the file gives distributions instead: a prompt length at each of the
    ``quantiles`` of a log-normal about ``median`` (``sigma`` in log
    space), the output at its ``median``, each divided by ``cut`` and
    rounded; ``traced_lengths``, the prompt lengths of the profiled deck,
    from ``traced_quantiles`` (default: every length)."""
    out = dict(tr)
    cut = float(tr.get("cut", 1))
    if "prompt_lengths" not in out:
        p = tr["prompt_tokens"]
        z = [statistics.NormalDist().inv_cdf(q) for q in p["quantiles"]]
        out["prompt_lengths"] = [max(1, round(p["median"] * math.exp(p["sigma"] * x) / cut))
                                 for x in z]
    if "decode_tokens" not in out:
        out["decode_tokens"] = max(1, round(tr["output_tokens"]["median"] / cut))
    if "traced_lengths" not in out:
        qs = tr.get("traced_quantiles")
        out["traced_lengths"] = (list(out["prompt_lengths"]) if qs is None else
                                 [n for q, n in zip(tr["prompt_tokens"]["quantiles"],
                                                    out["prompt_lengths"]) if q in qs])
    return out


def checks(cell: str) -> Dict:
    return load_json(BENCH / "checks" / f"{cell}.json")


def metric(name: str) -> ModuleType:
    """The reader module ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metrics_for(cell: str, kind: str, bench: Optional[Mapping] = None) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    bench = bench or spec()
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def banned_modules(names: Optional[Sequence[str]] = None) -> List[str]:
    """Banned top-level names among ``names`` (default: the loaded
    modules), compared whole."""
    tops = {name.split(".")[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops & set(BANNED_MODULES))


# -- what a run records ----------------------------------------------------------------
@dataclasses.dataclass
class Task:
    """One model task of a served request: ``steps`` decode steps of
    ``rows`` rows, the first ``prompt_len`` of them over the prompt."""

    task_id: str
    model_id: int
    rows: int
    prompt_len: int
    decode_tokens: int
    prompt: Optional[np.ndarray] = None
    served: Optional[np.ndarray] = None
    #: Of an MoE task: (layers, steps) distinct experts its rows are routed
    #: to, by the reference's routing (``routed_experts``).
    experts: Optional[np.ndarray] = None

    @property
    def steps(self) -> int:
        return self.prompt_len + self.decode_tokens


@dataclasses.dataclass
class Request:
    index: int
    dfg: str
    prompt_len: int
    latency_s: float
    ok: bool
    error: str = ""
    tasks: List[Task] = dataclasses.field(default_factory=list)
    workers: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Trace:
    """The profiled deck: device records (name, start ns, ns), the
    harness's host spans (name, start ns, end ns), the deck's wall
    seconds, the seconds in which the device was busy in all and inside
    the engine's ``run_task`` (the decode steps' replays), the deck's
    tasks."""

    device: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]
    window_s: float
    busy_s: float
    step_busy_s: float
    tasks: List[Task]


@dataclasses.dataclass
class Run:
    """What the metrics' readers read."""

    models: Dict[int, Dict]
    requests: List[Request]
    window_s: float
    setup_s: float
    replays: int = 0
    timers: Optional[Dict[str, float]] = None
    trace: Optional[Trace] = None

    @property
    def done(self) -> List[Request]:
        return [r for r in self.requests if r.ok]


# -- the deployment ----------------------------------------------------------------------
def model_config(sizes: Mapping):
    """The program's ``ModelConfig`` of a model's sizes."""
    from repro_torch.models import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in sizes.items() if k in names})


def build_dfg(d: Mapping):
    from repro_torch.core.types import DFG, MB, TaskSpec

    tasks = [TaskSpec(t["id"], t["runtime_s"], model_id=t["model_id"],
                      output_bytes=t["output_mb"] * MB, input_bytes=t.get("input_mb", 1.0) * MB)
             for t in d["tasks"]]
    return DFG(d["name"], tasks, [tuple(e) for e in d["edges"]])


def preds(d: Mapping, task_id: str) -> List[str]:
    """A task's predecessors in the order of the pipeline's edges: the
    order its prompt concatenates their outputs in."""
    return [u for u, v in d["edges"] if v == task_id]


class Deployment:
    """The hosted models with their seeded weights, and the program's
    serving cluster over them."""

    def __init__(self, cfg: Mapping, tr: Mapping, seed: int, device) -> None:
        import torch
        from repro_torch.core import ClusterSpec, GB
        from repro_torch.models import ParamTree
        from repro_torch.serving import HostedModel, ServingCluster

        from perfbench.weights import Weights, model_seed

        self.cfg, self.traffic = cfg, tr
        self.device = torch.device(device)
        self.sizes = {m["model_id"]: m["config"] for m in cfg["models"]}
        self.weights = {mid: Weights(s, self.device).fill(model_seed(seed, mid))
                        for mid, s in self.sizes.items()}
        hosted = [HostedModel(mid, model_config(s), ParamTree(self.weights[mid].tree()),
                              self.device) for mid, s in self.sizes.items()]
        cl = cfg["cluster"]
        self.cluster = ServingCluster(
            ClusterSpec(n_workers=cl["n_workers"], gpu_capacity_bytes=cl["gpu_capacity_gb"] * GB),
            hosted, scheduler="navigator", decode_tokens=tr["decode_tokens"], device=self.device)
        self.dfgs = {d["name"]: d for d in cfg["dfgs"]}
        self.program_dfgs = {name: build_dfg(d) for name, d in self.dfgs.items()}
        for dfg in self.program_dfgs.values():
            self.cluster.register_pipeline(dfg)
        self.submitted = 0

    def refill(self, seed: int) -> None:
        """Draw every model's weights again from ``seed``, in place."""
        from perfbench.weights import model_seed

        for mid, w in self.weights.items():
            w.fill(model_seed(seed, mid))

    def submit(self, kind: Tuple[str, int], prompts: Dict[str, np.ndarray], index: int) -> Request:
        """Serve one request on the program, timed around ``submit``."""
        d = self.dfgs[kind[0]]
        origin = self.submitted % self.cfg["cluster"]["n_workers"]
        self.submitted += 1
        t0 = time.perf_counter()
        try:
            res = self.cluster.submit(self.program_dfgs[kind[0]], prompts, origin=origin)
        except Exception:  # noqa: BLE001 - the client keeps serving; the check counts it
            return Request(index, kind[0], kind[1], time.perf_counter() - t0, False,
                           traceback.format_exc())
        latency = time.perf_counter() - t0
        return self._record(index, kind, d, prompts, res, latency)

    def _record(self, index, kind, d, prompts, res, latency) -> Request:
        req = Request(index, kind[0], kind[1], latency, True, workers=dict(res.assignment))
        dt = self.traffic["decode_tokens"]
        outputs = res.outputs
        for t in d["tasks"]:
            if t["model_id"] is None:
                continue
            before = preds(d, t["id"])
            prompt = (prompts[t["id"]] if not before
                      else np.concatenate([outputs[p] for p in before], axis=1)
                      if all(p in outputs for p in before) else None)
            served = outputs.get(t["id"])
            rows = prompt.shape[0] if prompt is not None else self.traffic["rows"]
            plen = prompt.shape[1] if prompt is not None else 0
            req.tasks.append(Task(t["id"], t["model_id"], rows, plen, dt, prompt, served))
        return req


# -- the traffic -------------------------------------------------------------------------------
class Traffic:
    """The one generator: decks holding every (pipeline, prompt length) of
    the mix as many times as its weight says, each deck in an order drawn
    from the seed; prompt ids uniform over each entry model's
    vocabulary."""

    def __init__(self, tr: Mapping, cfg: Mapping, seed: int, stream: int = 0) -> None:
        if tr.get("loop", "closed") != "closed" or tr.get("clients", 1) != 1:
            raise ValueError("the generator drives one closed-loop client")
        names = [d["name"] for d in cfg["dfgs"]]
        weights = tr.get("dfg_weights", "uniform")
        counts = {n: 1 for n in names} if weights == "uniform" else dict(weights)
        unknown = set(counts) - set(names)
        if unknown:
            raise ValueError(f"traffic weights name pipelines the configuration lacks: {unknown}")
        self.kinds = [(n, s) for n in names for s in tr["prompt_lengths"]
                      for _ in range(int(counts.get(n, 0)))]
        self.tr = tr
        self.dfgs = {d["name"]: d for d in cfg["dfgs"]}
        self.vocab = {m["model_id"]: m["config"]["vocab"] for m in cfg["models"]}
        self.rng = np.random.default_rng([seed % (1 << 63), stream])

    def deck(self) -> List[Tuple[str, int]]:
        return [self.kinds[i] for i in self.rng.permutation(len(self.kinds))]

    def traced_deck(self) -> List[Tuple[str, int]]:
        """The deck's kinds at the traced prompt lengths, in a seeded order."""
        lengths = self.tr.get("traced_lengths", self.tr["prompt_lengths"])
        return [k for k in self.deck() if k[1] in lengths]

    def prompts(self, kind: Tuple[str, int]) -> Dict[str, np.ndarray]:
        d = self.dfgs[kind[0]]
        out = {}
        for t in d["tasks"]:
            if not preds(d, t["id"]):
                vocab = self.vocab[t["model_id"]]
                out[t["id"]] = self.rng.integers(0, vocab, size=(self.tr["rows"], kind[1]),
                                                 dtype=np.int64).astype(np.int32)
        return out


# -- timers and spans of the harness ------------------------------------------------------------
def instrument(dep: Deployment, timers: Dict[str, float]) -> None:
    """Time the scheduler's ``plan`` and the engine's ``run_task`` (their
    sums in ``timers``), each call a profiler span too (``perfbench.plan``,
    ``perfbench.run_task``)."""
    import torch

    def wrap(obj, name):
        inner = getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"perfbench.{name}"):
                    return inner(*args, **kwargs)
            finally:
                timers[f"{name}_s"] += time.perf_counter() - t0

        setattr(obj, name, timed)

    timers.setdefault("plan_s", 0.0)
    timers.setdefault("run_task_s", 0.0)
    wrap(dep.cluster.scheduler, "plan")
    wrap(dep.cluster.engine, "run_task")


def serve_deck(dep: Deployment, gen: Traffic, out: List[Request], timers=None,
               spans: bool = False, kinds: Optional[Sequence[Tuple[str, int]]] = None) -> None:
    """Submit one deck of requests (or ``kinds``), one after another."""
    import torch

    for kind in gen.deck() if kinds is None else kinds:
        prompts = gen.prompts(kind)
        t0 = time.perf_counter()
        if spans:
            with torch.profiler.record_function("perfbench.submit"):
                req = dep.submit(kind, prompts, len(out))
        else:
            req = dep.submit(kind, prompts, len(out))
        if timers is not None:
            timers["submit_s"] = timers.get("submit_s", 0.0) + time.perf_counter() - t0
        out.append(req)


def warm_up(dep: Deployment, seed: int) -> List[Request]:
    """One request of every kind the mix holds, from a stream of its own:
    every graph the window replays is captured, every kernel loaded."""
    gen = Traffic(dep.traffic, dep.cfg, seed, stream=1)
    out: List[Request] = []
    for kind in sorted(set(gen.kinds)):
        out.append(dep.submit(kind, gen.prompts(kind), len(out)))
    bad = [r.error for r in out if not r.ok]
    if bad:
        raise RuntimeError(f"a warm-up request failed: {bad[0]}")
    return out


def window(dep: Deployment, gen: Traffic, seconds: float, timers=None) -> Tuple[List[Request], float]:
    """Whole decks until ``seconds`` have passed: (requests, window s)."""
    out: List[Request] = []
    t0 = time.perf_counter()
    while True:
        serve_deck(dep, gen, out, timers)
        if time.perf_counter() - t0 >= seconds:
            return out, time.perf_counter() - t0


# -- the check -----------------------------------------------------------------------------------
def sample(requests: Sequence[Request], n: int, seed: int) -> List[Request]:
    """``n`` finished requests drawn from the seed, the longest among them."""
    done = [r for r in requests if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (sum(t.rows * t.steps for t in r.tasks), r.latency_s))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed % (1 << 63), 2])
    picked = [rest[i] for i in sorted(rng.choice(len(rest), size=min(n - 1, len(rest)),
                                                 replace=False))] if rest else []
    return [longest] + picked


def batches(tasks: Sequence[Task]):
    """Blocks of tasks of one model: (tasks, tokens (N, L) int64, want (N, L)
    bool at the positions whose logits choose the served tokens, the
    served tokens at those positions)."""
    block: List[Task] = []
    n = 0
    for t in tasks:
        if block and n + t.rows > BLOCK_ROWS:
            yield _batch(block)
            block, n = [], 0
        block.append(t)
        n += t.rows
    if block:
        yield _batch(block)


def _batch(block: Sequence[Task]):
    length = max(t.steps for t in block)
    rows = sum(t.rows for t in block)
    tokens = np.zeros((rows, length), np.int64)
    want = np.zeros((rows, length), bool)
    chosen = np.zeros((rows, length), np.int64)
    r = 0
    for t in block:
        seq = np.concatenate([t.prompt, t.served], axis=1)
        tokens[r: r + t.rows, : seq.shape[1]] = seq
        want[r: r + t.rows, t.prompt_len - 1: t.steps - 1] = True
        chosen[r: r + t.rows, t.prompt_len - 1: t.steps - 1] = t.served[:, : t.decode_tokens]
        r += t.rows
    return list(block), tokens, want, chosen[want]


def readings(dep: Deployment, tasks: Sequence[Task], control: bool = False
             ) -> Dict[int, Dict[str, float]]:
    """For each model: the widest gap by which a served token's logit lies
    below the reference's best (``program``), and the share of served
    tokens that are not the reference's first choice; with ``control``,
    the same of the token the float8 reference puts first."""
    import torch

    from perfbench import reference

    reference.exact_matmuls()
    out: Dict[int, Dict[str, float]] = {}
    for mid, sizes in dep.sizes.items():
        mine = [t for t in tasks if t.model_id == mid]
        if not mine:
            continue
        row = dict(program=0.0, program_flips=0, tokens=0)
        if control:
            row.update(control=0.0, control_flips=0)
        for _, tokens, want, chosen in batches(mine):
            tok = torch.as_tensor(tokens, device=dep.device)
            wm = torch.as_tensor(want, device=dep.device)
            ref, _ = reference.forward(sizes, dep.weights[mid].views, tok, wm)
            picks = {"program": torch.as_tensor(chosen, device=dep.device)}
            if control:
                low, _ = reference.forward(sizes, dep.weights[mid].views, tok, wm, fp8=True)
                picks["control"] = low.argmax(-1)
                del low
            best = ref.argmax(-1)
            for side, pick in picks.items():
                row[side] = max(row[side], float(reference.gaps(ref, pick).max()))
                row[f"{side}_flips"] += int((pick != best).sum())
            row["tokens"] += len(chosen)
            del ref
        out[mid] = row
    return out


def routed_experts(dep: Deployment, tasks: Sequence[Task]) -> None:
    """Set ``experts`` of each MoE task among ``tasks``: (layers, steps)
    distinct experts its rows are routed to at each step, by the
    reference's routing of the same tokens."""
    import torch

    from perfbench import reference

    for mid, sizes in dep.sizes.items():
        family = families.of(sizes)
        if family is not None:
            family_experts(dep, mid, family, tasks)
            continue
        if sizes["arch_type"] != "moe":
            continue
        mine = [t for t in tasks if t.model_id == mid and well_formed(t)]
        for block, tokens, _, _ in batches(mine):
            tok = torch.as_tensor(tokens, device=dep.device)
            none = torch.zeros(tokens.shape, dtype=torch.bool, device=dep.device)
            _, routes = reference.forward(sizes, dep.weights[mid].views, tok, none, routing=True)
            r = 0
            for t in block:
                counts = []
                for idx in routes:  # (N, L, k)
                    hit = torch.zeros(t.steps, sizes["n_experts"], device=dep.device)
                    part = idx[r: r + t.rows, : t.steps]
                    hit.scatter_(1, part.permute(1, 0, 2).reshape(t.steps, -1), 1.0)
                    counts.append(hit.sum(-1))
                t.experts = torch.stack(counts).cpu().numpy().astype(np.int64)
                r += t.rows


def family_experts(dep: Deployment, mid: int, family: ModuleType,
                   tasks: Sequence[Task]) -> None:
    """``routed_experts`` of a model whose family file reads its routes."""
    import torch

    from perfbench import reference

    sizes = dep.sizes[mid]
    mine = [t for t in tasks if t.model_id == mid and well_formed(t)]
    for block, tokens, _, _ in batches(mine):
        tok = torch.as_tensor(tokens, device=dep.device)
        none = torch.zeros(tokens.shape, dtype=torch.bool, device=dep.device)
        _, routes = reference.forward(sizes, dep.weights[mid].views, tok, none, routing=True)
        r = 0
        for t in block:
            t.experts = family.experts_read(sizes, routes, slice(r, r + t.rows), t.steps)
            r += t.rows


def well_formed(t: Task) -> bool:
    return (t.prompt is not None and t.served is not None
            and t.served.shape == (t.rows, t.decode_tokens))


def malformed(dep: Deployment, requests: Sequence[Request]) -> int:
    """Finished requests whose outputs are missing, of the wrong shape, or
    whose tasks were placed on a worker the cluster does not have."""
    n_workers = dep.cfg["cluster"]["n_workers"]
    bad = 0
    for r in requests:
        if not r.ok:
            continue
        wrong = not all(well_formed(t) for t in r.tasks)
        wrong |= any(not 0 <= w < n_workers for w in r.workers.values())
        d = dep.dfgs[r.dfg]
        wrong |= set(r.workers) != {t["id"] for t in d["tasks"]}
        bad += bool(wrong)
    return bad


def check(dep: Deployment, requests: Sequence[Request], limits: Mapping, seed: int
          ) -> Dict[str, Dict[str, float]]:
    """Every compared number of the check beside its limit."""
    return check_sides(dep, requests, limits, seed)["program"]


def check_sides(dep: Deployment, requests: Sequence[Request], limits: Mapping, seed: int,
                sides: Sequence[str] = ("program",)) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The check's rows for each of ``sides``: ``program`` judges the
    served tokens; ``control`` puts in each served token's place the token
    that the float8 reference puts first there, and judges that."""
    head = {
        "failed": {"value": float(sum(not r.ok for r in requests)), "limit": 0.0},
        "malformed": {"value": float(malformed(dep, requests)), "limit": 0.0},
    }
    picked = [r for r in sample(requests, limits["sample_requests"], seed)
              if all(well_formed(t) for t in r.tasks)]
    gaps = readings(dep, [t for r in picked for t in r.tasks], control="control" in sides)
    head["sampled_tokens"] = {"value": float(sum(t.rows * t.decode_tokens for r in picked
                                                 for t in r.tasks)),
                              "limit": float(limits["least_sampled_tokens"])}
    out = {}
    for side in sides:
        rows = {k: dict(v) for k, v in head.items()}
        for mid, row in gaps.items():
            name = dep.sizes[mid]["name"]
            rows[f"logit_gap.{name}"] = {"value": row[side],
                                         "limit": float(limits["logit_gap"][name])}
        out[side] = rows
    return out


def passed(results: Mapping[str, Mapping[str, float]]) -> bool:
    """Every number within its limit; ``sampled_tokens`` is a floor."""
    for name, row in results.items():
        if name == "sampled_tokens":
            if not row["value"] >= row["limit"]:
                return False
        elif not row["value"] <= row["limit"]:
            return False
    return True


# -- reading the metrics -----------------------------------------------------------------------------
def read_metrics(run: Run, entries: Sequence[Mapping]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for e in entries:
        value = metric(e["name"]).read(run)
        if value is not None:
            out[e["name"]] = {"value": float(value), "unit": e["unit"]}
    return out


def latency_by_kind(requests: Sequence[Request]) -> Dict[str, float]:
    """The median latency of each (pipeline, prompt length), for the log."""
    by: Dict[str, List[float]] = {}
    for r in requests:
        by.setdefault(f"{r.dfg}@{r.prompt_len}", []).append(r.latency_s)
    return {k: round(statistics.median(v), 4) for k, v in sorted(by.items())}


def p95(values: Sequence[float]) -> Optional[float]:
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20, method="inclusive")[18]
