"""Small stand-ins of the benchmark's cells for the CPU tests: each
model's sizes cut as the program's ``ModelConfig.reduced`` cuts them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Dict, Mapping

from perfbench import families


def reduced(sizes: Mapping, dtype: str = "float32") -> Dict:
    family = families.of(sizes)
    if family is not None:
        return family.reduced(sizes, dtype)
    s = dict(sizes)
    d = min(s["d_model"], 256)
    heads = min(s.get("n_heads", 0), 4)
    kv = min(s.get("n_kv_heads", 0), heads)
    if heads and (kv == 0 or heads % kv):
        kv = 1
    s.update(name=s["name"] + "-small", dtype=dtype, n_layers=2, d_model=d, n_heads=heads,
             n_kv_heads=kv, vocab=min(s["vocab"], 512), d_ff=min(s.get("d_ff", 0), 512))
    if heads:
        s["head_dim"] = d // heads
    if s.get("n_experts"):
        s.update(n_experts=min(s["n_experts"], 4), top_k=min(s["top_k"], 2),
                 d_ff_expert=min(s["d_ff_expert"], 128))
    if s["arch_type"] == "ssm":
        s.update(ssm_state=min(s["ssm_state"], 16), ssm_head_dim=min(s["ssm_head_dim"], 32),
                 ssm_chunk=16)
    return s


def small_config(cfg: Mapping, dtype: str = "float32") -> Dict:
    out = copy.deepcopy(dict(cfg))
    for m in out["models"]:
        m["config"] = reduced(m["config"], dtype)
    return out


def small_traffic(tr: Mapping) -> Dict:
    out = dict(tr)
    out.update(rows=2, prompt_lengths=[3, 5], decode_tokens=3)
    return out


def small_limits(cfg: Mapping, gap: float = 1e-3) -> Dict:
    return {"sample_requests": 4, "least_sampled_tokens": 1,
            "logit_gap": {m["config"]["name"]: gap for m in cfg["models"]}}


#: The tests' family file: ``moe`` with one always-on shared expert.
FAMILY_FILE = Path(__file__).with_name("moe_shared_family.py")


def add_family(bench: Path, source: Mapping) -> Dict:
    """Into ``bench``, a copy of the benchmark's files: ``FAMILY_FILE`` as
    ``families/moe_shared.py``, and ``configs/qwen3shared.json``, the
    configuration ``source`` (qwen3moe's) with its MoE model renamed
    ``qwen3-moe-shared`` and naming that family, and the check
    ``checks/qwen3shared.chat.json``.  Returns the configuration."""
    shutil.copy(FAMILY_FILE, bench / "families" / "moe_shared.py")
    cfg = copy.deepcopy(dict(source))
    cfg["name"] = "qwen3shared"
    moe = next(m["config"] for m in cfg["models"] if m["config"]["arch_type"] == "moe")
    old = moe["name"]
    moe.update(name="qwen3-moe-shared", family="moe_shared", n_shared_experts=1)
    (bench / "configs" / "qwen3shared.json").write_text(json.dumps(cfg))
    lim = json.loads((bench / "checks" / "qwen3moe.chat.json").read_text())
    lim["logit_gap"]["qwen3-moe-shared"] = lim["logit_gap"].pop(old)
    (bench / "checks" / "qwen3shared.chat.json").write_text(json.dumps(lim))
    return cfg
