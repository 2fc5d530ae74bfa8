"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that one decode step of a served model needs, counted from the
model's sizes (its configuration file) alone.

A step feeds one token to each of a task's B rows at position ``pos``
(0-based): the cache then holds pos + 1 valid slots a row.  Counted:

* operations: 2 a multiply-add of every product with a weight the step
  needs (an MoE layer: the router and each row's top k experts), 4·H·D a
  valid cache slot a row in each attention layer (q·k and p·v), and an
  SSM layer's conv (2·K a channel) and state update and read-out (5 an
  element of the H × P × N state);
* bytes: each weight the step needs read once (of the embedding only the
  B rows looked up; of an MoE layer the router and the distinct experts
  the B rows are routed to), the valid K/V slots read and the new ones
  written, an SSM layer's conv window and float32 state read and
  written, and the logits written.

``decode_bound`` is the decode-attention kernel's least time, as the
smoke run counts it: q and the lengths read once, the valid K/V rows read
once, the output written once, 4·H·D operations a valid row.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

from perfbench import families

#: NVIDIA H100 SXM, data sheet: HBM3 bytes/s, dense bf16 tensor-core
#: FLOP/s, float32 FLOP/s off the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def decode_bound(b: int, h: int, kh: int, d: int, lens: Sequence[int], dtype: str,
                 itemsize: int) -> Tuple[float, int, int, str]:
    """Least time (ms) for the work these inputs need: q and lens read once,
    the valid K/V rows read once, the output written once; 4·H·D flops per
    valid row.  Returns (ms, bytes, flops, 'bytes' or 'operations')."""
    rows = sum(lens)
    nbytes = 2 * b * h * d * itemsize + 4 * b + 2 * rows * kh * d * itemsize
    flops = 4 * h * d * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def _ssm_sizes(m: Mapping) -> Tuple[int, int, int, int]:
    """(d_inner, SSD heads, conv channels, in-projection width)."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    h = di // m["ssm_head_dim"]
    gn = m["ssm_groups"] * m["ssm_state"]
    return di, h, di + 2 * gn, 2 * di + 2 * gn + h


def _attn_weights(m: Mapping) -> int:
    d, h, kh, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return d * h * hd + 2 * d * kh * hd + h * hd * d


def expert_weights(m: Mapping) -> int:
    """Weights of one routed expert (gate, up, down)."""
    return 3 * m["d_model"] * m["d_ff_expert"]


def step_flops(m: Mapping, b: int, pos: int) -> float:
    """Operations of one decode step of ``b`` rows at position ``pos``."""
    family = families.of(m)
    if family is not None:
        return family.step_flops(m, b, pos)
    d, v, n = m["d_model"], m["vocab"], m["n_layers"]
    fam = m["arch_type"]
    head = 2 * d * v
    if fam == "ssm":
        di, h, c, proj = _ssm_sizes(m)
        state = h * m["ssm_head_dim"] * m["ssm_state"]
        layer = 2 * (d * proj + di * d) + 2 * m["conv_kernel"] * c + 5 * state
        return float(b * (n * layer + head))
    attn = 2 * _attn_weights(m) + 4 * m["n_heads"] * m["head_dim"] * (pos + 1)
    if fam == "dense":
        ffn = 2 * 3 * d * m["d_ff"]
    else:
        ffn = 2 * d * m["n_experts"] + 2 * m["top_k"] * expert_weights(m)
    return float(b * (n * (attn + ffn) + head))


def step_bytes(m: Mapping, b: int, pos: int, experts: Optional[Sequence[int]] = None) -> float:
    """Bytes of one decode step of ``b`` rows at position ``pos``; an MoE
    model needs ``experts``, the distinct experts its rows are routed to
    in each layer."""
    family = families.of(m)
    if family is not None:
        return family.step_bytes(m, b, pos, experts)
    d, v, n = m["d_model"], m["vocab"], m["n_layers"]
    it = ITEMSIZE[m["dtype"]]
    fam = m["arch_type"]
    total = b * d * it + d * it + d * v * it + b * v * it  # embedding rows, norm, head, logits
    if fam == "ssm":
        di, h, c, proj = _ssm_sizes(m)
        k = m["conv_kernel"]
        weights = d * it + d * proj * it + k * c * it + c * it + 3 * h * 4 + di * d * it
        state = b * (2 * (k - 1) * c * it + 2 * h * m["ssm_head_dim"] * m["ssm_state"] * 4)
        return float(total + n * (weights + state))
    kv = b * 2 * m["n_kv_heads"] * m["head_dim"] * it * (pos + 1 + 1)  # valid slots read, one written
    norms = 2 * d * it
    if fam == "dense":
        total += n * (norms + _attn_weights(m) * it + 3 * d * m["d_ff"] * it + kv)
        return float(total)
    if experts is None or len(experts) != n:
        raise ValueError("an MoE step's bytes need the distinct experts of each layer")
    router = d * m["n_experts"] * 4
    for e in experts:
        total += norms + _attn_weights(m) * it + router + e * expert_weights(m) * it + kv
    return float(total)
