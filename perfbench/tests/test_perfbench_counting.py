"""The yardstick's counts against hand counts at tiny sizes."""

import pytest

from perfbench import counting

DENSE = dict(arch_type="dense", dtype="bfloat16", n_layers=2, d_model=8, n_heads=4,
             n_kv_heads=2, head_dim=2, d_ff=16, vocab=10)
MOE = dict(arch_type="moe", dtype="bfloat16", n_layers=2, d_model=8, n_heads=4, n_kv_heads=2,
           head_dim=2, vocab=10, n_experts=6, top_k=2, d_ff_expert=4)
SSM = dict(arch_type="ssm", dtype="bfloat16", n_layers=3, d_model=4, vocab=10, ssm_expand=2,
           ssm_head_dim=2, ssm_state=3, ssm_groups=1, conv_kernel=4)


def test_decode_bound_by_hand():
    ms, nbytes, flops, bound = counting.decode_bound(2, 4, 2, 8, [3, 5], "bfloat16", 2)
    assert nbytes == 2 * 2 * 4 * 8 * 2 + 4 * 2 + 2 * 8 * 2 * 8 * 2
    assert flops == 4 * 4 * 8 * 8
    assert bound == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_dense_step_by_hand():
    # per row: attention weights 8*8 + 2*8*4 + 8*8 = 192, mlp 3*8*16 = 384, head 80
    per_row = 2 * (2 * (192 + 384) + 80) + 2 * 4 * 4 * 2 * 6  # pos 5: 6 valid slots
    assert counting.step_flops(DENSE, 3, 5) == 3 * per_row
    kv = 3 * 2 * 2 * 2 * 2 * 7  # b, k and v, kv heads, head dim, bytes, 6 read + 1 written
    layer = 2 * 8 * 2 + (192 + 384) * 2 + kv
    head = 3 * 8 * 2 + 8 * 2 + 8 * 10 * 2 + 3 * 10 * 2
    assert counting.step_bytes(DENSE, 3, 5) == 2 * layer + head


def test_moe_step_counts_topk_and_touched_experts():
    attn = 192
    per_row = 2 * (2 * (attn + 8 * 6 + 2 * 3 * 8 * 4) + 80) + 2 * 4 * 4 * 2 * 1
    assert counting.step_flops(MOE, 2, 0) == 2 * per_row
    kv = 2 * 2 * 2 * 2 * 2 * 2
    head = 2 * 8 * 2 + 8 * 2 + 8 * 10 * 2 + 2 * 10 * 2

    def layer(e):
        return 2 * 8 * 2 + attn * 2 + 8 * 6 * 4 + e * 3 * 8 * 4 * 2 + kv
    assert counting.step_bytes(MOE, 2, 0, [3, 4]) == head + layer(3) + layer(4)
    with pytest.raises(ValueError):
        counting.step_bytes(MOE, 2, 0)


def test_ssm_step_by_hand():
    # d_inner 8, 4 heads, conv channels 8 + 6 = 14, in-projection 16 + 6 + 4 = 26
    state = 4 * 2 * 3
    layer_ops = 2 * (4 * 26 + 8 * 4) + 2 * 4 * 14 + 5 * state
    assert counting.step_flops(SSM, 2, 9) == 2 * (3 * layer_ops + 2 * 4 * 10)
    weights = 4 * 2 + 4 * 26 * 2 + 4 * 14 * 2 + 14 * 2 + 3 * 4 * 4 + 8 * 4 * 2
    st = 2 * (2 * 3 * 14 * 2 + 2 * state * 4)
    head = 2 * 4 * 2 + 4 * 2 + 4 * 10 * 2 + 2 * 10 * 2
    assert counting.step_bytes(SSM, 2, 9) == head + 3 * (weights + st)


def test_position_moves_attention_only():
    assert counting.step_flops(SSM, 1, 0) == counting.step_flops(SSM, 1, 100)
    d = counting.step_flops(DENSE, 1, 10) - counting.step_flops(DENSE, 1, 9)
    assert d == 2 * 4 * 4 * 2


#: The built-in families' counts at the served sizes, pinned to what the
#: counts read before family files existed: (rows, position, operations,
#: bytes), an MoE model's bytes at ``pinned_experts``.
PINNED = {
    "mamba2-780m": [(1, 0, 1653891072.0, 1713032400.0), (4, 17, 6615564288.0, 2172078912.0),
                    (4, 237, 6615564288.0, 2172078912.0)],
    "mistral-nemo-12b": [(1, 0, 23153213440.0, 23153987584.0),
                         (4, 17, 92657418240.0, 23166928896.0),
                         (4, 237, 93234135040.0, 23311108096.0)],
    "granite-20b": [(1, 0, 13325598720.0, 13325733888.0), (4, 17, 53322448896.0, 13326520320.0),
                    (4, 237, 53581971456.0, 13331927040.0)],
    "qwen3-moe-30b-a3b": [(1, 0, 6084100096.0, 5231723264.0),
                          (4, 17, 24389877760.0, 16111557632.0),
                          (4, 237, 25081937920.0, 16198065152.0)],
}


def served_sizes():
    from perfbench import harness as hb

    return {m["config"]["name"]: m["config"] for e in hb.spec()["configs"]
            for m in hb.config(e["name"])["models"]}


def pinned_experts(m, b):
    """Distinct experts a layer: b · top k less 0-4 by layer, at most all."""
    return [min(m["n_experts"], b * m["top_k"] - i % 5) for i in range(m["n_layers"])]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_built_in_counts_are_pinned(name):
    m = served_sizes()[name]
    assert "family" not in m
    for b, pos, flops, nbytes in PINNED[name]:
        experts = pinned_experts(m, b) if m["arch_type"] == "moe" else None
        assert counting.step_flops(m, b, pos) == flops
        assert counting.step_bytes(m, b, pos, experts) == nbytes
