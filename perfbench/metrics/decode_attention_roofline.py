"""Decode attention's share of its roofline over the profiled deck: the
least time its launches need (``counting.decode_bound`` a launch, at each
step's valid cache length), over the device time of its kernels.  Read
only where the profile holds every launch the deck made."""

from perfbench import counting, trace

UNIT = "%"
LAYER = "kernels"
MOVES = "generated_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    bound_ms, launches = 0.0, 0
    for t in run.trace.tasks:
        m = run.models[t.model_id]
        if m["arch_type"] not in ("dense", "moe"):
            continue
        it = counting.ITEMSIZE[m["dtype"]]
        for p in range(t.steps):
            ms = counting.decode_bound(t.rows, m["n_heads"], m["n_kv_heads"], m["head_dim"],
                                       [p + 1] * t.rows, m["dtype"], it)[0]
            bound_ms += ms * m["n_layers"]
            launches += m["n_layers"]
    secs, calls = trace.decode_attention(run.trace.device)
    if not launches or calls != launches or secs <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / secs
