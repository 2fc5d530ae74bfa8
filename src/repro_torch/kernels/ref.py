"""Plain PyTorch oracles, mirroring ``repro.kernels.ref`` function for
function.  They keep the reference's dtype behaviour (scores cast to fp32,
probabilities cast back to the value dtype), so the CPU tests can hold
the two packages to the reference tolerances.

Shapes follow the serving convention:
  q        : (batch, q_len, n_heads, head_dim)          (decode: no q_len axis)
  k, v     : (batch, kv_len, n_kv_heads, head_dim)    (n_heads % n_kv_heads == 0)
  output   : (batch, q_len, n_heads, head_dim)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast KV heads to query heads: (B,T,KH,D) → (B,T,H,D)."""
    group = n_heads // k.shape[2]
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
             q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) mask of the keys each query sees."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full (prefill/train) attention with an optional causal mask and
    sliding window.  ``q_offset`` is the absolute position of q[0] relative
    to k[0].  Scores are taken in the inputs' dtype and cast to fp32, and
    the probabilities are cast to v's dtype before P·V, as in the JAX
    oracle; a query that sees no key gives 0."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _visible(sq, sk, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_chunked_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    chunk_k: int = 1024,
    return_lse: bool = False,
):
    """Flash-style attention in plain PyTorch: a loop over KV chunks with
    an online-softmax accumulator, all in fp32, so the (Sq × Sk) score
    matrix is never held whole.  A query that sees no key gives 0.  With
    ``return_lse`` it returns (out, lse): lse (B, H, Sq) fp32 is each
    query's log-sum-exp of its scaled scores, -inf where it sees no key."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    chunk_k = min(chunk_k, sk)
    qf = q.float() * scale
    mask = _visible(sq, sk, causal, window, q_offset, q.device)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, sk, chunk_k):
        k_i = _gqa_expand(k[:, k0:k0 + chunk_k], h).float()
        v_i = _gqa_expand(v[:, k0:k0 + chunk_k], h).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_i)
        s = s.masked_fill(~mask[None, None, :, k0:k0 + chunk_k], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        p = torch.exp(s - m_safe[..., None])  # exp(-inf) = 0 for masked keys
        alpha = torch.exp(m - m_safe)         # 0 while m is still -inf
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_i)
        m = m_new
    lse = m + torch.log(l)  # -inf + -inf where no key was seen
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return (out, lse) if return_lse else out


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token GQA decode against a KV cache; a row with no valid slot
    gives 0.

    q        : (B, H, D)       — the single new token's queries
    k_cache  : (B, T, KH, D)   — T = cache capacity
    cache_len: (B,) int32      — valid prefix length per sequence
    """
    b, h, d = q.shape
    t = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k_cache, h)
    v = _gqa_expand(v_cache, h)
    logits = torch.einsum("bhd,bkhd->bhk", q, k).float() * scale
    valid = torch.arange(t, device=q.device)[None, :] < cache_len[:, None]
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def decode_attention_grouped_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA decode with the queries grouped per KV head, contracting
    against the unexpanded cache in fp32.  Functionally identical to
    :func:`decode_attention_ref`."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kh, g, d).float() * scale
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    valid = torch.arange(t, device=q.device) < cache_len[:, None, None, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgt,btkd->bkgd", p / l, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def ssd_decode_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step SSD recurrence for decode.

    x: (B,H,P), dt: (B,H), b/c: (B,H,N), state: (B,H,P,N) fp32.
    Returns (y (B,H,P) in x's dtype, new state)."""
    dtf = dt.float()
    decay = torch.exp(a[None, :] * dtf)
    upd = (dtf[..., None, None] * x.float()[..., :, None]) * b.float()[..., None, :]
    new_state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c.float())
    return y.to(x.dtype), new_state


def ssd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD reference: the sequential recurrence, in fp32.

    x: (B,T,H,P); dt: (B,T,H) positive step sizes; a: (H,) negative decay;
    b/c: (B,T,H,N).  Returns (y (B,T,H,P) in x's dtype, final state
    (B,H,P,N) fp32).  Per head: S_t = exp(a·dt_t)·S_{t-1} + dt_t·(x_t ⊗ b_t),
    y_t = S_t · c_t."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bs, h, p, n), device=x.device) if initial_state is None
             else initial_state.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    ys = []
    for i in range(t):
        decay = torch.exp(a[None, :] * dtf[:, i])
        upd = (dtf[:, i, :, None, None] * xf[:, i, :, :, None]) * bf[:, i, :, None, :]
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, i]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bs, 0, h, p))
    return y.to(x.dtype), state


def ssd_chunked_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in the dual (attention-like) form, in fp32: per chunk of
    L steps a masked (L×L) product plus a carried (P×N) state.  Padded
    steps get dt = 0, so they neither decay nor feed the state.  The mask
    goes into the exponent (−inf above the diagonal): there s_i − s_j > 0
    passes exp's fp32 range at full width (a·dt summed over a chunk), and
    a mask applied after the exp would send 0 × inf = NaN into the
    gradient."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, t)
    t_pad = -(-t // chunk) * chunk
    if t_pad != t:
        pad = t_pad - t
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    nchunks = t_pad // chunk
    xf = x.float().reshape(bs, nchunks, chunk, h, p)
    dtf = dt.float().reshape(bs, nchunks, chunk, h)
    bf = b.float().reshape(bs, nchunks, chunk, h, n)
    cf = c.float().reshape(bs, nchunks, chunk, h, n)
    state = (torch.zeros((bs, h, p, n), device=x.device) if initial_state is None
             else initial_state.float())
    li = torch.arange(chunk, device=x.device)
    causal = li[:, None] >= li[None, :]
    ys = []
    for ci in range(nchunks):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        s = torch.cumsum(a[None, None, :] * dtc, dim=1)             # (B,L,H)
        gamma = torch.exp(torch.where(
            causal[None, :, :, None],
            s[:, :, None, :] - s[:, None, :, :],
            torch.full((), float("-inf"), device=x.device),
        )) * dtc[:, None, :, :]                                      # (B,L,L,H)
        cb = torch.einsum("blhn,bmhn->blmh", cc, bc)
        y_intra = torch.einsum("blmh,bmhp->blhp", cb * gamma, xc)
        y_inter = torch.exp(s)[..., None] * torch.einsum("bhpn,blhn->blhp", state, cc)
        w = torch.exp(s[:, -1:, :] - s) * dtc                        # (B,L,H)
        state = (torch.exp(s[:, -1, :])[:, :, None, None] * state
                 + torch.einsum("blhp,blhn->bhpn", xc * w[..., None], bc))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bs, t_pad, h, p)[:, :t]
    return y.to(x.dtype), state


def group_bounds(group_sizes: torch.Tensor, tokens: int) -> Tuple[list, list]:
    """(first row, end row) of each expert's group, on the host, as the JAX
    oracle assigns rows: row r goes to the last expert whose group starts at
    or before r (``ref.py::moe_gmm_ref``'s ``expert_of_row``).  For sizes
    that sum to ``tokens`` that is the plain split; rows past the sum go to
    the last expert.  Sizes are taken to be non-negative."""
    ends = torch.cumsum(group_sizes.long(), 0).clamp(max=tokens).tolist()
    starts = [0] + ends[:-1]
    return starts, ends[:-1] + [tokens]


def grouped_product(
    x: torch.Tensor,
    w: torch.Tensor,
    group_sizes: torch.Tensor,
    product: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """``product(rows, w[e])`` for each expert's non-empty group of rows
    (:func:`group_bounds`), written into one (tokens, d_out) tensor of x's
    dtype."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    for e, (s0, s1) in enumerate(zip(*group_bounds(group_sizes, x.shape[0]))):
        if s1 > s0:
            out[s0:s1] = product(x[s0:s1], w[e])
    return out


def _product(fp32: bool) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``a @ b`` in the operands' dtype, or (``fp32``) in fp32 rounded once
    to a's dtype."""
    if not fp32:
        return torch.matmul
    return lambda a, b: (a.float() @ b.float()).to(a.dtype)


# The grouped matmul is an op of its own, so that a count on fake tensors
# (``repro_torch.launch.counter``) can run it: its real body reads the group
# sizes on the host, which a fake tensor has not got.  Its fake body gives
# the shape, its flop formula the work (the groups partition the rows), and
# its backward is two more such ops, with the arithmetic of autograd
# through the per-group products (``tests/test_torch_dryrun.py``).
@torch.library.custom_op("repro_torch::grouped_matmul", mutates_args=())
def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   fp32: bool) -> torch.Tensor:
    """x (T, d_in) rows sorted by expert, w (E, d_in, d_out) → (T, d_out) in
    x's dtype: each group's rows times its expert's weight (``fp32``: in
    fp32, rounded once)."""
    return grouped_product(x, w, group_sizes, _product(fp32))


@grouped_matmul.register_fake
def _(x, w, group_sizes, fp32):
    return x.new_empty((x.shape[0], w.shape[2]))


@torch.library.custom_op("repro_torch::grouped_matmul_wgrad", mutates_args=())
def grouped_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
                         n_experts: int, fp32: bool) -> torch.Tensor:
    """The weight gradient of :func:`grouped_matmul`: (E, d_in, d_out), each
    expert's rows of x transposed times theirs of dy, zeros for an empty
    group, in x's dtype."""
    dw = x.new_zeros((n_experts, x.shape[1], dy.shape[1]))
    prod = _product(fp32)
    for e, (s0, s1) in enumerate(zip(*group_bounds(group_sizes, x.shape[0]))):
        if s1 > s0:
            dw[e] = prod(x[s0:s1].t(), dy[s0:s1])
    return dw


@grouped_matmul_wgrad.register_fake
def _(x, dy, group_sizes, n_experts, fp32):
    return x.new_empty((n_experts, x.shape[1], dy.shape[1]))


def _gmm_setup(ctx, inputs, output):
    x, w, group_sizes, fp32 = inputs
    ctx.save_for_backward(x, w, group_sizes)
    ctx.fp32 = fp32


def _gmm_backward(ctx, dy):
    x, w, group_sizes = ctx.saved_tensors
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = grouped_matmul(dy, w.transpose(1, 2), group_sizes, ctx.fp32)
    if ctx.needs_input_grad[1]:
        dw = grouped_matmul_wgrad(x, dy, group_sizes, w.shape[0], ctx.fp32).to(w.dtype)
    return dx, dw, None, None


grouped_matmul.register_autograd(_gmm_backward, setup_context=_gmm_setup)


@register_flop_formula([torch.ops.repro_torch.grouped_matmul,
                        torch.ops.repro_torch.grouped_matmul_wgrad])
def _gmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·T·d_in·d_out for either op: each of the T rows is in one group."""
    t, d_in = a_shape
    return 2 * t * d_in * b_shape[-1]


def moe_gmm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    group_sizes: torch.Tensor,
) -> torch.Tensor:
    """Grouped matmul reference: rows of ``x`` are sorted by expert;
    ``group_sizes[e]`` rows belong to expert ``e`` and are multiplied by
    ``w[e]``, in x's dtype.

    x: (tokens, d_in), w: (E, d_in, d_out), group_sizes: (E,) summing to
    tokens → (tokens, d_out).  The JAX oracle gathers one (d_in, d_out)
    weight per row, which at Qwen3-MoE's prefill alone would take ~100 GB;
    this computes the same function with one matmul per non-empty group
    (the group bounds are read on the host, inside :func:`grouped_matmul`)."""
    return grouped_matmul(x, w, group_sizes, False)
