"""The port's CUDA kernels against their plain PyTorch versions, the
serve example and the prefill step through them, and the execution
engine's CUDA graphs of the decode step against the eager loop.  These
need a card (the kernels have no CPU mode) and skip without one; they
import no JAX, so they run as they are on a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.examples import serve_cluster as ex  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import moe_gmm_bwd as gb  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as sb  # noqa: E402
from repro_torch.training import make_prefill_step  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
# SSD: tests/test_kernels.py's 5e-5 / 5e-4 in fp32; y rounds to bf16 in bf16
SSD_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def decode_close(got, want, dtype):
    """chip_smoke.py's check of a decode-attention output: in bf16 the
    absolute tolerance is scaled to each output row's largest |want| when
    that is below 1, so that a split dropped over a long cache, whose rows
    are small, does not pass."""
    tol = TOL[dtype]
    atol = tol * want.abs().amax(dim=-1, keepdim=True).clamp(max=1.0) if dtype == torch.bfloat16 else tol
    return bool(((got - want).abs() <= atol + tol * want.abs()).all())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,kh,d,t",
    [
        (1, 4, 4, 64, 128),
        (2, 8, 2, 64, 300),
        (4, 8, 1, 32, 64),
        (2, 16, 8, 128, 512),
        (2, 32, 32, 112, 96),   # zamba2's head dim
        (2, 16, 2, 192, 80),    # MLA's hd + rope dim
        (2, 48, 1, 128, 70),    # granite's MQA: two row chunks per CTA grid
        (2, 16, 16, 64, 1500),  # whisper's cross-attention over 1,500 encoder frames
    ],
)
def test_kernel_matches_plain_on_card(card, b, h, kh, d, t, dtype):
    g = torch.Generator(device=card).manual_seed(b * t + d)
    q = torch.randn(b, h, d, generator=g, device=card, dtype=dtype)
    k = torch.randn(b, t, kh, d, generator=g, device=card, dtype=dtype)
    v = torch.randn(b, t, kh, d, generator=g, device=card, dtype=dtype)
    lens = torch.tensor([0, 1, t, t + 5][:b] if b > 1 else [t], dtype=torch.int32, device=card)
    before = da.launches
    got = da.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    want = da.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if b > 1:
        assert not got[0].any()  # empty row gives 0


def test_wrapper_raises_on_a_cuda_input_the_kernel_does_not_take(card):
    q = torch.zeros(2, 8, 64, device=card, dtype=torch.float16)
    k = torch.zeros(2, 16, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, k, torch.zeros(2, dtype=torch.int32, device=card))


def test_serve_example_through_the_kernel(card):
    """Kernel path and plain path give equal placements and tokens."""
    requests = ex.make_requests(n=4)
    before = da.launches
    runs = {impl: ex.run("navigator", requests, lambda: ex.reduced_hosted(card),
                         device=card, impl=impl)[0]
            for impl in ("auto", "ref")}
    assert da.launches > before
    for a, b in zip(runs["auto"].results, runs["ref"].results):
        assert a.assignment == b.assignment
        for tid in b.outputs:
            np.testing.assert_array_equal(a.outputs[tid], b.outputs[tid])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,sq,sk,h,kh,d,causal,window,q_offset",
    [
        (1, 128, 128, 4, 4, 64, True, None, 0),      # MHA, aligned
        (2, 200, 200, 8, 2, 64, True, None, 0),      # GQA, ragged
        (2, 96, 96, 8, 1, 32, True, None, 0),        # MQA
        (1, 256, 256, 4, 2, 128, False, None, 0),    # bidirectional
        (2, 160, 160, 4, 4, 64, True, 64, 0),        # sliding window
        (1, 64, 64, 2, 2, 8, True, None, 0),         # tiny head dim
        (2, 1, 96, 4, 4, 32, True, None, 95),        # one query into a longer history
        (2, 70, 300, 4, 2, 128, True, None, 230),    # Sq != Sk, q_offset
        (1, 300, 300, 48, 1, 128, True, None, 0),    # granite's MQA, G = 48
        (2, 150, 150, 16, 16, 64, True, None, 0),    # whisper's head dim
        (2, 150, 150, 8, 8, 112, True, None, 0),     # zamba2's head dim
        (1, 150, 150, 4, 4, 192, True, None, 0),     # MLA's hd + rope dim
        (1, 130, 130, 2, 1, 256, True, None, 0),     # the largest head dim taken
        (2, 100, 100, 4, 2, 64, True, None, -30),    # rows 0..29 see no key
        (2, 64, 1500, 16, 16, 64, False, None, 0),   # whisper's cross-attention
        (2, 1500, 1500, 16, 16, 64, False, None, 0),  # whisper's encoder
        (2, 448, 448, 16, 16, 64, True, None, 0),    # whisper's decoder: 3.5 wgmma tiles
    ],
)
def test_flash_kernel_matches_plain_on_card(card, b, sq, sk, h, kh, d, causal, window,
                                            q_offset, dtype):
    g = torch.Generator(device=card).manual_seed(sq * h + d)
    q = torch.randn(b, sq, h, d, generator=g, device=card, dtype=dtype)
    k = torch.randn(b, sk, kh, d, generator=g, device=card, dtype=dtype)
    v = torch.randn(b, sk, kh, d, generator=g, device=card, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if q_offset < 0:
        assert not got[:, :-q_offset].any()  # a query that sees no key gives 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,t,h,p,n,chunk,with_state",
    [
        (1, 64, 2, 32, 16, 16, False),
        (2, 100, 3, 32, 16, 32, False),    # ragged chunks
        (1, 33, 1, 16, 8, 8, False),
        (2, 128, 4, 64, 32, 64, False),
        (2, 300, 4, 64, 128, 128, False),  # mamba2-780m's P, N and chunk, ragged T
        (1, 5, 2, 64, 128, 128, True),     # one short chunk, from a given state
        (2, 70, 3, 32, 16, 16, True),
    ],
)
def test_ssd_kernel_matches_plain_on_card(card, b, t, h, p, n, chunk, with_state, dtype):
    g = torch.Generator(device=card).manual_seed(t * h + p)
    x = (torch.randn(b, t, h, p, generator=g, device=card) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g, device=card))
    a = -torch.exp(torch.randn(h, generator=g, device=card) * 0.3)
    bb = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    cc = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    init = torch.randn(b, h, p, n, generator=g, device=card) if with_state else None
    before = ssd.launches
    y, fs = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    ye, fse = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk, initial_state=init)
    assert y.dtype == dtype and fs.dtype == torch.float32
    torch.testing.assert_close(y.float(), ye.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(fs, fse, **SSD_TOL[torch.float32])


def test_ssd_wrapper_raises_on_a_cuda_input_the_kernel_does_not_take(card):
    x = torch.zeros(1, 8, 2, 64, device=card)
    b = torch.zeros(1, 8, 2, 16, device=card)
    dt = torch.zeros(1, 8, 2, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, torch.zeros(2, device=card), b, b)


def test_ssd_smem_fits_mamba2_at_full_width(card):
    """L = 128, P = 64, N = 128 (mamba2-780m) fits one block's shared
    memory on this card; L = 256, N = 256 does not, and the wrapper says so."""
    _, smem_bytes = ssd._entry()
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    serial = ssd.BODIES["serial"]
    assert smem_bytes(128, 64, 128, 0, serial) <= limit < smem_bytes(256, 64, 256, 0, serial)
    for dtype in (0, 1):  # the chunked body's largest CTA, fp32 and bf16
        assert smem_bytes(128, 64, 128, dtype, ssd.BODIES["chunked"]) <= limit
    x = torch.zeros(1, 512, 1, 64, device=card)
    b = torch.zeros(1, 512, 1, 256, device=card)
    before = ssd.launches
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(x, torch.zeros(1, 512, 1, device=card), torch.zeros(1, device=card), b, b,
                     chunk=256)
    assert ssd.launches == before


@pytest.mark.parametrize("which", ["decode", "flash", "ssd", "gmm"])
def test_empty_input_launches_nothing(card, which):
    """No rows (or no queries): an empty output in the right shape, no launch."""
    def z(*shape):
        return torch.zeros(*shape, device=card)

    before = (da.launches, fa.launches, ssd.launches, gmm.launches)
    if which == "decode":
        out = da.decode_attention(z(0, 4, 8), z(0, 5, 2, 8), z(0, 5, 2, 8),
                                  torch.zeros(0, dtype=torch.int32, device=card))
        assert out.shape == (0, 4, 8)
    elif which == "flash":
        out = fa.flash_attention(z(2, 0, 4, 8), z(2, 5, 2, 8), z(2, 5, 2, 8))
        assert out.shape == (2, 0, 4, 8)
    elif which == "gmm":
        out = gmm.moe_gmm(z(0, 16), z(4, 16, 8), torch.zeros(4, dtype=torch.int32, device=card))
        assert out.shape == (0, 8)
    else:
        out, state = ssd.ssd_scan(z(0, 10, 3, 16), z(0, 10, 3), z(3), z(0, 10, 3, 8),
                                  z(0, 10, 3, 8), chunk=4)
        assert out.shape == (0, 10, 3, 16) and state.shape == (0, 3, 16, 8)
    assert (da.launches, fa.launches, ssd.launches, gmm.launches) == before


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "granite-20b", "mamba2-780m"])
def test_prefill_step_through_the_kernels(card, name):
    """A reduced fp32 model's prefill on the card launches each kernel once
    per layer and agrees with the plain path."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.randint(0, cfg.vocab, (2, 50), device=card)
    counter = fa if cfg.arch_type == "dense" else ssd
    before = counter.launches
    logits = make_prefill_step(cfg, device=card)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert counter.launches == before + cfg.n_layers
    want = make_prefill_step(cfg, impl="ref_chunked", device=card)(params, {"tokens": tokens})
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)


# the hybrid, VLM and audio families at reduced depth: zamba2 at its head
# dim 112 with two applications of the shared block over an 8-slot window
FAMILY_CFGS = {
    "zamba2-7b": dict(n_layers=4, attn_period=2, sliding_window=8, head_dim=112),
    "qwen2-vl-72b": {},
    "whisper-medium": {},
}


@pytest.mark.parametrize("name", sorted(FAMILY_CFGS))
def test_family_prefill_and_decode_through_the_kernels(card, name):
    """A reduced fp32 model of each family: its prefill launches flash
    attention once per attention layer (whisper: the encoder's, and the
    decoder's self- and cross-attention) and the SSD scan once per SSM
    layer, and 20 decode steps (zamba2's ring wraps twice) launch decode
    attention once per attention layer; both agree with the plain path."""
    import dataclasses

    cfg = dataclasses.replace(ARCHS[name].reduced(dtype="float32"), **FAMILY_CFGS[name])
    params = tm.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    g = torch.Generator(device=card).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=g, device=card)}
    n, attn = cfg.n_layers, cfg.n_layers
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.randn(2, 16, cfg.d_model, generator=g, device=card) * 0.02
    if cfg.arch_type == "audio":
        batch["audio_frames"] = torch.randn(2, cfg.n_audio_frames, cfg.d_model, generator=g,
                                            device=card) * 0.02
        attn = 2 * n
    if cfg.arch_type == "hybrid":
        attn = n // cfg.attn_period
    flash = attn + cfg.n_encoder_layers
    before = (fa.launches, ssd.launches)
    logits = make_prefill_step(cfg, device=card)(params, batch)
    torch.cuda.synchronize()
    assert (fa.launches, ssd.launches) == (before[0] + flash,
                                           before[1] + (n if cfg.arch_type == "hybrid" else 0))
    want = make_prefill_step(cfg, impl="ref_chunked", device=card)(params, batch)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    caches = {impl: tm.init_cache(cfg, 2, 24, device=card) for impl in ("auto", "ref")}
    for i in range(20):
        before = da.launches
        got, _ = tm.decode_step(params, caches["auto"], batch["tokens"][:, i], cfg)
        assert da.launches == before + attn
        plain, _ = tm.decode_step(params, caches["ref"], batch["tokens"][:, i], cfg, impl="ref")
        torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    for key in caches["ref"]:
        torch.testing.assert_close(caches["auto"][key], caches["ref"][key], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------
GMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "t,d_in,d_out,sizes",
    [
        (50, 64, 48, [13, 0, 30, 7]),
        (17, 16, 64, [5, 12, 0]),            # ragged everything
        (17, 17, 33, [9, 8]),                # widths that are no whole 16-byte vector
        (20, 16, 8, [0, 20, 0, 0, 0]),       # empty groups
        (64, 128, 96, [64]),                 # single expert == plain matmul
        (30, 24, 40, [10, 0, 20, 0]),        # trailing empty group
        (12, 8, 4, [4, 5, 0]),               # rows past the sizes' sum: the last expert's
        (16, 256, 96, "decode"),             # 16 rows over 128 experts, as sorted decode
        (1000, 256, 384, "uneven"),          # many row tiles, several column tiles
    ],
)
def test_gmm_kernel_matches_plain_on_card(card, t, d_in, d_out, sizes, dtype):
    g = torch.Generator(device=card).manual_seed(t + d_in)
    if sizes == "decode":
        sizes = torch.bincount(torch.randint(0, 128, (t,), generator=g, device=card),
                               minlength=128).tolist()
    elif sizes == "uneven":
        sizes = [500, 0, 3, 250, 1, 0, 246, 0]
    e = len(sizes)
    x = torch.randn(t, d_in, generator=g, device=card).to(dtype)
    w = (torch.randn(e, d_in, d_out, generator=g, device=card) / d_in ** 0.5).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    before = gmm.launches
    got = gmm.moe_gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gmm.launches == before + 1 and got.dtype == dtype
    want = gmm.moe_gmm_plain(x, w, gs)
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_gmm_wrapper_raises_on_a_cuda_input_the_kernel_does_not_take(card):
    x = torch.zeros(8, 16, device=card, dtype=torch.float16)
    w = torch.zeros(2, 16, 8, device=card, dtype=torch.float16)
    gs = torch.tensor([3, 5], dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        gmm.moe_gmm(x, w, gs)
    with pytest.raises(ValueError, match="group_sizes is on"):
        gmm.moe_gmm(x.float(), w.float(), gs.cpu())
    with pytest.raises(ValueError, match="int32"):
        gmm.moe_gmm(x.float(), w.float(), gs.long())


def test_gmm_never_waits_for_the_card(card):
    """The wrapper reads no value of ``group_sizes`` on the host: with
    PyTorch's sync debug mode set to raise, a call (and the sorted MoE
    dispatch around it) goes through."""
    from repro_torch.models import moe as moe_mod

    x = torch.randn(32, 64, device=card, dtype=torch.bfloat16)
    p = {"router": torch.randn(64, 16, device=card),
         **{k: torch.randn(16, *s, device=card, dtype=torch.bfloat16) * 0.1
            for k, s in (("wg", (64, 32)), ("wu", (64, 32)), ("wd", (32, 64)))}}
    gs = torch.tensor([8] * 4 + [0] * 12, dtype=torch.int32, device=card)
    gmm.moe_gmm(x, p["wg"], gs)  # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gmm.moe_gmm(x, p["wg"], gs)
        moe_mod.moe_ffn(x[None], p, top_k=2, dispatch="sorted")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_prefill_and_decode_through_the_kernels(card, name):
    """A reduced fp32 MoE model's prefill launches flash attention once and
    the grouped matmul three times per layer, and its sorted decode the
    decode kernel once and the grouped matmul three times per layer; both
    agree with the plain path."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=card)
    before = (fa.launches, gmm.launches)
    logits = make_prefill_step(cfg, device=card)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert (fa.launches, gmm.launches) == (before[0] + cfg.n_layers,
                                           before[1] + 3 * cfg.n_layers)
    want = make_prefill_step(cfg, impl="ref_chunked", device=card)(params, {"tokens": tokens})
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    caches = {impl: tm.init_cache(cfg, 2, 8, device=card) for impl in ("auto", "ref")}
    for i in range(6):
        before = (da.launches, gmm.launches)
        got, _ = tm.decode_step(params, caches["auto"], tokens[:, i], cfg)
        assert (da.launches, gmm.launches) == (before[0] + cfg.n_layers,
                                               before[1] + 3 * cfg.n_layers)
        plain, _ = tm.decode_step(params, caches["ref"], tokens[:, i], cfg, impl="ref")
        torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the wgmma bodies against the mma.sync bodies and the plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,sq,sk,h,kh,d,causal,window,q_offset",
    [
        (2, 200, 200, 8, 2, 64, True, None, 0),      # partial tiles
        (1, 1000, 1000, 4, 2, 64, True, None, 0),
        (2, 200, 200, 4, 2, 128, True, None, 0),
        (1, 1000, 1000, 4, 4, 128, True, None, 0),
        (2, 200, 200, 4, 4, 192, True, None, 0),     # MLA's hd + rope dim
        (1, 1000, 1000, 2, 2, 192, True, None, 0),
        (1, 130, 130, 2, 1, 256, True, None, 0),
        (2, 70, 300, 4, 2, 128, True, None, 230),    # Sq != Sk, q_offset
        (1, 300, 700, 4, 2, 192, True, None, 400),
        (2, 333, 333, 4, 2, 128, True, 64, 0),       # window 64
        (2, 300, 300, 4, 2, 192, True, 64, 0),
        (1, 300, 300, 16, 1, 128, True, None, 0),    # MQA
        (1, 256, 256, 4, 2, 64, False, None, 0),     # bidirectional
        (2, 200, 200, 4, 2, 128, True, None, -64),   # rows 0..63 see no key
    ],
)
def test_flash_wgmma_body_matches_mma_body_and_plain(card, b, sq, sk, h, kh, d, causal, window,
                                                     q_offset):
    g = torch.Generator(device=card).manual_seed(sq + sk + d)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=card, dtype=torch.bfloat16)
               for s, n in ((sq, h), (sk, kh), (sk, kh)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fa.body_for(q.dtype, d) == "wgmma"
    before = (fa.launches_by_body.get("wgmma", 0), fa.launches_by_body.get("mma", 0))
    new = fa.flash_attention(q, k, v, **kw).float()
    old = fa.flash_attention(q, k, v, body="mma", **kw).float()
    torch.cuda.synchronize()
    assert (fa.launches_by_body["wgmma"], fa.launches_by_body["mma"]) == (before[0] + 1,
                                                                          before[1] + 1)
    want = fa.flash_attention_plain(q, k, v, **kw).float()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(new, want, atol=tol, rtol=tol)
    torch.testing.assert_close(new, old, atol=tol, rtol=tol)
    if q_offset < 0:
        assert not new[:, :-q_offset].any()  # a query that sees no key gives 0


@pytest.mark.parametrize(
    "t,d_in,d_out,sizes",
    [
        (384, 256, 256, [127, 128, 129]),      # groups across the 128-row tile's edge
        (40, 512, 384, [10, 0, 30]),           # T below one tile
        (1000, 256, 776, "five empty"),        # 128 experts, 5 empty; a partial column tile
        (700, 2048, 768, [700]),               # a single expert
        (333, 1000, 776, [100, 200, 33]),      # partial depth and column tiles
        (16, 2048, 768, "decode"),             # 16 rows over 128 experts
    ],
)
def test_gmm_wgmma_body_matches_mma_body_and_plain(card, t, d_in, d_out, sizes):
    g = torch.Generator(device=card).manual_seed(t + d_out)
    if sizes == "five empty":
        sizes = [0] * 5 + [t // 123] * 123
        sizes[-1] += t - sum(sizes)
    elif sizes == "decode":
        sizes = torch.bincount(torch.randint(0, 128, (t,), generator=g, device=card),
                               minlength=128).tolist()
    e = len(sizes)
    x = torch.randn(t, d_in, generator=g, device=card).to(torch.bfloat16)
    w = (torch.randn(e, d_in, d_out, generator=g, device=card) / d_in ** 0.5).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    assert gmm.body_for(x.dtype, d_in, d_out, n_experts=e) == "wgmma"
    before = (gmm.launches_by_body.get("wgmma", 0), gmm.launches_by_body.get("mma", 0))
    new = gmm.moe_gmm(x, w, gs).float()
    old = gmm.moe_gmm(x, w, gs, body="mma").float()
    torch.cuda.synchronize()
    assert (gmm.launches_by_body["wgmma"], gmm.launches_by_body["mma"]) == (before[0] + 1,
                                                                            before[1] + 1)
    want = gmm.moe_gmm_plain(x, w, gs).float()
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(new, want, atol=tol, rtol=tol)
    torch.testing.assert_close(new, old, atol=tol, rtol=tol)


def test_named_wgmma_body_raises_where_it_cannot_take_the_shape(card):
    q = torch.zeros(1, 64, 4, 112, device=card, dtype=torch.bfloat16)  # zamba2's head dim
    before = (fa.launches, gmm.launches)
    with pytest.raises(ValueError, match="wgmma"):
        fa.flash_attention(q, q, q, body="wgmma")
    x = torch.zeros(8, 999, device=card, dtype=torch.bfloat16)
    w = torch.zeros(2, 999, 777, device=card, dtype=torch.bfloat16)
    gs = torch.tensor([3, 5], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="wgmma"):
        gmm.moe_gmm(x, w, gs, body="wgmma")
    assert (fa.launches, gmm.launches) == before


# ---------------------------------------------------------------------------
# the split decode body and the chunked SSD body against the bodies they
# replace and the plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 112, 128, 192, 256])
@pytest.mark.parametrize("g", [1, 4, 48])
def test_decode_split_body_matches_single_body_and_plain(card, g, d, dtype):
    """KH = 2 and B = 4 over 700 slots give 11 splits of 64 slots; the
    lengths cover an empty row, one slot, both sides of a split's edge,
    the edge itself and the whole cache."""
    b, kh, t = 4, 2, 700
    sms = da.sm_count(card)
    assert da.splits_for(b, kh, t, sms) == 11 and da.body_for(dtype, d, g, 11) == "split"
    per = da.slots_per_split(t, da.splits_for(b, kh, t, sms))
    gen = torch.Generator(device=card).manual_seed(g * d)
    q = torch.randn(b, g * kh, d, generator=gen, device=card, dtype=dtype)
    k = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=dtype)
    v = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=dtype)
    tol = TOL[dtype]
    for lens in ([0, 1, per - 1, per + 1], [per, 2 * per, t - 1, t]):
        n = torch.tensor(lens, dtype=torch.int32, device=card)
        before = (da.launches, da.launches_by_body.get("split", 0),
                  da.launches_by_body.get("single", 0))
        new = da.decode_attention(q, k, v, n).float()
        old = da.decode_attention(q, k, v, n, body="single").float()
        torch.cuda.synchronize()
        assert (da.launches, da.launches_by_body["split"], da.launches_by_body["single"]) == (
            before[0] + 2, before[1] + 1, before[2] + 1)
        want = da.decode_attention_plain(q, k, v, n).float()
        torch.testing.assert_close(new, want, atol=tol, rtol=tol)
        torch.testing.assert_close(new, old, atol=tol, rtol=tol)
        assert decode_close(new, want, dtype)
        if lens[0] == 0:
            assert not new[0].any()  # an empty row gives 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,d,t", [
    (2, 32, 8, 128, 13),     # NeMo's serving shape: one split, no combine
    (2, 48, 1, 128, 13),     # granite's: every query row in one CTA
    (2, 48, 1, 128, 5000),   # many splits, a partial last tile
    (1, 128, 1, 64, 300),    # 128 query rows per KV head (bf16: one CTA; fp32: single only)
    (2, 8, 8, 128, 0),       # no slot at all (the plain version takes none): 0
])
def test_decode_split_body_at_the_edges(card, b, h, kh, d, t, dtype):
    """Through the body the wrapper picks and, where it takes the shape
    and is not that body, through the split body by name."""
    gen = torch.Generator(device=card).manual_seed(t + h)
    q = torch.randn(b, h, d, generator=gen, device=card, dtype=dtype)
    k = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=dtype)
    v = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=dtype)
    n = torch.randint(0, t + 1, (b,), generator=gen, device=card, dtype=torch.int32)
    found = da.bodies_for(dtype, d, h // kh, da.splits_for(b, kh, t, da.sm_count(card)))
    for body in [None] + [x for x in found[1:] if x == "split"]:
        got = da.decode_attention(q, k, v, n, body=body).float()
        torch.cuda.synchronize()
        if t == 0:
            assert not got.any()
            continue
        want = da.decode_attention_plain(q, k, v, n).float()
        torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
        assert decode_close(got, want, dtype)


def test_decode_never_waits_for_the_card(card):
    """Neither body reads ``cache_len`` on the host: with PyTorch's sync
    debug mode set to raise, a call with several splits, one with one split
    and one through the single body go through."""
    q = torch.randn(2, 48, 128, device=card, dtype=torch.bfloat16)
    k = torch.randn(2, 4096, 1, 128, device=card, dtype=torch.bfloat16)
    n = torch.tensor([4000, 17], dtype=torch.int32, device=card)
    short = k[:, :13].contiguous()
    da.decode_attention(q, k, k, n)  # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da.decode_attention(q, k, k, n)
        da.decode_attention(q, short, short, n)
        da.decode_attention(q, k, k, n, body="single")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,chunk,with_state", [
    (2, 2000, 4, 64, 128, 128, False),   # mamba2-780m's P, N and chunk; a partial last chunk
    (2, 2000, 4, 64, 128, 64, False),    # the ops default chunk
    (2, 2000, 3, 64, 64, 128, True),     # zamba2's N, from a given state
    (1, 8192, 8, 64, 128, 128, False),   # a long sequence: s reaches hundreds in a chunk
    (1, 100, 2, 64, 128, 128, True),     # T < chunk: one chunk
    (2, 70, 3, 32, 16, 16, True),        # narrow P and N (padded to 16 in bf16)
    (1, 33, 2, 16, 8, 8, False),
])
def test_ssd_chunked_body_matches_serial_body_and_plain(card, b, t, h, p, n, chunk, with_state,
                                                       dtype):
    g = torch.Generator(device=card).manual_seed(t + p + n)
    x = (torch.randn(b, t, h, p, generator=g, device=card) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g, device=card))
    a = -torch.exp(torch.randn(h, generator=g, device=card) * 0.3)
    bb = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    cc = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    init = torch.randn(b, h, p, n, generator=g, device=card) if with_state else None
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    length = min(chunk, t)
    nc = -(-t // length)
    per_sm = ssd.fused_blocks_per_sm(card, length, p, n, 1) if dtype == torch.bfloat16 else 0
    assert ssd.body_for(dtype, p, n, length, b * h, sms, nc, per_sm) == (
        "fused" if dtype == torch.bfloat16 and b * h * nc <= sms * per_sm else "chunked")
    before = (ssd.launches, ssd.launches_by_body.get("chunked", 0),
              ssd.launches_by_body.get("serial", 0))
    y, fs = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init, body="chunked")
    yo, fso = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init, body="serial")
    torch.cuda.synchronize()
    assert (ssd.launches, ssd.launches_by_body["chunked"], ssd.launches_by_body["serial"]) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    if dtype == torch.bfloat16 and b * h * nc <= sms * per_sm:  # fused: chunked's bits
        before = ssd.launches_by_body.get("fused", 0)
        yf, fsf = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init, body="fused")
        torch.cuda.synchronize()
        assert ssd.launches_by_body["fused"] == before + 1
        assert torch.equal(yf, y) and torch.equal(fsf, fs)
    elif dtype == torch.bfloat16:  # a grid beyond one wave: refused, no launch
        before = ssd.launches
        with pytest.raises(ValueError, match="one wave"):
            ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init, body="fused")
        assert ssd.launches == before
    ye, fse = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk, initial_state=init)
    assert y.dtype == dtype and fs.dtype == torch.float32
    torch.testing.assert_close(y.float(), ye.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(y.float(), yo.float(), **SSD_TOL[dtype])
    # the state at the fp32 tolerance in both dtypes
    torch.testing.assert_close(fs, fse, **SSD_TOL[torch.float32])
    torch.testing.assert_close(fs, fso, **SSD_TOL[torch.float32])


@pytest.mark.parametrize("spare", [True, False])
def test_ssd_fp32_body_follows_the_cards_sms(card, spare):
    """fp32 runs the chunked body where the serial body's B·H CTAs would
    fill at most two thirds of the card's SMs, and the serial body
    elsewhere; both agree with the plain version."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    b, h = (1, 2 * sms // 3) if spare else (1, 2 * sms // 3 + 1)
    g = torch.Generator(device=card).manual_seed(h)
    x = torch.randn(b, 40, h, 16, generator=g, device=card)
    dt = torch.nn.functional.softplus(torch.randn(b, 40, h, generator=g, device=card))
    a = -torch.exp(torch.randn(h, generator=g, device=card) * 0.3)
    bb, cc = (torch.randn(b, 40, h, 8, generator=g, device=card) for _ in range(2))
    want = "chunked" if spare else "serial"
    assert ssd.body_for(torch.float32, 16, 8, 16, b * h, sms) == want
    before = ssd.launches_by_body.get(want, 0)
    y, fs = ssd.ssd_scan(x, dt, a, bb, cc, chunk=16)
    torch.cuda.synchronize()
    assert ssd.launches_by_body[want] == before + 1
    ye, fse = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=16)
    torch.testing.assert_close(y, ye, **SSD_TOL[torch.float32])
    torch.testing.assert_close(fs, fse, **SSD_TOL[torch.float32])


def test_named_split_and_chunked_bodies_raise_where_they_cannot_take_the_shape(card):
    q = torch.zeros(1, 65, 64, device=card)  # fp32 with 65 query rows per KV head
    k = torch.zeros(1, 16, 1, 64, device=card)
    n = torch.ones(1, dtype=torch.int32, device=card)
    x = torch.zeros(1, 512, 1, 64, device=card, dtype=torch.bfloat16)
    bb = torch.zeros(1, 512, 1, 16, device=card, dtype=torch.bfloat16)
    dt, a = torch.zeros(1, 512, 1, device=card), torch.zeros(1, device=card)
    before = (da.launches, ssd.launches)
    with pytest.raises(ValueError, match="split"):
        da.decode_attention(q, k, k, n, body="split")
    with pytest.raises(ValueError, match="chunked"):
        ssd.ssd_scan(x, dt, a, bb, bb, chunk=256, body="chunked")
    assert (da.launches, ssd.launches) == before


# ---------------------------------------------------------------------------
# the execution engine's CUDA graphs (the counterpart of jax.jit)
# ---------------------------------------------------------------------------
# one reduced config of each family that serving decodes; zamba2's shared
# block rings over 8 slots, so a 10-step task wraps it
GRAPH_CFGS = {
    "mistral-nemo-12b": {},
    "mamba2-780m": {},
    "qwen3-moe-30b-a3b": {},
    "deepseek-v2-236b": {},
    "zamba2-7b": FAMILY_CFGS["zamba2-7b"],
    "whisper-medium": {},
    "qwen2-vl-72b": {},
}


def graph_engine(card, name, dtype, decode_tokens=4):
    import dataclasses

    from repro_torch.serving import ExecutionEngine, HostedModel

    cfg = dataclasses.replace(ARCHS[name].reduced(dtype=dtype), **GRAPH_CFGS[name])
    params = tm.init_params(cfg, torch.Generator(device=card).manual_seed(3), card)
    engine = ExecutionEngine({0: HostedModel(0, cfg, params, card)},
                             decode_tokens=decode_tokens, device=card)
    return cfg, params, engine


def eager_task(cfg, params, prompt, decode_tokens, card):
    """The engine's loop without a graph: a fresh cache, eager steps."""
    b, s = prompt.shape
    cache = tm.init_cache(cfg, b, s + decode_tokens + 1, device=card)
    toks = torch.as_tensor(prompt, device=card)
    for i in range(s):
        logits, cache = tm.decode_step(params, cache, toks[:, i], cfg, moe_dispatch="scan")
    nxt, out = torch.argmax(logits, dim=-1), []
    for _ in range(decode_tokens):
        out.append(nxt)
        logits, cache = tm.decode_step(params, cache, nxt, cfg, moe_dispatch="scan")
        nxt = torch.argmax(logits, dim=-1)
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GRAPH_CFGS))
def test_graphed_run_task_gives_the_eager_tokens(card, name, dtype):
    """A task replayed from the engine's graph gives the eager loop's
    tokens, and a second task of the same shape replays the same graph."""
    cfg, params, engine = graph_engine(card, name, dtype)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    got, _ = engine.run_task(0, prompt)
    np.testing.assert_array_equal(got, eager_task(cfg, params, prompt, 4, card))
    assert engine.captures == 1 and engine.replays == 6 + 4
    other = rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    got, _ = engine.run_task(0, other)
    np.testing.assert_array_equal(got, eager_task(cfg, params, other, 4, card))
    assert engine.captures == 1 and engine.replays == 2 * (6 + 4)
    assert list(engine.graphs) == [(0, 2, 11)]
    engine.close()
    assert engine.graphs == {} and engine.caches == {}


def test_replayed_launches_are_the_cards(card):
    """The launches the engine counts under replay are the decode kernels
    the profiler sees on the card: one main kernel per call."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, engine = graph_engine(card, "mistral-nemo-12b", "bfloat16")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    before = da.launches
    engine.run_task(0, prompt)  # captures: one eager warm-up step
    assert da.launches == before + cfg.n_layers
    assert engine.graphs[(0, 2, 11)].launches["decode_attention"] == cfg.n_layers
    engine.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run_task(0, prompt)
    torch.cuda.synchronize()
    assert da.launches == before + cfg.n_layers  # replays do not touch the wrapper's count
    seen = sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and ("decode_split" in e.key or "decode_attention_kernel" in e.key))
    assert seen == engine.replayed_launches["decode_attention"] == (6 + 4) * cfg.n_layers
    assert engine.replayed_by_body["decode_attention"] == {"split": (6 + 4) * cfg.n_layers}


def test_spans_and_task_times_on_the_card(card):
    """With ``spans`` on, a graph key new to the engine shows one
    ``compass.capture``, each ``compass.replay`` holds the one
    ``cudaGraphLaunch`` whose correlation id its kernels carry, and each
    task leaves one ``TaskTime`` and records two CUDA events; off, a task
    of a captured key records no range and no CUDA event; the tokens are
    the same either way."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import ExecutionEngine, HostedModel

    cfg = ARCHS["mamba2-780m"].reduced(dtype="bfloat16")
    params = tm.init_params(cfg, torch.Generator(device=card).manual_seed(3), card)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=(2, s)).astype(np.int32) for s in (6, 6, 9)]
    cuda = torch.autograd.DeviceType.CUDA

    def profiled(engine, batch):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tokens = [engine.run_task(0, p)[0] for p in batch]
        torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        names = collections.Counter(e.name() for e in events if e.device_type() != cuda)
        ranges = {k: v for k, v in names.items() if k.startswith("compass.")}
        recorded = sum(v for k, v in names.items() if k.startswith("cudaEventRecord"))
        return tokens, events, ranges, recorded

    runs = {}
    for spans in (False, True):
        engine = ExecutionEngine({0: HostedModel(0, cfg, params, card)}, decode_tokens=4,
                                 device=card, spans=spans)
        runs[spans] = (engine, profiled(engine, prompts), profiled(engine, prompts[:1]))
    for spans, (engine, (tokens, events, ranges, _), (_, _, again, recorded)) in runs.items():
        if not spans:
            assert ranges == again == {} and recorded == 0 and engine.task_times == []
            continue
        steps = sum(p.shape[1] + 4 for p in prompts)
        assert ranges == {"compass.run_task": 3, "compass.capture": 2, "compass.zero_cache": 3,
                          "compass.replay": steps, "compass.to_host": 3}
        assert "compass.capture" not in again and recorded == 2
        times = engine.task_times
        assert [t.key for t in times] == [(0, 2, 11), (0, 2, 11), (0, 2, 14), (0, 2, 11)]
        assert [t.replays for t in times] == [10, 10, 13, 10]
        assert all(t.device_s > 0 for t in times)
        assert all(a.host_s < b.host_s for a, b in zip(times, times[1:]))
        replays = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name() == "compass.replay" and e.device_type() != cuda]
        launches = [e for e in events if e.name().startswith("cudaGraphLaunch")]
        assert len(launches) == steps
        for e in launches:
            assert sum(a <= e.start_ns() < b for a, b in replays) == 1
        kernels = collections.Counter(e.correlation_id() for e in events
                                      if e.device_type() == cuda)
        assert all(kernels[e.correlation_id()] > 0 for e in launches)
        engine.reset_counts()
        assert engine.task_times == [] and engine.replays == 0
    for a, b in zip(runs[False][1][0], runs[True][1][0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPH_CFGS))
def test_decode_step_captures_under_sync_debug_error(card, name):
    """Nothing on a captured decode step waits for the card: with
    PyTorch's sync debug mode set to raise, the capture goes through."""
    cfg, params, _ = graph_engine(card, name, "bfloat16")
    cache = tm.init_cache(cfg, 2, 12, device=card)
    tokens = torch.ones(2, dtype=torch.long, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tm.decode_step(params, cache, tokens, cfg, moe_dispatch="scan")  # builds and loads
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = tm.decode_step(params, cache, tokens, cfg, moe_dispatch="scan")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    graph.replay()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())


# ---------------------------------------------------------------------------
# the vectorized Navigator planner on the card, and the H100 constants
# ---------------------------------------------------------------------------
def planner_setup(n):
    """The paper's workflows on ``H100_CLUSTER`` at ``n`` workers over four
    racks, every third card with 94 GB, and seeded SST rows with every
    lane on: dead and suspect rows, fresh and stale intents, in-flight
    fetches with their ETAs."""
    import dataclasses

    from repro_torch.core import (H100_CLUSTER, NavigatorConfig, ProfileRepository, SSTRow,
                                  rack_topology)
    from repro_torch.workflows import MODELS, paper_dfgs

    cluster = dataclasses.replace(
        H100_CLUSTER, n_workers=n, topology=rack_topology([n // 4] * 3 + [n - 3 * (n // 4)]),
        worker_gpu_capacity={w: 94e9 if w % 3 == 0 else 80e9 for w in range(n)})
    profiles = ProfileRepository(cluster, MODELS)
    for d in paper_dfgs():
        profiles.register(d)
    cfg = NavigatorConfig(eviction_penalty_s=1.5, intent_confidence=0.7, intent_herd_margin=0.15,
                          suspect_penalty_s=3.0)
    rng = np.random.default_rng(n)

    def rows():
        bits = rng.random((n, 8)) < 0.25
        intent = bits | (rng.random((n, 8)) < 0.25)
        weights = 1 << np.arange(8)
        fetch = rng.integers(-1, 8, n)
        live = rng.choice(["alive"] * 6 + ["suspect", "dead"], n)
        return [SSTRow(ft_estimate_s=float(rng.uniform(0, 5)), cache_bitmap=int(bits[w] @ weights),
                       free_cache_bytes=float(rng.uniform(0, 80e9)),
                       pushed_at=float(rng.choice([1.0, -30.0])),
                       intent_bitmap=int(intent[w] @ weights), liveness=str(live[w]),
                       fetch_model_id=int(fetch[w]),
                       fetch_eta_s=float(rng.uniform(0.5, 3.0)) if fetch[w] >= 0 else 0.0)
                for w in range(n)]

    return profiles, cfg, rows, paper_dfgs()


def test_planner_graph_equals_eager_at_1000_workers(card):
    """Through its CUDA graphs the planner gives the eager loop's plans bit
    for bit, and the Python Navigator's assignments, at W = 1,000 with
    every lane on and the recorder on and off."""
    from repro_torch.core import FlightRecorder, Job, NavigatorScheduler
    from repro_torch.core.torch_planner import TorchNavigatorPlanner

    n = 1000
    profiles, cfg, rows, dfgs = planner_setup(n)
    graphed = TorchNavigatorPlanner(profiles, cfg, device=card)
    eager = TorchNavigatorPlanner(profiles, cfg, device=card)
    eager._outputs = lambda name, static, comps: eager._plan(static, comps)  # the eager loop
    py = NavigatorScheduler(profiles, cfg)
    for traced in (False, True):
        for p in (eager, graphed):
            p.recorder = FlightRecorder(n) if traced else None
        for j in range(12):
            d = dfgs[j % len(dfgs)]
            sst, origin, job = rows(), (97 * j) % n, Job(j, d, 1.0)
            a = eager.plan(job, 1.0, origin, sst)
            b = graphed.plan(job, 1.0, origin, sst)
            assert a.assignment == b.assignment == py.plan(job, 1.0, origin, sst).assignment
            assert a.planned_ft == b.planned_ft
        if traced:
            assert eager.recorder.to_jsonl() == graphed.recorder.to_jsonl()
    assert eager.graphs == {} and len(graphed.graphs) == 2 * len(dfgs)
    assert all(g.replays >= 1 for g in graphed.graphs.values())


def test_planner_captures_under_sync_debug_error(card):
    """Nothing on a captured plan waits for the card: ``_graph`` captures
    under sync debug mode "error", and a replay between two loads of the
    feed needs no synchronize of its own."""
    from repro_torch.core import Job
    from repro_torch.core.torch_planner import TorchNavigatorPlanner, build_static_inputs

    profiles, cfg, rows, dfgs = planner_setup(64)
    planner = TorchNavigatorPlanner(profiles, cfg, device=card)
    d = dfgs[0]
    static = build_static_inputs(profiles, d)
    planner._feed.load(planner._pack_feed(rows(), 1.0, 64), 1.0, 3)
    g = planner._graph(d.name, static, False)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = g.replay()
        planner._feed.load(planner._pack_feed(rows(), 2.0, 64), 2.0, 5)
        out = g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = planner._plan(static, False)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    adfg = planner.plan(Job(0, d, 2.0), 2.0, 5, rows())
    assert set(adfg.assignment) == set(d.tasks)


def test_h100_cluster_matches_the_card(card):
    """``H100_CLUSTER``'s link, latencies and power are this card's, within
    phase 5b's 25 % (``chip_smoke.py``)."""
    import time

    from repro_torch import probe
    from repro_torch.core import H100_CLUSTER

    torch.cuda.synchronize()
    time.sleep(2.0)  # let the card settle after the earlier tests
    link = probe.fresh_readings()  # a process that never ran the profiler
    readings = {
        "rate": (link["bandwidth_bytes_per_s"], H100_CLUSTER.link.bandwidth_bytes_per_s),
        "delta": (link["delta_s"], H100_CLUSTER.link.delta_s),
        "d2d": (link["d2d_delta_s"], H100_CLUSTER.network.delta_s),
        "idle": (link["idle_power_w"], H100_CLUSTER.gpu_power_idle_w),
        "limit": (probe.power_limit_w(), H100_CLUSTER.gpu_power_active_w),
    }
    for what, (reading, constant) in readings.items():
        assert abs(constant - reading) <= 0.25 * reading, (what, reading, constant)


# ---------------------------------------------------------------------------
# training: the flash backward kernel, the forward's LSE, train steps
# ---------------------------------------------------------------------------
def grad_close(got, want, dtype):
    """The flash backward's check, chip_smoke.py's phase 2e: scaled to each
    row.  bf16: the error within 2e-2 of the row's largest |want|, floored
    at 1e-3 of the tensor's largest (a row whose gradient cancels to ~0 is
    held to the tensor's scale).  fp32: atol = rtol = 2e-5, the atol times
    the row's largest |want| where that passes 1 (dk and dv sum G·Sq
    terms, and fp32 rounds the sum to its own scale)."""
    tol = TOL[dtype]
    got, want = got.float(), want.float()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    err = (got - want).abs()
    if dtype == torch.float32:
        return bool((err <= tol * rowmax.clamp(min=1.0) + tol * want.abs()).all())
    return bool((err <= tol * rowmax.clamp(min=1e-3 * float(want.abs().max()))).all())


# (b, sq, sk, h, kh, d, causal, window, q_offset): phase 2e's shapes, then
# ragged and offset ones
BWD_SHAPES = [
    (2, 2048, 2048, 32, 8, 128, True, None, 0),     # mistral-nemo-12b's training shape
    (2, 1024, 1024, 48, 1, 128, True, None, 0),     # granite's MQA
    (2, 1500, 1500, 16, 16, 64, False, None, 0),    # whisper's encoder
    (2, 2048, 2048, 32, 32, 112, True, 4096, 0),    # zamba2's shared block, its window
    (1, 300, 300, 8, 2, 128, True, 100, 0),         # a window inside the band
    (2, 77, 200, 4, 2, 64, True, None, 123),        # ragged Sq != Sk with q_offset
    (2, 100, 100, 4, 2, 64, True, None, -30),       # rows 0..29 see no key
    (1, 130, 130, 2, 1, 256, True, None, 0),        # the widest head dim: fp32 body in bf16
    (2, 65, 65, 4, 4, 32, False, None, 0),          # small head dim, one ragged tile
]


def bwd_inputs(card, shape, dtype):
    b, sq, sk, h, kh, d, causal, window, q_offset = shape
    g = torch.Generator(device=card).manual_seed(sq + 7 * h + d)
    q = torch.randn(b, sq, h, d, generator=g, device=card, dtype=dtype)
    k = torch.randn(b, sk, kh, d, generator=g, device=card, dtype=dtype)
    v = torch.randn(b, sk, kh, d, generator=g, device=card, dtype=dtype)
    do = torch.randn(b, sq, h, d, generator=g, device=card, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return q, k, v, out.contiguous(), do, lse, kw


@pytest.mark.parametrize("body", ["wgmma", "mma", "fp32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain_on_card(card, shape, dtype, body):
    from repro_torch.kernels import flash_attention_bwd as fb

    d = shape[5]
    if body not in fb.bodies_for(dtype, d):
        pytest.skip(f"the {body} body does not take {dtype} at D={d}")
    if body == "fp32" and shape[1] * shape[2] * shape[3] > 2048 * 2048 * 16:
        pytest.skip("the CUDA-core body is held at the smaller shapes")
    q, k, v, out, do, lse, kw = bwd_inputs(card, shape, dtype)
    before, by_body = fb.launches, fb.launches_by_body.get(body, 0)
    got = fb.flash_attention_bwd(q, k, v, out, do, lse, body=body, **kw)
    torch.cuda.synchronize()
    assert fb.launches == before + 1 and fb.launches_by_body[body] == by_body + 1
    want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == w.shape
        assert grad_close(x, w, dtype), f"{name}: max err {float((x.float() - w.float()).abs().max())}"
    if kw["q_offset"] < 0:
        assert not got[0][:, :-kw["q_offset"]].any()  # a query that sees no key: dq = 0


@pytest.mark.parametrize("shape,body", [(BWD_SHAPES[4], "mma"), (BWD_SHAPES[4], "wgmma"),
                                        (BWD_SHAPES[1], "wgmma")],
                         ids=["window-mma", "window-wgmma", "granite-split-wgmma"])
def test_flash_bwd_takes_a_strided_grad_and_repeats_bit_for_bit(card, shape, body):
    """The same gradients from a strided dO as from a contiguous one, bit
    for bit, and again on a second call: no atomics, the split's partials
    included (granite's MQA is split over CTAs on an H100)."""
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, out, do, lse, kw = bwd_inputs(card, shape, torch.bfloat16)
    b, _, h, _ = q.shape
    if shape is BWD_SHAPES[1]:
        assert fb.splits_for(b, k.shape[1], k.shape[2], h // k.shape[2], fb.sm_count(card)) > 1
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)  # same values, other strides
    assert not strided.is_contiguous()
    before = fb.launches_by_body.get(body, 0)
    a = fb.flash_attention_bwd(q, k, v, out, strided, lse, body=body, **kw)
    b = fb.flash_attention_bwd(q, k, v, out, do, lse, body=body, **kw)
    c = fb.flash_attention_bwd(q, k, v, out, do, lse, body=body, **kw)
    assert fb.launches_by_body[body] == before + 3
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(y, z)


@pytest.mark.parametrize("case,body", [("d112", "mma"), ("unaligned", "fp32")])
def test_flash_bwd_routes_d112_to_mma_and_unaligned_to_fp32(card, case, body):
    """zamba2's head dim goes to the mma body; an input off a 16-byte
    boundary (no TMA source, and mma loads 16 bytes a thread) to the fp32
    body; naming wgmma for either raises, and mma for the unaligned one."""
    from repro_torch.kernels import flash_attention_bwd as fb

    shape = (1, 130, 130, 4, 2, 112 if case == "d112" else 128, True, None, 0)
    q, k, v, out, do, lse, kw = bwd_inputs(card, shape, torch.bfloat16)
    if case == "unaligned":  # the same values one element past an aligned start
        buf = torch.empty(q.numel() + 1, device=card, dtype=q.dtype)
        buf[1:].copy_(q.flatten())
        q = buf[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert fb.body_for(q.dtype, q.shape[3], aligned=q.data_ptr() % 16 == 0) == body
    before = fb.launches_by_body.get(body, 0)
    got = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert fb.launches_by_body[body] == before + 1
    want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    for x, w in zip(got, want):
        assert grad_close(x, w, torch.bfloat16)
    for named in ("wgmma",) + (("mma",) if case == "unaligned" else ()):
        with pytest.raises(ValueError, match=named):
            fb.flash_attention_bwd(q, k, v, out, do, lse, body=named, **kw)


@pytest.mark.parametrize("body", ["wgmma", "mma", "fp32"])
@pytest.mark.parametrize("shape", [BWD_SHAPES[0], BWD_SHAPES[2], BWD_SHAPES[5], BWD_SHAPES[6]])
def test_flash_forward_lse_matches_plain_on_card(card, shape, body):
    """Every body writes the LSE when given a pointer, and the same output
    as without one."""
    dtype = torch.bfloat16
    q, k, v, _, _, _, kw = bwd_inputs(card, shape, dtype)
    if body not in fa.bodies_for(dtype, q.shape[3]):
        pytest.skip(f"the {body} body does not take D={q.shape[3]}")
    out, lse = fa._launch(q, k, v, kw["causal"], kw["window"], kw["q_offset"], body, True)
    plain_out, plain_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, fa.flash_attention(q, k, v, body=body, **kw))
    unseen = torch.isneginf(plain_lse)
    assert torch.equal(torch.isneginf(lse), unseen)
    torch.testing.assert_close(lse[~unseen], plain_lse[~unseen], atol=2e-4, rtol=2e-4)


def test_flash_function_launches_forward_and_backward(card):
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, _, do, _, kw = bwd_inputs(card, BWD_SHAPES[5], torch.bfloat16)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = fa.launches, fb.launches
    out = fa.flash_attention(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.launches == f0 + 1 and fb.launches == b0 + 1
    for leaf, want in zip(leaves, fb.flash_attention_bwd_plain(
            q, k, v, out.detach(), do, fa.flash_attention_plain(q, k, v, return_lse=True,
                                                                **kw)[1], **kw)):
        assert grad_close(leaf.grad, want, torch.bfloat16)


TRAIN_CARD = ["mistral-nemo-12b", "qwen2-vl-72b", "whisper-medium"]


def train_batch(cfg, b=2, s=24, seed=0):
    rs = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rs.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            (rs.standard_normal((b, 9, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.arch_type == "audio":
        batch["audio_frames"] = torch.from_numpy(
            (rs.standard_normal((b, cfg.n_audio_frames, cfg.d_model)) * 0.02).astype(np.float32))
    return batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", TRAIN_CARD)
def test_train_step_on_card_equals_the_cpus(card, name, dtype):
    """The dense, VLM and audio train steps on the card (flash forward and
    backward kernels) against the CPU's (the plain twins): loss, grad norm
    and per-leaf gradients."""
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.training import make_train_step, optimizer as opt

    cfg = ARCHS[name].reduced(dtype=dtype)
    cpu = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    gpu = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu").to(card)
    batch = train_batch(cfg)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    grads = {}
    for where, params in (("cpu", cpu), ("card", gpu)):
        params.requires_grad_(True)
        on = {k: v.to(params["embed"].device) if k == "tokens" else
              v.to(params["embed"].device, getattr(torch, dtype)) for k, v in batch.items()}
        tm.next_token_loss(params, on, cfg, remat=True).backward()
        grads[where] = {n: p.grad.float().cpu() for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
    for n, want in grads["cpu"].items():
        got = grads["card"][n]
        cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
        assert float(cos) >= 1 - tol, f"{n}: cosine {float(cos)}"
    f0, b0 = fa.launches, fb.launches
    metrics = {}
    for where, params in (("cpu", cpu), ("card", gpu)):
        step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1),
                               device=params["embed"].device)
        _, state, m = step(params, opt.init(params), {k: v.to(getattr(torch, dtype))
                                                       if k != "tokens" else v
                                                       for k, v in batch.items()})
        assert int(state.step) == 1
        metrics[where] = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    attn_layers = cfg.n_layers + (cfg.n_layers + cfg.n_encoder_layers if cfg.arch_type == "audio"
                                  else 0)
    assert fa.launches - f0 == 2 * attn_layers  # forward, and again under remat
    assert fb.launches - b0 == attn_layers
    for key in ("loss", "grad_norm", "lr"):
        assert metrics["card"][key] == pytest.approx(metrics["cpu"][key], rel=tol)


TRAIN_KERNEL_FAMILIES = ["mamba2-780m", "zamba2-7b", "qwen3-moe-30b-a3b"]


def kernel_counts():
    """The launch counts of the SSD scan and the grouped matmul, forward
    and backward."""
    return dict(ssd=ssd.launches, ssd_bwd=sb.launches, gmm=gmm.launches, dx=gb.dx_launches,
                dw=gb.dw_launches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", TRAIN_KERNEL_FAMILIES)
def test_ssm_hybrid_moe_train_step_on_card_equals_the_cpus(card, name, dtype):
    """The SSM, hybrid and MoE train steps on the card (the SSD scan's and
    the grouped matmul's forward and backward kernels) against the CPU's
    (the plain twins): loss, grad norm and per-leaf gradients, as the
    dense test above holds them, and each kernel's launches a step."""
    from repro_torch.training import make_train_step, optimizer as opt

    cfg = ARCHS[name].reduced(dtype=dtype)
    cpu = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    gpu = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu").to(card)
    batch = train_batch(cfg)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    grads = {}
    for where, params in (("cpu", cpu), ("card", gpu)):
        params.requires_grad_(True)
        tm.next_token_loss(params, {"tokens": batch["tokens"].to(params["embed"].device)}, cfg,
                           remat=True).backward()
        grads[where] = {n: p.grad.float().cpu() for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
    for n, want in grads["cpu"].items():
        got = grads["card"][n]
        cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
        assert float(cos) >= 1 - tol, f"{n}: cosine {float(cos)}"
    before = kernel_counts()
    metrics = {}
    for where, params in (("cpu", cpu), ("card", gpu)):
        step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1),
                               device=params["embed"].device)
        _, state, m = step(params, opt.init(params), batch)
        assert int(state.step) == 1
        metrics[where] = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in kernel_counts().items()}
    ssm_layers = cfg.n_layers if cfg.arch_type in ("ssm", "hybrid") else 0
    gmm_layers = cfg.n_layers if cfg.arch_type == "moe" else 0
    # forward twice a layer (remat runs it again), backward once
    assert ran == dict(ssd=2 * ssm_layers, ssd_bwd=ssm_layers, gmm=6 * gmm_layers,
                       dx=3 * gmm_layers, dw=3 * gmm_layers), ran
    for key in ("loss", "grad_norm", "lr"):
        assert metrics["card"][key] == pytest.approx(metrics["cpu"][key], rel=tol)


def test_decode_attention_refuses_grad_on_card(card):
    """Decode attention serves inference and has no backward: under grad
    mode with an input that requires grad it raises, and under no_grad it
    launches."""
    q = torch.zeros(1, 4, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 8, 4, 64, device=card, dtype=torch.bfloat16)
    lens = torch.tensor([8], dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        da.decode_attention(q, k, k, lens)
    with torch.no_grad():
        da.decode_attention(q, k, k, lens)


# ---------------------------------------------------------------------------
# the SSD scan's and the grouped matmul's backward kernels
# ---------------------------------------------------------------------------
def ssd_grad_close(got, want, dtype):
    """chip_smoke.py's phase 2f check of an SSD gradient against the plain
    backward's: tests/test_kernels.py's 5e-5 absolute and 5e-4 relative,
    the absolute part scaled to the tensor's largest |want|; a gradient
    the kernel writes in bf16 (dx, db, dc from bf16 inputs) within 2e-2 of
    that largest value."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        return bool((err <= 2e-2 * scale).all())
    return bool((err <= 5e-5 * scale + 5e-4 * want.abs()).all())


def ssd_bwd_inputs(card, b, t, h, p, n, chunk, with_state, with_dstate, dtype, seed):
    """Seeded inputs, the gradients of y and (where asked) of the final
    state, and the fp32 states the forward's chunked body leaves."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(b, t, h, p, generator=g, device=card) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g, device=card))
    a = -torch.exp(torch.randn(h, generator=g, device=card) * 0.3)
    bb = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    cc = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    init = torch.randn(b, h, p, n, generator=g, device=card) if with_state else None
    dy = (torch.randn(b, t, h, p, generator=g, device=card) * 0.5).to(dtype)
    dstate = torch.randn(b, h, p, n, generator=g, device=card) if with_dstate else None
    _, _, states = ssd._launch(x, dt, a, bb, cc, chunk, init, None, True)
    return x, dt, a, bb, cc, init, states, dy, dstate


# (b, t, h, p, n, chunk, initial_state, dstate): ragged T, a given state
# with a nonzero dstate, mamba2's and zamba2's P, N and chunk
SSD_BWD_SHAPES = [
    (1, 64, 2, 32, 16, 16, False, False),
    (2, 100, 3, 32, 16, 32, True, True),       # ragged chunks
    (2, 300, 4, 64, 128, 128, True, True),     # mamba2-780m's P, N and chunk, ragged T
    (2, 256, 4, 64, 64, 128, False, True),     # zamba2-7b's
    (1, 5, 2, 64, 128, 128, True, False),      # one short chunk
    (2, 70, 3, 16, 8, 16, False, False),       # narrow P and N (one 16-byte vector of bf16 N)
]


# (dtype, body): every body of the backward in each dtype it takes
SSD_BWD_BODIES = [(dt, body) for dt in (torch.float32, torch.bfloat16)
                  for body in sb.bodies_for(dt)]


@pytest.mark.parametrize("dtype,body", SSD_BWD_BODIES)
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain_on_card(card, shape, dtype, body):
    b, t, h, p, n, chunk, with_state, with_dstate = shape
    args = ssd_bwd_inputs(card, *shape, dtype, seed=t * h + p)
    before = (sb.launches, sb.launches_by_body.get(body, 0))
    got = sb.ssd_scan_bwd(*args, chunk=chunk, body=body)
    torch.cuda.synchronize()
    assert (sb.launches, sb.launches_by_body[body]) == (before[0] + 1, before[1] + 1)
    want = sb.ssd_scan_bwd_plain(*args, chunk=chunk)
    names = ("dx", "ddt", "da", "db", "dc", "d_init")
    for name, gt, w in zip(names, got, want):
        if w is None:
            assert gt is None, name
            continue
        kernel_dtype = dtype if name in ("dx", "db", "dc") else torch.float32
        assert gt.dtype == kernel_dtype and gt.shape == w.shape, name
        assert ssd_grad_close(gt, w, kernel_dtype), \
            f"{name}: max err {float((gt.float() - w).abs().max())} of {float(w.abs().max())}"


@pytest.mark.parametrize("dtype,body", SSD_BWD_BODIES)
def test_ssd_bwd_takes_an_offset_view_and_repeats_bit_for_bit(card, dtype, body):
    """x and dy off a 16-byte boundary are copied, not refused; the same
    gradients again on a second call (no atomics); the C entry refuses an
    unaligned pointer."""
    args = list(ssd_bwd_inputs(card, 2, 300, 4, 64, 128, 128, True, True, dtype, seed=9))
    want = sb.ssd_scan_bwd(*args, chunk=128, body=body)
    again = sb.ssd_scan_bwd(*args, chunk=128, body=body)
    off = list(args)
    off[0], off[7] = offset_on_card(args[0]), offset_on_card(args[7])
    got = sb.ssd_scan_bwd(*off, chunk=128, body=body)
    torch.cuda.synchronize()
    for x, y, z in zip(want, again, got):
        assert torch.equal(x, y) and torch.equal(x, z)
    x, dt, a, bb, cc, init, states, dy, dstate = args
    bs, t, h, p = x.shape
    outs = [torch.empty_like(z) for z in (x, dt, bb, cc)]
    rc = sb._entry()(offset_on_card(x).data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
                     cc.data_ptr(), dy.data_ptr(), states.data_ptr(), None,
                     *(z.data_ptr() for z in outs), None, *(states.data_ptr(),) * 4,
                     bs, t, h, p, bb.shape[3], 128, sb._DTYPES[dtype], sb.BODIES[body],
                     torch.cuda.current_stream().cuda_stream)
    assert refused(rc)
    torch.cuda.synchronize()


def test_ssd_function_launches_forward_and_backward(card):
    """Under grad mode the wrapper goes through SsdScan: one forward (on
    the chunked body) and one backward launch, the gradients those of the
    plain backward on the forward's states."""
    x, dt, a, bb, cc, init, states, dy, dstate = ssd_bwd_inputs(
        card, 2, 300, 4, 64, 128, 128, True, True, torch.bfloat16, seed=11)
    leaves = [z.clone().requires_grad_(True) for z in (x, dt, a, bb, cc, init)]
    f0, b0, m0 = ssd.launches, sb.launches, sb.launches_by_body.get("mma", 0)
    forward = dict(ssd.launches_by_body)
    y, state = ssd.ssd_scan(*leaves[:5], chunk=128, initial_state=leaves[5])
    torch.autograd.backward([y, state], [dy, dstate])
    torch.cuda.synchronize()
    assert ssd.launches == f0 + 1 and sb.launches == b0 + 1
    assert sb.launches_by_body["mma"] == m0 + 1  # bf16's backward runs on mma
    ran = {k for k, v in ssd.launches_by_body.items() if v != forward.get(k, 0)}
    assert ran <= {"chunked", "fused"} and len(ran) == 1  # a body that keeps the states
    want = sb.ssd_scan_bwd_plain(x, dt, a, bb, cc, init, states, dy, dstate, chunk=128)
    for leaf, w in zip(leaves, want):
        assert ssd_grad_close(leaf.grad, w, leaf.dtype)


def spread_sizes(t, e, seed):
    """``e`` group sizes summing to ``t``, drawn from a seed: some empty,
    the rest uneven."""
    rs = np.random.default_rng(seed)
    weights = rs.random(e) * (rs.random(e) > 0.2)
    sizes = np.floor(weights / weights.sum() * t).astype(int)
    sizes[int(np.argmax(sizes))] += t - int(sizes.sum())
    return sizes.tolist()


GMM_BWD_CASES = [
    (50, 64, 48, [13, 0, 30, 7]),
    (20, 16, 8, [0, 20, 0, 0, 0]),       # empty groups: dw zeros there
    (17, 17, 33, [9, 8]),                # no whole 16-byte vector: the element loads
    (12, 8, 4, [4, 5, 0]),               # rows past the sizes' sum: the last expert's
    (1000, 256, 384, [500, 0, 3, 250, 1, 0, 246, 0]),
    (16, 256, 96, [1] * 16 + [0] * 112),  # one-row groups beside empty ones
    # group 1 starts inside a 64-row slice (row 37) and ends inside a
    # 16-row k-step (90 rows: 26 in its last slice), with rows after it
    (192, 128, 256, [37, 90, 5, 60]),
    (1000, 256, 128, [0, 0, 0, 1000, 0, 0, 0, 0]),  # every row in one expert of 8
    (3001, 256, 384, spread_sizes(3001, 128, 7)),   # 128 experts, T not a multiple of 64
    (300, 200, 136, [100, 0, 150, 50]),  # whole 16-byte vectors, not multiples of 128
]
@pytest.mark.parametrize("dw_body", list(gb.DW_BODIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GMM_BWD_CASES)
def test_gmm_dx_and_dw_kernels_match_plain_on_card(card, case, dtype, dw_body):
    """dx on every body that takes the inputs; dw on ``dw_body`` where it
    takes them (its launch counted by body, an empty group's dw exactly
    zero), and refused by name where it does not."""
    t, d_in, d_out, sizes = case
    g = torch.Generator(device=card).manual_seed(t + d_out)
    e = len(sizes)
    x = torch.randn(t, d_in, generator=g, device=card).to(dtype)
    w = (torch.randn(e, d_in, d_out, generator=g, device=card) / d_in ** 0.5).to(dtype)
    dy = torch.randn(t, d_out, generator=g, device=card).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    tol = GMM_TOL[dtype]
    dx_bodies = gmm.bodies_for(dtype, d_out, d_in, True, e)
    want_dx = gb.moe_gmm_dx_plain(dy, w, gs).float()
    for body in dx_bodies:
        before = gb.dx_by_body.get(body, 0)
        got = gb.moe_gmm_dx(dy, w, gs, body=body)
        torch.cuda.synchronize()
        assert gb.dx_by_body[body] == before + 1 and got.dtype == dtype
        torch.testing.assert_close(got.float(), want_dx, atol=tol, rtol=tol, msg=f"dx {body}")
    if dw_body not in gb.dw_bodies_for(dtype, d_in, d_out, True, e):
        with pytest.raises(ValueError, match=dw_body):
            gb.moe_gmm_dw(x, dy, gs, e, body=dw_body)
        return
    want_dw = gb.moe_gmm_dw_plain(x, dy, gs, e).float()
    before = (gb.dw_launches, gb.dw_by_body.get(dw_body, 0))
    got = gb.moe_gmm_dw(x, dy, gs, e, body=dw_body)
    torch.cuda.synchronize()
    assert (gb.dw_launches, gb.dw_by_body[dw_body]) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want_dw, atol=tol, rtol=tol, msg=f"dw {dw_body}")
    empty = [i for i, s in enumerate(sizes) if s == 0 and i != e - 1]
    assert not got[empty].any()  # an empty group writes zeros


def test_gmm_dw_wgmma_repeats_bit_for_bit(card):
    """dw on wgmma (bf16's default) keeps its sums in one order, so a
    repeat gives the same bits, here with every row in one expert (one
    tile's loop over all of T) and over 128 uneven groups."""
    g = torch.Generator(device=card).manual_seed(4)
    for t, sizes in ((4096, [0, 4096, 0, 0]), (3001, spread_sizes(3001, 128, 3))):
        x = torch.randn(t, 256, generator=g, device=card).to(torch.bfloat16)
        dy = torch.randn(t, 384, generator=g, device=card).to(torch.bfloat16)
        gs = torch.tensor(sizes, dtype=torch.int32, device=card)
        before = gb.dw_by_body.get("wgmma", 0)
        first = gb.moe_gmm_dw(x, dy, gs, len(sizes))
        again = gb.moe_gmm_dw(x, dy, gs, len(sizes))
        torch.cuda.synchronize()
        assert gb.dw_by_body["wgmma"] == before + 2
        assert torch.equal(first, again)


def test_gmm_bwd_takes_an_offset_view_on_card(card):
    """An input off a 16-byte boundary goes to the element-load body (dw)
    or the mma_elem body (dx), as the forward's does; naming a vector body
    for it raises."""
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(40, 64, generator=g, device=card).to(torch.bfloat16)
    w = (torch.randn(3, 64, 32, generator=g, device=card) * 0.1).to(torch.bfloat16)
    dy = torch.randn(40, 32, generator=g, device=card).to(torch.bfloat16)
    gs = torch.tensor([10, 0, 30], dtype=torch.int32, device=card)
    ox, ody = offset_on_card(x), offset_on_card(dy)
    before = (gb.dx_by_body.get("mma_elem", 0), gb.dw_by_body.get("mma_elem", 0))
    dx, dw = gb.moe_gmm_dx(ody, w, gs), gb.moe_gmm_dw(ox, ody, gs, 3)
    torch.cuda.synchronize()
    assert (gb.dx_by_body["mma_elem"], gb.dw_by_body["mma_elem"]) == (before[0] + 1,
                                                                      before[1] + 1)
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(dx.float(), gb.moe_gmm_dx_plain(dy, w, gs).float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(dw.float(), gb.moe_gmm_dw_plain(x, dy, gs, 3).float(), atol=tol,
                               rtol=tol)
    with pytest.raises(ValueError, match="mma"):
        gb.moe_gmm_dw(ox, ody, gs, 3, body="mma")
    with pytest.raises(ValueError, match="wgmma"):
        gb.moe_gmm_dx(ody, w, gs, body="wgmma")


def test_gmm_function_launches_forward_and_backward(card):
    """Under grad mode the wrapper goes through MoeGmm: one forward, one
    dx and one dw launch, each on the body its rule picks."""
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(1000, 256, generator=g, device=card).to(torch.bfloat16)
    w = (torch.randn(8, 256, 384, generator=g, device=card) / 16).to(torch.bfloat16)
    dy = torch.randn(1000, 384, generator=g, device=card).to(torch.bfloat16)
    gs = torch.tensor([500, 0, 3, 250, 1, 0, 246, 0], dtype=torch.int32, device=card)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = kernel_counts()
    wg0 = gb.dw_by_body.get("wgmma", 0)
    gmm.moe_gmm(xl, wl, gs).backward(dy)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in kernel_counts().items()}
    assert ran == dict(ssd=0, ssd_bwd=0, gmm=1, dx=1, dw=1)
    assert gb.dw_by_body["wgmma"] == wg0 + 1  # dw runs on wgmma by default
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(xl.grad.float(), gb.moe_gmm_dx_plain(dy, w, gs).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(wl.grad.float(), gb.moe_gmm_dw_plain(x, dy, gs, 8).float(),
                               atol=tol, rtol=tol)
    # x alone, and w alone, requiring grad: only its kernel runs
    before = kernel_counts()
    gmm.moe_gmm(x.clone().requires_grad_(True), w, gs).backward(dy)
    gmm.moe_gmm(x, w.clone().requires_grad_(True), gs).backward(dy)
    ran = {k: v - before[k] for k, v in kernel_counts().items()}
    assert ran == dict(ssd=0, ssd_bwd=0, gmm=2, dx=1, dw=1)


def test_prefill_and_decode_graphs_build_no_graph(card):
    """With trainable params, the prefill step and the engine's captured
    decode step still build no autograd graph and launch as before."""
    cfg, params, engine = graph_engine(card, "mistral-nemo-12b", "bfloat16")
    params.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 16), device=card)
    before = fa.launches
    logits = make_prefill_step(cfg, device=card)(params, {"tokens": toks})
    assert logits.grad_fn is None and not logits.requires_grad
    assert fa.launches == before + cfg.n_layers
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    got, _ = engine.run_task(0, prompt)
    np.testing.assert_array_equal(got, eager_task(cfg, params, prompt, 4, card))
    assert engine.captures == 1
    engine.close()


# ---------------------------------------------------------------------------
# inputs off a 16-byte boundary: copied by the wrappers, refused by the C entries
# ---------------------------------------------------------------------------
def offset_on_card(t):
    """``t``'s values, contiguous, one element past an aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.flatten())
    view = buf[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def refused(rc):
    return rc == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_takes_an_offset_view_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn(2, 200, 8, 128, device=card, generator=g).to(dtype)
    k = torch.randn(2, 200, 2, 128, device=card, generator=g).to(dtype)
    v = torch.randn(2, 200, 2, 128, device=card, generator=g).to(dtype)
    body = fa.body_for(dtype, 128)
    before = fa.launches_by_body.get(body, 0)
    got = fa.flash_attention(offset_on_card(q), k, offset_on_card(v))
    want = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches_by_body[body] == before + 2
    assert torch.equal(got, want)  # the same body on the same values
    plain = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), plain.float(), atol=TOL[dtype], rtol=TOL[dtype])
    off, out = offset_on_card(q), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for name in fa.bodies_for(dtype, 128):
        rc = fa._entry()(off.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                         2, 200, 200, 8, 2, 128, 1, 0, 0, 0, fa._DTYPES[dtype], fa.BODIES[name],
                         stream)
        assert refused(rc), name
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_takes_an_offset_view_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(2)
    b, h, kh, d, t = 2, 32, 8, 128, 300
    q = torch.randn(b, h, d, device=card, generator=g).to(dtype)
    k = torch.randn(b, t, kh, d, device=card, generator=g).to(dtype)
    v = torch.randn(b, t, kh, d, device=card, generator=g).to(dtype)
    lens = torch.tensor([300, 123], dtype=torch.int32, device=card)
    body = da.body_for(dtype, d, h // kh, da.splits_for(b, kh, t, da.sm_count(card)))
    before = da.launches_by_body.get(body, 0)
    got = da.decode_attention(offset_on_card(q), offset_on_card(k), v, lens)
    want = da.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.launches_by_body[body] == before + 2
    assert torch.equal(got, want)
    assert decode_close(got.float(), da.decode_attention_plain(q, k, v, lens).float(), dtype)
    off, out = offset_on_card(k), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for name in ("single", "split"):
        rc = da._entry()(q.data_ptr(), off.data_ptr(), v.data_ptr(), lens.data_ptr(),
                         out.data_ptr(), None, None, None, b, h, kh, t, d, da._DTYPES[dtype],
                         da.BODIES[name], 1, da.slots_per_split(t, 1), stream)
        assert refused(rc), name
    torch.cuda.synchronize()


# (dtype, partials body, combine body): every body of each dtype, the new
# ones (cluster, warp) and the ones they replace (split, block)
PARTIALS_BODIES = [(dt, pb, cb) for dt in (torch.float32, torch.bfloat16)
                   for pb in da.partials_bodies_for(dt, 128, 4) for cb in ("warp", "block")]


@pytest.mark.parametrize("dtype,pbody,cbody", PARTIALS_BODIES,
                         ids=[f"{str(c[0])[6:]}-{c[1]}-{c[2]}" for c in PARTIALS_BODIES])
@pytest.mark.parametrize("b,h,kh,d,t,ns", [
    (2, 32, 8, 128, 4096, (1, 2, 4, 16)),   # NeMo's heads
    (2, 48, 1, 128, 4160, (2, 16)),         # granite's MQA; T_loc 260 and 2,080: partial tiles
    (2, 16, 16, 64, 1500, (2, 4)),          # whisper's 1,500 encoder frames
    (2, 16, 16, 192, 320, (4,)),            # MLA's hd + rope dim, T_loc 80
    (1, 128, 1, 64, 2048, (16,)),           # 128 query rows a KV head (bf16's most)
])
def test_decode_partials_and_combine_match_the_whole_kernel_on_card(card, b, h, kh, d, t, ns,
                                                                     dtype, pbody, cbody):
    """A cache cut along T into n slices, as a (1, n) mesh's ranks hold it:
    each slice through ``decode_attention_partials`` (its local length) on
    ``pbody``, the records stacked, then ``combine_partials`` on ``cbody``
    in slice order, against the whole kernel and the plain path; the
    kernel's records against the plain records' combine (m in the natural
    log domain); a row with five slots (every slice but the first empty for
    it) and one with none; in the second length case the second half of
    the cache is empty, so the last slice holds no slot of any row: its
    record is m = -inf, l = 0, acc = 0 with zero pads.  One launch a slice
    and one combine, counted by body."""
    gen = torch.Generator(device=card).manual_seed(t + h + d)
    q = torch.randn(b, h, d, generator=gen, device=card, dtype=dtype)
    k = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=dtype)
    v = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=dtype)
    if h // kh > da.SPLIT_MAX_ROWS[dtype]:  # past what the split body takes: refused
        with pytest.raises(ValueError, match="does not take"):
            da.decode_attention_partials(q, k, v, torch.full((b,), t, dtype=torch.int32,
                                                             device=card), body=pbody)
        return
    for lens in ([t, 5][:b], [t // 2 - 3, 0][:b]):
        n_t = torch.tensor(lens, dtype=torch.int32, device=card)
        whole = da.decode_attention(q, k, v, n_t).float()
        plain = da.decode_attention_plain(q, k, v, n_t).float()
        for n in ns:
            t_loc = t // n
            before = (da.partials_by_body.get(pbody, 0), da.combine_by_body.get(cbody, 0))
            rec = torch.stack([da.decode_attention_partials(
                q, k[:, r * t_loc:(r + 1) * t_loc].contiguous(),
                v[:, r * t_loc:(r + 1) * t_loc].contiguous(),
                (n_t - r * t_loc).clamp(0, t_loc).to(torch.int32), body=pbody) for r in range(n)])
            got = da.combine_partials(rec, dtype, body=cbody)
            torch.cuda.synchronize()
            assert (da.partials_by_body[pbody], da.combine_by_body[cbody]) == (
                before[0] + n, before[1] + 1)
            assert rec.shape == (n, b, h, d + 4) and got.dtype == dtype
            got = got.float()
            assert decode_close(got, whole, dtype), (n, float((got - whole).abs().max()))
            assert decode_close(got, plain, dtype), (n, float((got - plain).abs().max()))
            by_plain = da.combine_partials_plain(rec, torch.float32)
            assert decode_close(by_plain, plain, dtype)
            assert not rec[..., d + 2:].any()
            if b > 1 and lens[1] == 0:
                assert not got[1].any()
            if len(lens) > 1 and lens[1] == 0 and n > 1:
                m, l, acc = da.unpack_partials(rec[-1])
                assert bool(torch.isinf(m).all()) and not l.any() and not acc.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_partials_take_an_offset_view_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(4)
    b, h, kh, d, t = 2, 32, 8, 128, 300
    q = torch.randn(b, h, d, device=card, generator=g).to(dtype)
    k = torch.randn(b, t, kh, d, device=card, generator=g).to(dtype)
    v = torch.randn(b, t, kh, d, device=card, generator=g).to(dtype)
    lens = torch.tensor([300, 123], dtype=torch.int32, device=card)
    for body in da.partials_bodies_for(dtype, d, h // kh):
        got = da.decode_attention_partials(offset_on_card(q), offset_on_card(k), v, lens,
                                           body=body)
        want = da.decode_attention_partials(q, k, v, lens, body=body)
        torch.cuda.synchronize()
        assert torch.equal(got, want), body
    parts = want[None].expand((3,) + want.shape)  # read where it lies: a stride-0 slice dim
    for body in ("warp", "block"):
        assert torch.equal(da.combine_partials(parts, dtype, body=body),
                           da.combine_partials(parts.contiguous(), dtype, body=body))
    # a slice off a 16-byte boundary is copied before the warp body's launch
    off = torch.empty(3 * want.numel() + 1, device=card)[1:].view((3,) + want.shape)
    off.copy_(parts)
    assert torch.equal(da.combine_partials(off, dtype), da.combine_partials(parts, dtype))
    torch.cuda.synchronize()


def test_decode_partials_raise_where_the_split_body_cannot_take_the_shape(card):
    q = torch.randn(1, 80, 64, device=card)  # 80 query rows a KV head: over fp32's 64
    k = torch.randn(1, 100, 1, 64, device=card)
    with pytest.raises(ValueError, match="split body"):
        da.decode_attention_partials(q, k, k, torch.tensor([100], dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="cluster"):  # fp32 has no cluster body
        da.decode_attention_partials(q[:, :8], k, k,
                                     torch.tensor([100], dtype=torch.int32, device=card),
                                     body="cluster")
    with pytest.raises(TypeError, match="fp32 records"):
        rec = torch.zeros(2, 1, 4, 68, device=card, dtype=torch.bfloat16)
        da.combine_partials(rec, torch.float32)
    with pytest.raises(ValueError, match="warp"):
        da.combine_partials(torch.zeros(2, 1, 4, 6 + 4, device=card), torch.float32, body="warp")


@pytest.mark.parametrize("model,b,h,kh,d", [("nemo", 2, 32, 8, 128), ("granite", 2, 48, 1, 128)])
def test_the_cluster_record_repeats_bit_for_bit_on_card(card, model, b, h, kh, d):
    """One rank's slice at n = 16 (T_loc = 2,048) through the cluster body
    twice, and ten times more back to back: the same record bit for bit
    (the merge runs in split order); its cluster is a size the card holds
    (``cluster_fits``), and a size past 16 is refused."""
    gen = torch.Generator(device=card).manual_seed(h)
    t = 2048
    q = torch.randn(b, h, d, generator=gen, device=card, dtype=torch.bfloat16)
    k = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=torch.bfloat16)
    v = torch.randn(b, t, kh, d, generator=gen, device=card, dtype=torch.bfloat16)
    lens = torch.tensor([t, 1000], dtype=torch.int32, device=card)
    fits = da.cluster_fits(card, h // kh, d)
    size = da.cluster_splits(b, kh, t, da.sm_count(card), fits)
    assert size in (1, 2, 4, 8, 16) and fits[size] >= 1
    want = da.decode_attention_partials(q, k, v, lens, body="cluster")
    for _ in range(11):
        got = da.decode_attention_partials(q, k, v, lens, body="cluster")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = da.decode_attention_partials_plain(q, k, v, lens)
    assert torch.allclose(got[..., :d + 2], plain[..., :d + 2], rtol=2e-2, atol=2e-2)
    rec = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    rc = da._entry("decode_partials_cluster_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), rec.data_ptr(), b, h, kh, t,
        d, 32, da.slots_per_split(t, 32), stream)
    assert refused(rc)  # 32 CTAs: past any cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_takes_an_offset_view_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(3)
    bs, t, h, p, n, chunk = 2, 300, 4, 64, 128, 128  # test_ssd_kernel_matches_plain_on_card's
    x = (torch.randn(bs, t, h, p, generator=g, device=card) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bs, t, h, generator=g, device=card))
    a = -torch.exp(torch.randn(h, generator=g, device=card) * 0.3)
    b = (torch.randn(bs, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    c = (torch.randn(bs, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    before = ssd.launches
    got = ssd.ssd_scan(offset_on_card(x), dt, a, b, offset_on_card(c), chunk=chunk)
    want = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = ssd.ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
    torch.testing.assert_close(got[0].float(), plain[0].float(), **SSD_TOL[dtype])
    off, y = offset_on_card(b), torch.empty_like(x)
    state = torch.empty(bs, h, p, n, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    rc = ssd._entry()[0](x.data_ptr(), dt.data_ptr(), a.data_ptr(), off.data_ptr(), c.data_ptr(),
                         None, y.data_ptr(), state.data_ptr(), None, None, None,
                         bs, t, h, p, n, chunk, ssd._DTYPES[dtype], ssd.BODIES["serial"], 0, stream)
    assert refused(rc)
    torch.cuda.synchronize()


# (dtype, body): every body that takes a rank's heads in each dtype
HEAD_BODIES = [(torch.float32, "chunked"), (torch.bfloat16, "chunked"),
               (torch.bfloat16, "fused")]


def head_inputs(card, h, p, n, dtype, seed, b=2, t=2048):
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(b, t, h, p, generator=g, device=card) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g, device=card))
    a = -torch.exp(torch.randn(h, generator=g, device=card) * 0.3)
    bb = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    cc = (torch.randn(b, t, h, n, generator=g, device=card) * 0.5).to(dtype)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("dtype,body", HEAD_BODIES,
                         ids=[f"{str(d)[6:]}-{b}" for d, b in HEAD_BODIES])
@pytest.mark.parametrize("h,p,n", [(48, 64, 128), (112, 64, 64)], ids=["mamba2", "zamba2"])
def test_ssd_on_head_slices_matches_the_whole_kernel_on_card(card, h, p, n, dtype, body):
    """Phase 2c's inputs (B = 2, T = 2,048, chunk 128; mamba2's and
    zamba2's heads) cut into 2, 4 and 16 slices of heads, as the ranks of
    a (1, n) mesh compute them: each slice's x, dt, a, B and C through
    ``ssd_scan`` on ``body``, the y and final states side by side, against
    the whole call on the chunked body and the plain path at phase 2c's
    tolerance, and in bf16 bit for bit the whole chunked call.  The fused
    body takes a slice only where its grid fits one wave (n = 16 here) and
    refuses the others without a launch."""
    x, dt, a, bb, cc = head_inputs(card, h, p, n, dtype, seed=h)
    chunk = 128
    whole = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, body="chunked")
    plain = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    per_sm = ssd.fused_blocks_per_sm(card, chunk, p, n, 1)
    for k in (2, 4, 16):
        cuts = [slice(i * h // k, (i + 1) * h // k) for i in range(k)]
        if body == "fused" and 2 * (h // k) * 16 > sms * per_sm:
            before = ssd.launches
            with pytest.raises(ValueError, match="one wave"):
                ssd.ssd_scan(*(z[:, :, cuts[0]].contiguous() for z in (x, dt)), a[cuts[0]],
                             *(z[:, :, cuts[0]].contiguous() for z in (bb, cc)), chunk=chunk,
                             body=body)
            assert ssd.launches == before and k < 16
            continue
        before = ssd.launches_by_body.get(body, 0)
        parts = [ssd.ssd_scan(x[:, :, s].contiguous(), dt[:, :, s].contiguous(), a[s],
                              bb[:, :, s].contiguous(), cc[:, :, s].contiguous(), chunk=chunk,
                              body=body)
                 for s in cuts]
        torch.cuda.synchronize()
        assert ssd.launches_by_body[body] == before + k
        y, state = torch.cat([y for y, _ in parts], dim=2), torch.cat([s for _, s in parts], dim=1)
        for want_y, want_state in (whole, plain):
            torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
            torch.testing.assert_close(state, want_state, **SSD_TOL[torch.float32])
        if dtype == torch.bfloat16:
            assert torch.equal(y, whole[0]) and torch.equal(state, whole[1]), k


@pytest.mark.parametrize("h,p,n", [(3, 64, 128), (7, 64, 64)], ids=["mamba2", "zamba2"])
def test_ssd_fused_under_grad_keeps_the_chunked_bodys_states_and_gradients(card, h, p, n):
    """One rank's heads (mamba2's 3, zamba2's 7 at |model| = 16) in bf16
    under grad, from an initial state: the fused body keeps the fp32
    states entering each chunk bit for bit the chunked body's, and the
    forward and every gradient of ``SsdScan`` on it are the chunked
    body's bit for bit; ``ssd_scan`` picks fused here, one launch forward
    and one backward."""
    x, dt, a, bb, cc = head_inputs(card, h, p, n, torch.bfloat16, seed=5 + h)
    init = torch.randn(2, h, p, n, generator=torch.Generator(device=card).manual_seed(h),
                       device=card)
    kept = {body: ssd._launch(x, dt, a, bb, cc, 128, init, body, True) for body in
            ("chunked", "fused")}
    for got, want in zip(kept["fused"], kept["chunked"]):
        assert torch.equal(got, want)
    dy = torch.randn_like(x.float()).to(torch.bfloat16)
    dstate = torch.randn_like(init)
    grads, outs = {}, {}
    for body in ("chunked", "fused"):
        leaves = [z.clone().requires_grad_(True) for z in (x, dt, a, bb, cc, init)]
        before = (ssd.launches_by_body.get(body, 0), sb.launches)
        y, state = ssd.SsdScan.apply(*leaves[:5], leaves[5], 128, body)
        torch.autograd.backward([y, state], [dy, dstate])
        torch.cuda.synchronize()
        assert (ssd.launches_by_body[body], sb.launches) == (before[0] + 1, before[1] + 1)
        outs[body], grads[body] = (y, state), [z.grad for z in leaves]
    assert all(torch.equal(u, w) for u, w in zip(outs["fused"], outs["chunked"]))
    assert all(torch.equal(u, w) for u, w in zip(grads["fused"], grads["chunked"]))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert ssd.body_for(torch.bfloat16, p, n, 128, 2 * h, sms, 16,
                        ssd.fused_blocks_per_sm(card, 128, p, n, 1)) == "fused"


def test_ssd_fused_repeats_bit_for_bit_back_to_back_and_in_a_graph(card):
    """The fused body keeps nothing on the card from one call to the next:
    100 calls back to back, alternating two shapes, each give the first
    call's bits, and so do two replays of a CUDA graph that captured a
    call on a side stream (a cooperative launch in the graph)."""
    x, dt, a, bb, cc = head_inputs(card, 3, 64, 128, torch.bfloat16, seed=77)
    short = tuple(z[:, :700].contiguous() if z.dim() > 1 else z for z in (x, dt, a, bb, cc))
    want = ssd.ssd_scan(x, dt, a, bb, cc, chunk=128, body="fused")
    want_short = ssd.ssd_scan(*short, chunk=128, body="fused")
    for i in range(100):
        got = ssd.ssd_scan(*((x, dt, a, bb, cc) if i % 2 == 0 else short), chunk=128,
                           body="fused")
        if i >= 98:
            torch.cuda.synchronize()
            assert all(torch.equal(u, w) for u, w in zip(got, want if i % 2 == 0 else want_short))
    static = [z.clone() for z in (x, dt, a, bb, cc)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ssd.ssd_scan(*static, chunk=128, body="fused")  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, state = ssd.ssd_scan(*static, chunk=128, body="fused")
    for _ in range(2):
        y.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want[0]) and torch.equal(state, want[1])


def test_ssd_fused_runs_while_another_stream_holds_the_sms(card):
    """A fused call queued while another stream's matmuls hold every SM
    (as a rank's collectives or a second process may) waits for room and
    runs whole: the cooperative launch never starts part of its grid.
    Ten calls give the idle card's bits."""
    x, dt, a, bb, cc = head_inputs(card, 7, 64, 64, torch.bfloat16, seed=78)
    want = ssd.ssd_scan(x, dt, a, bb, cc, chunk=128, body="fused")
    m = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    with torch.cuda.stream(side):
        for _ in range(40):  # tens of milliseconds of matmuls on every SM
            m = (m @ m).clamp_(-1, 1)
    for _ in range(10):
        outs.append(ssd.ssd_scan(x, dt, a, bb, cc, chunk=128, body="fused"))
    torch.cuda.synchronize()
    for y, state in outs:
        assert torch.equal(y, want[0]) and torch.equal(state, want[1])


def test_ssd_fused_refuses_a_grid_beyond_one_wave_on_card(card):
    """The wrapper refuses a named ``fused`` on a grid past one wave (a
    ValueError, no launch), and the C entry's cooperative launch refuses it
    too (cudaErrorCooperativeLaunchTooLarge), rather than start a grid
    whose CTAs would wait on CTAs that cannot run."""
    x, dt, a, bb, cc = head_inputs(card, 48, 64, 128, torch.bfloat16, seed=79)
    before = ssd.launches
    with pytest.raises(ValueError, match="one wave"):
        ssd.ssd_scan(x, dt, a, bb, cc, chunk=128, body="fused")
    assert ssd.launches == before
    b, t, h, p = x.shape
    nc = t // 128
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, 128), dtype=torch.float32, device=card)
    own = torch.empty((b, nc, h, p, 128), dtype=torch.float32, device=card)
    decays = torch.empty((b, nc, h), dtype=torch.float32, device=card)
    rc = ssd._fused_entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
                            cc.data_ptr(), None, y.data_ptr(), state.data_ptr(), own.data_ptr(),
                            decays.data_ptr(), None, b, t, h, p, 128, 128, 1,
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 720  # cudaErrorCooperativeLaunchTooLarge
    torch.cuda.synchronize()  # the context is sound


def test_mamba2_over_the_one_rank_nccl_mesh_is_the_mesh_less_step_on_card(card):
    """The reduced mamba2 in bf16 over ``make_debug_mesh``'s (1, 1) NCCL
    mesh, where its layers take the head-split path with every head and
    no collective over ``model``: eight serve steps (B = 4) and a prefill
    (B = 2, S = 256, every SSD launch on the body ``ssd_scan`` picks for
    the whole heads), logits bit for bit the mesh-less steps'."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import sharding
    from repro_torch.training import make_serve_step

    cfg = ARCHS["mamba2-780m"].reduced(dtype="bfloat16")
    mesh = make_debug_mesh(device="cuda")
    try:
        assert sharding.ssm_heads(cfg, mesh) == (0, cfg.n_ssm_heads)
        params = tm.init_params(cfg, torch.Generator(device=card).manual_seed(3), card)
        stored = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
        cache = tm.init_cache(cfg, 4, 16, device=card)
        mcache = sharding.shard_tree(tm.init_cache(cfg, 4, 16, device=card), mesh,
                                     sharding.cache_pspecs(mesh, cache))
        plain, meshed = make_serve_step(cfg, device=card), make_serve_step(cfg, mesh=mesh)
        tok = torch.ones(4, dtype=torch.int32, device=card)
        for _ in range(8):
            want, _ = plain(params, cache, tok)
            got, _ = meshed(stored, mcache, tok)
            assert torch.equal(got.full_tensor(), want)
            tok = want.argmax(-1).to(torch.int32)
        tokens = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(4))
        want = make_prefill_step(cfg, device=card)(params, {"tokens": tokens})
        before = dict(ssd.launches_by_body)
        got = make_prefill_step(cfg, mesh=mesh)(stored, {"tokens": tokens}).full_tensor()
        torch.cuda.synchronize()
        chunk = min(cfg.ssm_chunk, 256)
        body = ssd.body_for(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state, chunk,
                            2 * cfg.n_ssm_heads, da.sm_count(card), -(-256 // chunk),
                            ssd.fused_blocks_per_sm(card, chunk, cfg.ssm_head_dim,
                                                    cfg.ssm_state, 1))
        assert ssd.launches_by_body.get(body, 0) - before.get(body, 0) == cfg.n_layers
        assert sum(ssd.launches_by_body.values()) - sum(before.values()) == cfg.n_layers
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()
