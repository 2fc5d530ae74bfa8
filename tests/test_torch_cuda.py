"""The port's CUDA kernels against their plain PyTorch versions, the
serve example and the prefill step through them, and the execution
engine's CUDA graphs of the decode step against the eager loop.  These
need a card (the kernels have no CPU mode) and skip without one; they
import no JAX, so they run as they are on a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.examples import serve_cluster as ex  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
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
    assert da.splits_for(b, kh, t) == 11 and da.body_for(dtype, d, g, 11) == "split"
    per = da.slots_per_split(t, da.splits_for(b, kh, t))
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
    found = da.bodies_for(dtype, d, h // kh, da.splits_for(b, kh, t))
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
    assert ssd.body_for(dtype, p, n, min(chunk, t), b * h, sms) == "chunked"
    before = (ssd.launches, ssd.launches_by_body.get("chunked", 0),
              ssd.launches_by_body.get("serial", 0))
    y, fs = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init)
    yo, fso = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, initial_state=init, body="serial")
    torch.cuda.synchronize()
    assert (ssd.launches, ssd.launches_by_body["chunked"], ssd.launches_by_body["serial"]) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
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


@pytest.mark.parametrize("body", ["mma", "fp32"])
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


def test_flash_bwd_takes_a_strided_grad_and_repeats_bit_for_bit(card):
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, out, do, lse, kw = bwd_inputs(card, BWD_SHAPES[4], torch.bfloat16)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)  # same values, other strides
    assert not strided.is_contiguous()
    a = fb.flash_attention_bwd(q, k, v, out, strided, lse, **kw)
    b = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("body", ["wgmma", "mma", "fp32"])
@pytest.mark.parametrize("shape", [BWD_SHAPES[0], BWD_SHAPES[2], BWD_SHAPES[5], BWD_SHAPES[6]])
def test_flash_forward_lse_matches_plain_on_card(card, shape, body):
    """Every body writes the LSE when given a pointer, and the same output
    as without one."""
    dtype = torch.bfloat16
    q, k, v, _, _, _, kw = bwd_inputs(card, shape, dtype)
    if body not in fa.bodies_for(dtype, q.shape[3], True):
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


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b", "qwen3-moe-30b-a3b"])
def test_families_without_a_card_backward_raise(card, name):
    from repro_torch.training import make_train_step

    cfg = ARCHS[name].reduced(dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        make_train_step(cfg, device=card)
    make_train_step(cfg, impl="ref", device=card)  # the caller's choice: plain PyTorch


def test_ssd_and_gmm_wrappers_raise_under_grad(card):
    x = torch.zeros(1, 8, 2, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(1, 8, 2, 16, device=card, dtype=torch.bfloat16)
    dt = torch.zeros(1, 8, 2, device=card)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        ssd.ssd_scan(x, dt, torch.zeros(2, device=card), b, b)
    with torch.no_grad():
        ssd.ssd_scan(x, dt, torch.zeros(2, device=card), b, b)
    w = torch.zeros(2, 64, 32, device=card, dtype=torch.bfloat16, requires_grad=True)
    sizes = torch.tensor([4, 4], dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        gmm.moe_gmm(torch.zeros(8, 64, device=card, dtype=torch.bfloat16), w, sizes)
    with torch.no_grad():
        gmm.moe_gmm(torch.zeros(8, 64, device=card, dtype=torch.bfloat16), w, sizes)


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
