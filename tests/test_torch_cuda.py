"""The port's CUDA kernels against their plain PyTorch versions, and the
serve example and the prefill step through them.  These need a card (the kernels have no CPU
mode) and skip without one; they import no JAX, so they run as they are
on a machine with a card:

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
    assert smem_bytes(128, 64, 128) <= limit < smem_bytes(256, 64, 256)
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
