"""The port's CUDA kernels against their plain PyTorch versions, and the
serve example through them.  These need a card (the kernels have no CPU
mode) and skip without one; they import no JAX, so they run as they are
on a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import serve_cluster as ex  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py


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
