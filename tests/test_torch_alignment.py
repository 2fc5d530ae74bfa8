"""Every forward kernel loads its inputs 16 bytes a thread, so each
wrapper hands its kernel inputs that start on 16-byte boundaries: a
contiguous view at an odd storage offset (a slice, a rank's shard) is
copied before the launch, and an aligned input goes as it is.  Checked
here on the wrappers' host side (``_prepare``, which runs on any device);
``tests/test_torch_cuda.py`` launches each kernel on such a view on the
card, and holds each C entry's refusal of an unaligned pointer."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


def offset_view(t):
    """``t``'s values, contiguous, one element past an aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    buf[1:].copy_(t.flatten())
    view = buf[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def check(given, got, moved):
    """The moved inputs are aligned copies with the same values; the
    others are the very tensors given."""
    for i, (g, t) in enumerate(zip(given, got)):
        assert t.data_ptr() % 16 == 0
        assert torch.equal(g, t)
        assert (t is not g) == (i in moved), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_prepare_copies_an_offset_view(dtype, which):
    g = torch.Generator().manual_seed(which)
    q = torch.randn(1, 8, 4, 64, generator=g).to(dtype)
    k = torch.randn(1, 8, 2, 64, generator=g).to(dtype)
    v = torch.randn(1, 8, 2, 64, generator=g).to(dtype)
    given = [q, k, v]
    given[which] = offset_view(given[which])
    check(given, fa._prepare(*given), {which})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_decode_prepare_copies_an_offset_view(dtype, which):
    g = torch.Generator().manual_seed(which)
    q = torch.randn(2, 4, 64, generator=g).to(dtype)
    k = torch.randn(2, 16, 2, 64, generator=g).to(dtype)
    v = torch.randn(2, 16, 2, 64, generator=g).to(dtype)
    lens = torch.tensor([5, 16], dtype=torch.int32)
    given = [q, k, v]
    given[which] = offset_view(given[which])
    check(given, da._prepare(*given, lens), {which})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["x", "b", "c"])
def test_ssd_prepare_copies_an_offset_view(dtype, which):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 12, 2, 16, generator=g).to(dtype)
    dt = torch.rand(1, 12, 2, generator=g)
    a = -torch.rand(2, generator=g)
    b = torch.randn(1, 12, 2, 8, generator=g).to(dtype)
    c = torch.randn(1, 12, 2, 8, generator=g).to(dtype)
    given = dict(x=x, b=b, c=c)
    given[which] = offset_view(given[which])
    got = ssd._prepare(given["x"], dt, a, given["b"], given["c"], 4, None)
    check(list(given.values()), got, {list(given).index(which)})


def test_aligned_leaves_an_aligned_tensor_alone():
    t = torch.zeros(8)
    assert _build.aligned(t) is t
    assert _build.aligned(offset_view(t)).data_ptr() % 16 == 0


def test_an_offset_view_takes_the_plain_path_as_its_copy_does():
    """On the CPU the wrapper's result does not depend on the offset."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 8, 2, 32, generator=g) for _ in range(3))
    assert torch.equal(fa.flash_attention(offset_view(q), k, v), fa.flash_attention(q, k, v))
