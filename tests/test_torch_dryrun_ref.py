"""The port's FLOP count of a step (``repro_torch.launch.counter`` through
``dryrun.count_case``, on fake tensors, no mesh) against the reference's
``corrected_costs`` (XLA's ``cost_analysis`` of unrolled 1/2-layer
variants, lowered on ``make_debug_mesh(1)``) at reduced configs, B = 2,
S = 128, one family a case.

The two counts are of different programs by different rules, so each
case holds the ratio port / reference to a window, and names the cause of
its gap (measured on these configs):

* the port counts matmul-class FLOPs by ``FlopCounterMode``'s table and
  one FLOP an elementwise output or reduction input; XLA counts every HLO
  elementwise op by its own rules.  Where the step is matmuls (dense,
  VLM, audio prefill) that is the whole gap, 2-3 %.
"""

import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

jax.devices()  # the reference's dryrun forces 512 host devices at import: lock 1 first
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models.config import InputShape as RefShape  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402

# (arch, kind, dispatch, lowest, highest ratio, the cause of the gap)
CASES = [
    ("mistral-nemo-12b", "prefill", "sorted", 0.95, 1.0,
     "elementwise rules (read 0.979)"),
    ("mistral-nemo-12b", "train", "sorted", 0.88, 0.95,
     "remat: the reference's policy (dots_with_no_batch_dims_saveable) saves no "
     "batched product, so XLA recomputes attention's score and value products in "
     "the backward; the port saves bmm outputs too (read 0.922)"),
    ("whisper-medium", "prefill", "sorted", 0.95, 1.0, "elementwise rules (read 0.976)"),
    ("qwen2-vl-72b", "prefill", "sorted", 0.95, 1.0, "elementwise rules (read 0.972)"),
    ("mamba2-780m", "prefill", "sorted", 0.48, 0.55,
     "the reference's unrolled variants count a Mamba-2 block twice: one reduced "
     "block reads 470.3 M FLOPs unrolled and 244.3 M rolled, the port 226.0 M "
     "(read 0.513)"),
    ("zamba2-7b", "prefill", "sorted", 0.60, 0.68,
     "its Mamba-2 layers, as mamba2's; the shared attention block agrees (read 0.641)"),
    ("qwen3-moe-30b-a3b", "prefill", "sorted", 0.68, 0.78,
     "the reference's moe_gmm_ref gathers a weight a row, which XLA counts at twice "
     "the grouped product (67.4 M for a 33.6 M product) (read 0.735)"),
    ("deepseek-v2-236b", "prefill", "sorted", 0.68, 0.78,
     "as Qwen3-MoE's sorted dispatch (read 0.719)"),
    ("qwen3-moe-30b-a3b", "prefill", "scan", 1.50, 1.60,
     "the reference's scan dispatch is a lax.scan over the experts, whose body XLA "
     "counts once; its variants unroll layers, not experts (read 1.549)"),
]


@pytest.mark.parametrize("arch,kind,dispatch,lo,hi,cause", CASES,
                         ids=[f"{a}-{k}-{d}" for a, k, d, *_ in CASES])
def test_port_flops_against_reference_corrected_costs(arch, kind, dispatch, lo, hi, cause):
    want = ref_dryrun.corrected_costs(REF_ARCHS[arch].reduced(), kind,
                                      RefShape("t", 128, 2, kind), make_debug_mesh(1), dispatch)
    cfg = ARCHS[arch].reduced()
    with FakeTensorMode():
        got = dryrun.count_case(dryrun.abstract_case(cfg, kind, InputShape("t", 128, 2, kind),
                                                     1, "cpu"), None, dispatch)
    ratio = got["flops"] / want["flops"]
    assert lo <= ratio <= hi, f"{arch} {kind} {dispatch}: port/reference {ratio:.3f}; {cause}"
    # matmul-class work is most of every count
    assert got["matmul_flops"] > 0.9 * got["flops"]
