"""What one step costs, counted as it runs: the port's counterpart of
XLA's ``compiled.cost_analysis()``, ``memory_analysis()`` and the
reference's ``parse_collective_bytes``.

:class:`StepCounter` is a ``TorchDispatchMode``: every ATen op that a step
dispatches inside it (the forward, autograd's backward, the optimizer, and
the collectives of ``torch.distributed``) passes through it once, on real
tensors or on fake ones (``FakeTensorMode``), so a count on fake tensors
over a fake process group (:func:`repro_torch.launch.specs.abstract_world`)
is the count of the same step run for real.  DTensor ops are let through
(``NotImplemented``) and counted as the local ops DTensor turns them into,
so every number is one rank's; what DTensor runs on fake tensors of its
own to work out an op's output (a cache fills as ops are first seen) is
not the step's and is not counted.  It counts (``ops``: the ops that
return a tensor):

* **FLOPs**: the matmul-class ops by the table
  ``torch.utils.flop_counter.FlopCounterMode`` reads
  (``flop_registry``: 2·M·N·K a product; the grouped matmul's formula is
  registered in :mod:`repro_torch.kernels.ref`), kept apart as
  ``matmul_flops``; plus one FLOP an output element of every op tagged
  ``pointwise`` (transcendentals included, casts and copies excluded),
  and one an input element of every reduction in :data:`REDUCTIONS`.
  XLA counts elementwise work by its own rules (transcendentals apart)
  and counts a fused loop body once; the two totals agree on matmul-bound
  steps only.
* **Bytes accessed**: each op's tensor inputs read once and outputs
  written once; a view (an output on an input's storage, not written),
  an allocation without a write and an op that returns no tensor (a
  query of metadata) move nothing.  This is the eager
  port's *unfused* traffic: every intermediate goes to memory and back,
  where XLA's count is of its fused kernels, so it is larger.
* **Collectives by kind**: the result-shape bytes of every collective of
  ``_c10d_functional`` or ``c10d`` (all-gather, reduce-scatter,
  all-reduce, all-to-all), with a count, as the reference's proxy
  (``repro/launch/dryrun.py::parse_collective_bytes``); and the same bytes
  by the slowest link the op's group crosses (``links``): ``nvlink`` where
  every rank of the group is on one node of
  :data:`~repro_torch.launch.mesh.CARDS_PER_NODE` cards, ``nic`` where it
  spans nodes.  A collective the table does not know raises.
* **Peak live bytes**: ``resident`` (the step's state, handed in) plus the
  most bytes that storages made inside the count held at once, each
  rounded up to the card's caching-allocator block of
  :data:`ALLOC_ROUND` bytes, freed when the storage dies.

The hand-written kernels launch through ``ctypes`` and no dispatch mode
sees them, so while a count runs :func:`repro_torch.kernels._build.load`
refuses them (count a step with ``impl="ref"``).
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.launch.mesh import CARDS_PER_NODE

#: The reference's collective kinds, in its order (``parse_collective_bytes``).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_FUNCOL = torch.ops._c10d_functional
_C10D = torch.ops.c10d
#: Each collective op's kind, by the op's name in its namespace (an op a
#: PyTorch build lacks is left out).  Result bytes: the functional ops'
#: output; the in-place ``c10d`` ops' written tensors (all-reduce: the input).
_NAMES = {
    _FUNCOL: {"all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
              "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
              "all_to_all_single": "all-to-all"},
    _C10D: {"allreduce_": "all-reduce", "allgather_": "all-gather",
            "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
            "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
            "alltoall_": "all-to-all"},
}
_KINDS = {getattr(ns, name): kind for ns, names in _NAMES.items() for name, kind in names.items()
          if hasattr(ns, name)}
_ATEN = torch.ops.aten
#: Reductions: one FLOP an input element.
REDUCTIONS = frozenset({
    _ATEN.sum, _ATEN.mean, _ATEN.amax, _ATEN.amin, _ATEN.max, _ATEN.min, _ATEN.prod,
    _ATEN.logsumexp, _ATEN.linalg_vector_norm, _ATEN.cumsum, _ATEN.cumprod,
    _ATEN._softmax, _ATEN._log_softmax, _ATEN._softmax_backward_data,
    _ATEN._log_softmax_backward_data,
})
#: Allocations that write nothing: no bytes accessed (their storage is live).
_NO_WRITE = frozenset({_ATEN.empty, _ATEN.empty_strided, _ATEN.new_empty,
                       _ATEN.new_empty_strided, _ATEN.empty_like})
#: The card's caching allocator hands out blocks in multiples of this.
ALLOC_ROUND = 512
#: The links a collective's group may cross, fastest first.
LINKS = ("nvlink", "nic")


def group_ranks(func, args, kwargs) -> list:
    """The global ranks of collective ``func``'s group: its ``group_name``
    (``_c10d_functional``) or ``process_group`` (``c10d``) argument's."""
    bound = dict(kwargs)
    for arg, val in zip(func._schema.arguments, args):
        bound[arg.name] = val
    if "group_name" in bound:
        group = _resolve_process_group(bound["group_name"])
    else:
        group = dist.ProcessGroup.unbox(bound["process_group"])
    return dist.get_process_group_ranks(group)


def link_of(func, args, kwargs) -> str:
    """The slowest link the group of collective ``func`` crosses: its
    ranks (:func:`group_ranks`) on nodes of ``CARDS_PER_NODE``."""
    nodes = {r // CARDS_PER_NODE for r in group_ranks(func, args, kwargs)}
    return LINKS[0] if len(nodes) == 1 else LINKS[1]


#: DTensor works out an op's output by running it on fake tensors of the
#: global shape, in this function, once for each new (op, placements)
#: (a cache): those runs are not the step's.
_PROPAGATION = "_propagate_tensor_meta_non_cached"


def _in_propagation(depth: int = 16) -> bool:
    """Whether DTensor's output propagation is among the callers."""
    frame = sys._getframe(2)
    while frame is not None and depth:
        if frame.f_code.co_name == _PROPAGATION:
            return True
        frame, depth = frame.f_back, depth - 1
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its StorageImpl)."""
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class Counts:
    """One rank's count of a step (see the module's docstring)."""

    flops: int = 0
    matmul_flops: int = 0
    bytes_accessed: int = 0
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {**{k: 0 for k in COLLECTIVES}, "count": 0})
    links: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {link: {k: 0 for k in COLLECTIVES} for link in LINKS})
    resident_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0

    def as_record(self) -> Dict:
        return dataclasses.asdict(self)


class StepCounter(TorchDispatchMode):
    """Count what runs inside ``with StepCounter(resident=...) as c:`` into
    ``c.counts`` (a :class:`Counts`).  ``resident``: the bytes the step's
    inputs already hold on the device (params, moments, cache, batch),
    where the peak starts.  Enter it inside ``FakeTensorMode`` to count a
    step on fake tensors.  Hand-kernel launches raise while it is open."""

    def __init__(self, resident: int = 0) -> None:
        super().__init__()
        self.counts = Counts(resident_bytes=int(resident), peak_bytes=int(resident))
        self._live = 0
        # the storages made inside the count that are alive
        self._made: set = set()
        self._refusal = None

    def __enter__(self):
        self._refusal = _build.refuse_launches("a StepCounter is counting this step: a hand "
                                               "kernel is invisible to it; count with impl='ref'")
        self._refusal.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._refusal.__exit__(*exc)

    def _freed(self, key: int, size: int) -> None:
        self._made.discard(key)
        self._live -= size

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        """Add ``t``'s storage to the live bytes, unless an input holds it
        or it is counted already; it leaves them when it dies."""
        key = _key(t)
        if key in self._made or key in inputs:
            return
        st = t.untyped_storage()
        size = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._made.add(key)
        weakref.finalize(st, self._freed, key, size)
        self._live += size
        self.counts.peak_bytes = max(self.counts.peak_bytes, self.counts.resident_bytes + self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops, which come back here
        kwargs = kwargs or {}
        packet = func._overloadpacket
        flat_in = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        fake = any(isinstance(x, torch._subclasses.FakeTensor) for x in flat_in)
        if packet is _FUNCOL.wait_tensor:
            # eager wait_tensor hands back its input; the fake kernel makes
            # a new tensor, which would count as an allocation
            return args[0] if fake else func(*args, **kwargs)
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        c = self.counts
        flat_out = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        c.ops += bool(flat_out)
        in_storages = {_key(x) for x in flat_in}
        if packet in _KINDS:
            # the result: the op's tensors, or (``alltoall_base_`` returns
            # only a Work) the output it wrote, its first argument
            result = flat_out or [x for x in tree_flatten(args[0])[0]
                                  if isinstance(x, torch.Tensor)]
            size = sum(_nbytes(x) for x in result)
            c.collectives[_KINDS[packet]] += size
            c.collectives["count"] += 1
            c.links[link_of(func, args, kwargs)][_KINDS[packet]] += size
        elif func.namespace in ("c10d", "_c10d_functional"):
            raise NotImplementedError(f"StepCounter has no kind for the collective {func}")
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            c.matmul_flops += f
        elif torch.Tag.pointwise in func.tags and flat_out:
            c.flops += flat_out[0].numel()
        elif packet in REDUCTIONS and flat_in:
            c.flops += flat_in[0].numel()
        mutable = func._schema.is_mutable
        view = not mutable and all(_key(x) in in_storages for x in flat_out)
        if flat_out and not view and packet not in _NO_WRITE:
            c.bytes_accessed += sum(_nbytes(x) for x in flat_in) + sum(_nbytes(x) for x in flat_out)
        for x in flat_out:
            self._track(x, in_storages)
        return out
