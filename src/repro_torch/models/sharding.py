"""Partition rules and their DTensor form, mirroring
``repro.models.sharding``.

The rules are the reference's, leaf for leaf (see its DESIGN.md §5):

* batch over the data axes (``pod`` × ``data`` when multi-pod),
* tensor parallel over ``model`` on heads / d_ff / experts,
* FSDP over the data axes on the non-TP dim of every large matrix,
* a dim that an axis does not divide stays replicated (``_fit``).

They are driven by each leaf's name and shape, so one function covers
every family, and they take anything with axis names and sizes: a
``DeviceMesh``, the reference's ``Mesh`` or ``AbstractMesh``, or a mapping
from axis name to size.  A spec is a :class:`PartitionSpec`, one entry a
tensor dim: ``None``, an axis name, or a tuple of axis names.

Storage and compute, which the reference leaves to GSPMD:

* :func:`placements` turns a spec into DTensor placements, and
  :func:`shard_tree` distributes a tree by its specs (the counterpart of
  ``to_named`` and jit's ``in_shardings``);
* :class:`Gathered` reads a tree of DTensors as the model code reads a
  ``ParamTree``: each leaf is all-gathered when it is used, and its
  gradient goes back to the leaf's own placements (a reduce-scatter over
  the data axes), so a step over it is ZeRO-3 over the mesh;
  :meth:`Gathered.block` gathers a leaf over the data axes only and keeps
  this rank's block over ``model``;
* :func:`data_sum`, :func:`model_sum`, :func:`model_enter` and
  :func:`model_gather` are the collectives the steps differentiate
  through.

Tensor-parallel compute over ``model`` follows the storage: a weight
stored with its output dim over ``model`` is column-parallel (the
replicated activation enters through :func:`model_enter`, each rank
computes its columns), one stored with its input dim over ``model`` is
row-parallel (each rank's partial product, one :func:`model_sum`), and
one that ``model`` does not divide is used whole.  :func:`model_dim`
reads which, :func:`linear` is a product from a replicated activation to
a replicated one under any of the three, :func:`embed_rows`,
:func:`head_logits` and :func:`vocab_nll` are the vocabulary-parallel
embedding, head and loss, :func:`kv_heads` picks the K/V heads that a
rank's query heads read, and :func:`ssm_heads` the Mamba-2 heads that a
rank computes.

Gradients follow one convention.  Over the data axes each rank back-
propagates its own share of the loss (its rows of the batch), and the
shares are summed into the parameters' gradients; over ``model`` a
replicated activation holds the whole gradient on every rank, and a
block of a weight the gradient of its block.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard, distribute_tensor

Tree = Any

TP_AXIS = "model"


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, an axis name, or a tuple of axis
    names (major to minor).  A tuple of one name is that name, as
    ``jax.sharding.PartitionSpec`` has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))


P = PartitionSpec


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------
def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order: a ``DeviceMesh`` (its dim
    names and shape), or anything with ``axis_names`` and a ``shape``
    mapping (the reference's ``Mesh`` and ``AbstractMesh``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """FSDP spans every data-parallel axis (ZeRO-3 across pods too)."""
    return data_axes(mesh)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh_sizes(mesh)[name]


def _fit(mesh, dim: int, axis):
    """Use ``axis`` on a dim only if it divides evenly."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 else None


def _matrix_spec(mesh, shape, col_parallel: bool, lead: int, serve: bool = False) -> P:
    """(in, out) weight: column-parallel shards out on TP and in on FSDP,
    row-parallel the reverse; ``lead`` leading (layer stack) dims stay
    whole.  ``serve=True`` puts the model axis on the contraction dim of
    every matmul (the reference's weight-stationary decode layout)."""
    d_in, d_out = shape[-2], shape[-1]
    fsdp = fsdp_axes(mesh)
    if serve or not col_parallel:
        spec = (_fit(mesh, d_in, TP_AXIS), _fit(mesh, d_out, fsdp))
    else:
        spec = (_fit(mesh, d_in, fsdp), _fit(mesh, d_out, TP_AXIS))
    return P(*([None] * lead), *spec)


COL_PARALLEL = {"wq", "wk", "wv", "wg", "wu", "wq_a", "wq_b", "wkv_a", "wkv_b", "w_in",
                "shared_wg", "shared_wu"}
ROW_PARALLEL = {"wo", "wd", "w_out", "shared_wd"}


def _param_rule(mesh, names: Sequence[str], shape, serve: bool) -> P:
    name = names[-1]
    ndim = len(shape)
    lead = 1 if ("layers" in names or "encoder" in names) else 0
    fsdp = fsdp_axes(mesh)
    if name == "embed":
        return P(_fit(mesh, shape[0], TP_AXIS), _fit(mesh, shape[1], fsdp))
    if name == "lm_head":
        return P(_fit(mesh, shape[0], fsdp), _fit(mesh, shape[1], TP_AXIS))
    if ndim - lead <= 1:  # norms, biases, gates
        return P(*([None] * ndim))
    if name in ("wg", "wu", "wd") and ndim - lead == 3:  # expert banks (E, d_in, d_out)
        e, d_in, d_out = shape[-3:]
        if name == "wd":
            return P(*([None] * lead), _fit(mesh, e, TP_AXIS), None, _fit(mesh, d_out, fsdp))
        return P(*([None] * lead), _fit(mesh, e, TP_AXIS), _fit(mesh, d_in, fsdp), None)
    if name == "router":
        return P(*([None] * lead), _fit(mesh, shape[-2], fsdp), None)
    if name in COL_PARALLEL:
        return _matrix_spec(mesh, shape, True, lead, serve)
    if name in ROW_PARALLEL:
        return _matrix_spec(mesh, shape, False, lead, serve)
    return P(*([None] * ndim))  # conv_w and anything else: replicated


#: The attention caches: (L, B, T, KH, hd) K/V and (L, B, T, latent) MLA
#: latents, their T over ``model``.
KV_CACHES = ("k", "v", "shared_k", "shared_v", "cross_k", "cross_v")
ATTENTION_CACHES = KV_CACHES + ("ckv", "krope")


def _cache_rule(mesh, name: str, shape) -> P:
    dp = data_axes(mesh)
    ndim = len(shape)
    if name == "pos":
        return P(_fit(mesh, shape[0], dp))
    if ndim >= 4 and name in KV_CACHES:
        # (L, B, T, KH, hd): batch over data, the cache's sequence over TP
        return P(None, _fit(mesh, shape[1], dp), _fit(mesh, shape[2], TP_AXIS),
                 *([None] * (ndim - 3)))
    if name in ("ckv", "krope"):  # (L, B, T, latent)
        return P(None, _fit(mesh, shape[1], dp), _fit(mesh, shape[2], TP_AXIS), None)
    if name in ("conv", "ssm"):  # (L, B, ...): SSM heads over TP on dim 2
        spec = [None, _fit(mesh, shape[1], dp)]
        if ndim > 2:
            spec.append(_fit(mesh, shape[2], TP_AXIS))
        return P(*spec, *([None] * (ndim - len(spec))))
    return P(*([None] * ndim))


def _map(fn, tree, path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``fn(path, leaf)`` over every tensor leaf of a mapping or
    ``ParamTree`` (``items()``), as nested dicts."""
    return {k: fn(path + (k,), v) if isinstance(v, torch.Tensor) else _map(fn, v, path + (k,))
            for k, v in tree.items()}


def param_pspecs(mesh, params: Tree, cfg=None, serve: bool = False) -> Dict[str, Any]:
    """Spec tree of ``params`` (a ``ParamTree`` or nested mapping of
    tensors, ``meta`` ones included): the reference's name-and-shape rules.
    ``serve=True`` selects the weight-stationary decode layout.  ``cfg`` is
    the reference's argument; the rules read names and shapes only."""
    return _map(lambda path, t: _param_rule(mesh, path, tuple(t.shape), serve), params)


def batch_pspecs(mesh, batch: Tree) -> Dict[str, Any]:
    """Each batch leaf's leading (batch) dim over the data axes."""
    dp = data_axes(mesh)

    def rule(path, t):
        b = t.shape[0] if t.dim() else 1
        return P(_fit(mesh, b, dp), *([None] * (t.dim() - 1)))

    return _map(rule, batch)


def cache_pspecs(mesh, cache: Tree) -> Dict[str, Any]:
    """Decode caches (L, B, T, heads/latent...): batch over the data axes,
    the cache's sequence over TP, SSM heads over TP, where they divide."""
    return _map(lambda path, t: _cache_rule(mesh, path[-1], tuple(t.shape)), cache)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------
def placements(mesh, spec: Sequence) -> List[Placement]:
    """One placement a mesh dim: ``Shard(i)`` where the dim's name is in
    ``spec[i]``, ``Replicate()`` elsewhere.  A tuple of names on one tensor
    dim is major to minor in the mesh's order, as DTensor splits it."""
    names = list(mesh_sizes(mesh))
    out: List[Placement] = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,) if entry is not None else ()
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(i)
    return out


def local_shard(x: torch.Tensor, sizes: Mapping, coords: Mapping,
                spec: Sequence) -> torch.Tensor:
    """The block of ``x`` that the mesh position ``coords`` (axis name ->
    index) holds under ``spec``, as a view: each sharded dim cut into equal
    blocks, mesh dims taken major to minor in ``sizes``' order."""
    for name, n in sizes.items():
        for i, entry in enumerate(spec):
            if entry == name or (isinstance(entry, tuple) and name in entry):
                step = x.shape[i] // n
                x = x.narrow(i, coords[name] * step, step)
    return x


def coords(mesh) -> Dict[str, int]:
    """This rank's index on each dim of a ``DeviceMesh``."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def _spec_at(specs: Mapping, path: Sequence[str]):
    for k in path:
        specs = specs[k]
    return specs


def shard_tree(tree: Tree, mesh, specs: Mapping) -> Tree:
    """``tree`` distributed over ``mesh`` by ``specs`` (from
    :func:`param_pspecs`, :func:`cache_pspecs` or :func:`batch_pspecs`):
    a ``ParamTree`` becomes one of frozen DTensor parameters, a mapping a
    dict of DTensors.  Each leaf is scattered from rank 0, so every rank
    holds rank 0's values."""
    out = _map(lambda path, t: distribute_tensor(t.detach(), mesh,
                                                 placements(mesh, _spec_at(specs, path))), tree)
    return out if isinstance(tree, Mapping) else type(tree)(out)


def check_sharded(tree: Tree, mesh, specs: Mapping, what: str) -> None:
    """Raise ``ValueError`` unless every leaf of ``tree`` is a DTensor on
    ``mesh`` with its spec's placements."""
    def check(path, t):
        want = tuple(placements(mesh, _spec_at(specs, path)))
        if not isinstance(t, DTensor) or t.device_mesh != mesh or tuple(t.placements) != want:
            got = tuple(t.placements) if isinstance(t, DTensor) else "a plain tensor"
            raise ValueError(f"{what} {'/'.join(path)} is {got}, want a DTensor with {want} "
                             f"(shard it with shard_tree)")

    _map(check, tree)


def gather_tree(tree: Tree) -> Dict[str, Any]:
    """Every DTensor leaf as its full tensor on every rank (a collective:
    every rank calls it), plain leaves as they are; nested dicts."""
    return _map(lambda path, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


# ---------------------------------------------------------------------------
# compute over DTensor storage
# ---------------------------------------------------------------------------
def _groups(mesh, axes: Sequence[str]):
    return [mesh.get_group(a) for a in axes]


class _SumOver(torch.autograd.Function):
    """``all_reduce(SUM)`` over ``groups``; the backward passes the
    gradient through unchanged."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone(memory_format=torch.contiguous_format)  # NCCL takes contiguous tensors
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    """The identity; the backward all-reduces the gradient over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return grad, None


def data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the data axes.  Its gradient is each rank's
    own share (the ranks' gradients are summed into the parameters')."""
    return _SumOver.apply(x, _groups(mesh, data_axes(mesh)))


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the data axes (see :func:`data_sum`)."""
    return data_sum(x, mesh) / _axis_size(mesh, data_axes(mesh))


def _one_model_rank(mesh) -> bool:
    """Whether ``model`` has one rank: its collectives are then the
    identity, and the helpers below skip them (no call to the group)."""
    return mesh_sizes(mesh)[TP_AXIS] == 1


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Partial results summed over ``model``: after it every model rank
    holds the same tensor, and the backward hands each rank's partial the
    whole (replicated) gradient."""
    if _one_model_rank(mesh):
        return x
    return _SumOver.apply(x, _groups(mesh, (TP_AXIS,)))


def model_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated tensor entering work split over ``model``: the
    identity, whose backward sums the ranks' partial gradients."""
    if _one_model_rank(mesh):
        return x
    return _CopyIn.apply(x, _groups(mesh, (TP_AXIS,)))


def model_rank(mesh) -> Tuple[int, int]:
    """(this rank's index on ``model``, the axis's size)."""
    return mesh.get_local_rank(TP_AXIS), mesh_sizes(mesh)[TP_AXIS]


#: One all-gather into a tensor (``all_gather_into_tensor`` where a build
#: has no ``all_gather_single``).
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _GatherOver(torch.autograd.Function):
    """``all_gather`` over ``group`` along ``dim``, in rank order; the
    backward takes this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.n, ctx.r, ctx.dim = n, r, dim
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=group)
        if dim == 0:
            return out
        shape = list(x.shape)
        shape[dim] *= n
        return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.r], None, None


def model_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every ``model`` rank's ``x`` concatenated along ``dim`` in rank
    order, the same on every rank; the backward takes this rank's slice."""
    if _one_model_rank(mesh):
        return x
    return _GatherOver.apply(x, mesh.get_group(TP_AXIS), dim % x.dim())


def model_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``model``, detached."""
    if _one_model_rank(mesh):
        return x.detach()
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.get_group(TP_AXIS))
    return y


class Gathered:
    """A tree of DTensors (a ``ParamTree`` of them, or one layer's slices)
    read as the model code reads a ``ParamTree``.  ``view[key]`` all-gathers
    a leaf to a plain replicated tensor at each use; ``unstack()`` and
    ``layer(i)`` cut stacked leaves into per-layer DTensors without moving
    data, so a layer's weights are gathered only when the layer runs (and,
    under remat, again in the backward pass).

    A gathered leaf's gradient is ``Partial`` over the data axes (each
    rank's rows of the batch), ``Replicate`` over ``model``; going back
    through the gather it becomes the leaf's own placements: a
    reduce-scatter over the data axes, a slice over ``model``."""

    def __init__(self, tree, mesh) -> None:
        self._tree = tree
        self._mesh = mesh
        data = data_axes(mesh)
        self._grad = [Partial() if n in data else Replicate() for n in mesh.mesh_dim_names]

    def __getitem__(self, key: str):
        val = self._tree[key]
        if not isinstance(val, torch.Tensor):
            return Gathered(val, self._mesh)
        full = val.redistribute(self._mesh, [Replicate()] * len(self._grad))
        return full.to_local(grad_placements=self._grad)

    def whole(self, key: str) -> torch.Tensor:
        """Leaf ``key`` gathered whole, for work split over ``model`` that
        reads more than this rank's block (the K/V heads of its query
        heads): its gradient is each rank's partial, summed back into the
        storage over every axis."""
        val = self._tree[key]
        full = val.redistribute(self._mesh, [Replicate()] * len(self._grad))
        return full.to_local(grad_placements=[Partial()] * len(self._grad))

    def __contains__(self, key: str) -> bool:
        return key in dict(self._tree.items())

    def block(self, key: str, dim: int) -> torch.Tensor:
        """This rank's block of leaf ``key`` along ``dim`` over ``model``,
        whole over the data axes (a tensor-parallel weight's block, the
        ``ep`` dispatch's expert bank); its gradient stays this rank's."""
        val = self._tree[key]
        names = self._mesh.mesh_dim_names
        want = [Shard(dim) if n == TP_AXIS else Replicate() for n in names]
        grad = [Shard(dim) if n == TP_AXIS else g for n, g in zip(names, self._grad)]
        return val.redistribute(self._mesh, want).to_local(grad_placements=grad)

    @staticmethod
    def _layer_placements(d: DTensor) -> List[Placement]:
        out = []
        for p in d.placements:
            if isinstance(p, Shard):
                if p.dim == 0:
                    raise ValueError("a layer stack is sharded on its layer dim")
                p = Shard(p.dim - 1)
            out.append(p)
        return out

    def unstack(self) -> List["Gathered"]:
        """One view a layer of this stack, each of per-layer DTensors cut
        from the local shards by one ``unbind`` a leaf."""
        def split(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, torch.Tensor):
                    places = self._layer_placements(v)
                    out[k] = [DTensor.from_local(part, self._mesh, places, run_check=False)
                              for part in torch.unbind(v.to_local())]
                else:
                    out[k] = split(v)
            return out

        def pick(parts, i):
            return {k: v[i] if isinstance(v, list) else pick(v, i) for k, v in parts.items()}

        parts = split(self._tree)
        n = len(next(iter(_leaf_lists(parts))))
        return [Gathered(pick(parts, i), self._mesh) for i in range(n)]

    def layer(self, i: int) -> "Gathered":
        """The view of layer ``i`` of this stack."""
        def pick(tree):
            return {k: DTensor.from_local(v.to_local()[i], self._mesh, self._layer_placements(v),
                                          run_check=False)
                    if isinstance(v, torch.Tensor) else pick(v) for k, v in tree.items()}

        return Gathered(pick(self._tree), self._mesh)


def _leaf_lists(parts: Mapping) -> Iterator[list]:
    for v in parts.values():
        if isinstance(v, list):
            yield v
        else:
            yield from _leaf_lists(v)


def model_block(p, key: str, dim: int, mesh) -> torch.Tensor:
    """This rank's block of ``p[key]`` along ``dim`` over ``model``: from a
    :class:`Gathered` view its DTensor's block, from a plain mapping (every
    rank holding the whole tensor) a slice.  ``model`` must divide the dim,
    as the reference's ``shard_map`` requires."""
    m, n = model_rank(mesh)
    size = (p._tree[key] if isinstance(p, Gathered) else p[key]).shape[dim]
    if size % n:
        raise ValueError(f"{key}'s dim {dim} ({size}) does not divide over |model| = {n}")
    if isinstance(p, Gathered):
        return p.block(key, dim)
    return p[key].chunk(n, dim)[m]


def model_dim(p, key: str, mesh) -> Optional[int]:
    """The dim of leaf ``key`` that is stored over ``model``, or None: a
    :class:`Gathered` view's DTensor placement, a plain mapping's
    :func:`param_pspecs` rule (the training layout; every rank holds the
    whole tensor)."""
    if isinstance(p, Gathered):
        place = p._tree[key].placements[list(mesh.mesh_dim_names).index(TP_AXIS)]
        return place.dim if isinstance(place, Shard) else None
    spec = _param_rule(mesh, (key,), tuple(p[key].shape), False)
    for i, entry in enumerate(spec):
        if entry == TP_AXIS or (isinstance(entry, tuple) and TP_AXIS in entry):
            return i
    return None


def whole(p, key: str, mesh) -> torch.Tensor:
    """``p[key]`` whole on every rank, its gradient each rank's partial
    (:meth:`Gathered.whole`)."""
    return p.whole(key) if isinstance(p, Gathered) else p[key]


def linear(x: torch.Tensor, p, key: str, mesh=None) -> torch.Tensor:
    """``x @ p[key]`` (no mesh: as it is).  With a mesh, for an ``x``
    replicated over ``model``, replicated out, split as the weight is
    stored: over its output dim each rank computes its columns and
    :func:`model_gather` joins them; over its input dim each rank
    multiplies its block of x's features and :func:`model_sum` adds the
    partials; whole where ``model`` does not split it.  No weight is
    gathered over ``model``."""
    if mesh is None:
        return x @ p[key]
    where = model_dim(p, key, mesh)
    if where == 1:
        return model_gather(model_enter(x, mesh) @ model_block(p, key, 1, mesh), mesh, -1)
    if where == 0:
        m, _ = model_rank(mesh)
        w = model_block(p, key, 0, mesh)
        k = w.shape[0]
        return model_sum(model_enter(x, mesh)[..., m * k:(m + 1) * k] @ w, mesh)
    return x @ p[key]


def heads_split(p, mesh, n_heads: int, q: str = "wq", o: str = "wo") -> bool:
    """Whether attention runs over this rank's ``n_heads / |model|`` query
    heads: the query projection ``q`` stored column-parallel and the
    output ``o`` row-parallel, both on whole heads."""
    _, n = model_rank(mesh)
    return n_heads % n == 0 and model_dim(p, q, mesh) == 1 and model_dim(p, o, mesh) == 0


def ssm_heads(cfg, mesh) -> Optional[Tuple[int, int]]:
    """The SSD heads [lo, hi) of a Mamba-2 layer that this rank computes:
    its H / n of the config's H heads where ``model``'s n ranks divide H
    (all of them at n = 1), else None, and the layer runs whole on every
    rank, as the reference's ``_fit`` replicates a dim that an axis does
    not divide.  Where n divides H it divides d_inner, so ``w_out``'s
    stored block over ``model`` is exactly these heads' rows, and the
    ``ssm`` cache's local shard exactly their states."""
    m, n = model_rank(mesh)
    h = cfg.n_ssm_heads
    return (m * h // n, (m + 1) * h // n) if h % n == 0 else None


def kv_heads(n_heads: int, n_kv_heads: int, mesh) -> Tuple[int, int, Optional[List[int]]]:
    """(lo, hi, per_q): the K/V heads [lo, hi) that this rank's query
    heads read (head h reads h // (n_heads / n_kv_heads)).  ``per_q`` is
    None where local query head i reads K/V head lo + i // (its group), as
    attention groups them; else each local query head's K/V head, from lo
    (the K/V heads are then expanded to one a query head)."""
    m, n = model_rank(mesh)
    hl, g = n_heads // n, n_heads // n_kv_heads
    reads = [(m * hl + i) // g for i in range(hl)]
    lo, hi = reads[0], reads[-1] + 1
    grouped = hl % (hi - lo) == 0 and all(r - lo == i // (hl // (hi - lo))
                                          for i, r in enumerate(reads))
    return lo, hi, None if grouped else [r - lo for r in reads]


def kv_weight(p, key: str, mesh, n_heads: int, n_kv_heads: int, head_dim: int) -> torch.Tensor:
    """The columns of the K or V projection ``p[key]`` (D, KH·hd) that this
    rank's query heads read (:func:`kv_heads`): its block where ``model``
    splits the K/V heads evenly, else the weight gathered whole and
    sliced to those heads (``model`` would cut it through a head)."""
    _, n = model_rank(mesh)
    if n_kv_heads % n == 0 and model_dim(p, key, mesh) == 1:
        return model_block(p, key, 1, mesh)
    lo, hi, _ = kv_heads(n_heads, n_kv_heads, mesh)
    return whole(p, key, mesh)[:, lo * head_dim:hi * head_dim]


def embed_rows(p, ids: torch.Tensor, mesh) -> torch.Tensor:
    """``p["embed"][ids]`` (ids within the table).  Where the vocabulary is
    stored over ``model`` each rank looks up the rows it owns, gives 0 for
    the others', and :func:`model_sum` adds the parts."""
    if model_dim(p, "embed", mesh) != 0:
        return p["embed"][ids]
    m, _ = model_rank(mesh)
    w = model_block(p, "embed", 0, mesh)
    v = w.shape[0]
    local = ids - m * v
    own = (local >= 0) & (local < v)
    rows = w[local.clamp(0, v - 1)]
    return model_sum(torch.where(own[..., None], rows, torch.zeros_like(rows)), mesh)


def head_logits(p, h: torch.Tensor, tied: bool, mesh) -> Tuple[torch.Tensor, Optional[int]]:
    """(logits, lo): ``h`` times the head (``lm_head``, or ``embed.T`` where
    ``tied``).  Where the vocabulary is stored over ``model`` the head is
    column-parallel: the logits are this rank's columns, from vocabulary
    id ``lo``; else they are whole and ``lo`` is None."""
    key, dim = ("embed", 0) if tied else ("lm_head", 1)
    if model_dim(p, key, mesh) != dim:
        w = p[key]
        return h @ (w.T if tied else w), None
    m, _ = model_rank(mesh)
    w = model_block(p, key, dim, mesh)
    return model_enter(h, mesh) @ (w.T if tied else w), m * w.shape[dim]


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor, lo: int, mesh) -> torch.Tensor:
    """-log softmax(logits)[targets] over a vocabulary split over
    ``model``, in fp32: ``logits`` (..., V_loc) are this rank's columns,
    from id ``lo``.  The max over ``model`` (detached), the sum of the
    exponentials over ``model``, and the target's logit from the rank
    that owns it: ``log_softmax`` over the whole vocabulary (which it is,
    op for op, at one ``model`` rank)."""
    x = logits.float()
    v = x.shape[-1]
    if model_rank(mesh)[1] == 1:
        return -torch.gather(torch.log_softmax(x, dim=-1), -1, targets.long()[..., None])[..., 0]
    top = model_max(x.amax(dim=-1), mesh)
    total = model_sum(torch.exp(x - top[..., None]).sum(dim=-1), mesh)
    local = targets.long() - lo
    own = (local >= 0) & (local < v)
    picked = torch.gather(x, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    picked = model_sum(torch.where(own, picked, torch.zeros_like(picked)), mesh)
    return torch.log(total) + top - picked


def local_rows(x: torch.Tensor, mesh, spec: Optional[Sequence] = None) -> torch.Tensor:
    """This rank's rows of a batch leaf under ``spec`` (its
    :func:`batch_pspecs` entry when None): a DTensor's local shard, or the
    block of a plain tensor that every rank holds whole."""
    if spec is None:
        spec = batch_pspecs(mesh, {"x": x})["x"]
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(mesh, spec)).to_local()
    return local_shard(x, mesh_sizes(mesh), coords(mesh), spec)
