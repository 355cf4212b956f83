"""Logical-axis parameter partitioning, the port of
``repro.sharding.partition``.

A :class:`Param` box carries a value and a tuple of *logical axis names*
(one a dim).  The port's model functions take plain tensors, so boxes
appear only on the abstract path: ``models.layers.abstract`` (the
counterpart of ``jax.eval_shape`` over an initializer) runs an
initializer with every leaf boxed around a tensor on the meta device,
which holds a shape and a dtype and no data.  A rule table maps logical
names onto mesh axes; :func:`tree_shardings` gives each boxed leaf its
spec on a mesh, and :func:`local_shape` the shard a rank holds under it.

A spec is a tuple with one entry a dim: ``None`` (replicated), a mesh
axis name, or a tuple of names (the ``PartitionSpec`` of the JAX
package).  A mesh is an :class:`AbstractMesh` (axis names and sizes, no
processes: the dry run's production meshes) or a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names`` and
``shape``).

On a ``DeviceMesh`` a spec becomes a :class:`NamedSharding` (the mesh,
the spec, and the ``DTensor`` placements they give), and :func:`place`
puts a tree of whole tensors on the mesh as ``DTensor`` leaves, each
rank keeping its block (the counterpart of ``jax.device_put(tree,
shardings)``).  A dim split over several axes is cut in the entry's
order, the first axis major, as ``P(("model", "data"))`` cuts it, also
where the entry's order is not the mesh's (``_StridedShard`` then
carries the order in the placements).  :func:`full_tensor` gathers a
leaf whole again through ``repro_torch.distributed``'s collectives.  A
train state of such leaves makes ``train.loop.make_train_step`` run
partitioned, and a parameter tree of them ``models.partitioned``'s
prefill and decode; inside them a :func:`row_shard` says which rows of
the global batch this rank holds.

The model functions see a partitioned leaf as a :class:`Blocked` (this
rank's block and its sharding, on a ``DeviceMesh`` or, in the dry run,
on an abstract mesh standing for one rank), take a layer of a stack
from it with no communication, and gather it whole only where it is
used (:func:`whole`: a super-block at a time, the embedding and the
unembedding on their own); the gather's backward reduces the gradient
to the block (:func:`reduce_to_block`).

Logical axis vocabulary used across the model zoo:

    "batch"      activation batch                  -> ("pod", "data")
    "seq"        activation sequence (SP regions)  -> "model"
    "embed"      residual-stream / d_model dim     -> "data"   (FSDP shard)
    "vocab"      embedding-table vocabulary        -> "model"
    "heads"      query heads                       -> "model"  (TP)
    "kv_heads"   KV heads (may be < TP degree)     -> None     (replicated)
    "head_dim"   per-head dim                      -> None
    "mlp"        FFN hidden dim                    -> "model"  (TP)
    "expert"     MoE expert dim                    -> "model"  (EP)
    "layers"     stacked layers dim                -> None
    "kv_seq"     KV-cache sequence dim (decode)    -> "model"  (flash-decoding)
    "ssm_state"  SSM state dim                     -> None
    "ssm_heads"  SSD heads                         -> "model"
    "lora"       MLA latent / low-rank dims        -> None
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import sys
from typing import Any, Sequence

import torch

from repro_torch import distributed as pdist
from repro_torch.train.checkpoint import _flatten_with_names


@dataclasses.dataclass
class Param:
    """A parameter value boxed with its logical axis names;
    ``len(axes) == value.ndim``.  The tree helpers take a box as one
    leaf."""

    value: Any
    axes: tuple

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype


def is_param(x) -> bool:
    return isinstance(x, Param)


def _map_boxes(fn, tree):
    _, leaves, unflatten = _flatten_with_names(tree)
    return unflatten([fn(x) for x in leaves])


def unbox(tree):
    """Boxed tree -> plain value tree (same structure minus boxes).
    Leaves that are not boxes pass through unchanged."""
    return _map_boxes(lambda p: p.value if is_param(p) else p, tree)


def boxed_axes(tree):
    """Boxed tree -> tree of logical-axes tuples (None for a leaf that is
    not a box)."""
    return _map_boxes(lambda p: p.axes if is_param(p) else None, tree)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

# Each logical axis maps to a mesh axis name, a tuple of mesh axis names, or
# None (replicated).
AxisRules = tuple  # tuple[tuple[str, str | tuple | None], ...]

DEFAULT_RULES: AxisRules = (
    ("batch", ("pod", "data")),
    ("cache_batch", ("pod", "data")),  # KV-cache batch dim (decode)
    ("seq", "model"),
    ("embed", "data"),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", None),
    ("head_dim", None),
    ("mlp", "model"),
    ("expert", "model"),
    ("expert_cap", "data"),  # MoE dispatch-buffer capacity dim (2D EP)
    ("expert_mlp", None),
    ("layers", None),
    ("kv_seq", "model"),
    ("ssm_state", None),
    ("ssm_heads", "model"),
    ("lora", None),
    ("conv_kernel", None),
    ("unsharded", None),
)

# The platform engines' axes: route lanes along "routes" (data parallel),
# pipeline stage groups along "stages"; per-accelerator rows, task windows
# and queues replicated.
PLATFORM_RULES: AxisRules = (
    ("routes", "routes"),
    ("stages", "stages"),
    ("accel", None),
    ("window", None),
    ("tasks", None),
)

# Decode-time rules: weights 2D-sharded along their non-embed dims
# (heads|mlp x head_dim|data-split of mlp), never along the contraction
# (embed) dim; activations replicate over "data"; the KV cache keeps its
# batch sharding ("cache_batch").
_DECODE_OVERRIDES = {
    "batch": ("pod",),
    "embed": None,
    "mlp": ("model", "data"),
    "expert_mlp": "data",
    "head_dim": "data",
    "seq": None,
}
DECODE_RULES: AxisRules = tuple(
    (name, _DECODE_OVERRIDES.get(name, target))
    if name in _DECODE_OVERRIDES else (name, target)
    for name, target in DEFAULT_RULES
)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes with no processes behind it (the
    counterpart of ``jax.sharding.AbstractMesh``): what the dry run
    shards the production meshes' specs over.  ``coordinate`` names the
    rank a rank-local trace stands for (rank 0 unless given):
    ``distributed``'s helpers run shape-only on such a mesh."""

    axis_sizes: tuple
    axis_names: tuple
    coordinate: tuple = ()

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs one "
                             f"axis name a dimension, got {self.axis_names}")
        if not self.coordinate:
            object.__setattr__(self, "coordinate",
                               (0,) * len(self.axis_sizes))
        if len(self.coordinate) != len(self.axis_sizes) or any(
                not 0 <= c < n for c, n in zip(self.coordinate,
                                               self.axis_sizes)):
            raise ValueError(f"coordinate {self.coordinate} is off the "
                             f"mesh of shape {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(shape, names, coordinate=()) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(names),
                        tuple(int(c) for c in coordinate))


def mesh_axis_names(mesh) -> tuple:
    """An abstract mesh's ``axis_names`` or a ``DeviceMesh``'s
    ``mesh_dim_names``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_mesh_axes(axes: Sequence[str | None], rules: AxisRules,
                         mesh) -> tuple:
    """Map a tuple of logical axis names to a spec.

    Mesh axes not present in ``mesh`` are dropped (so one rule table works
    for both the single-pod and multi-pod meshes).  A mesh axis may be used
    at most once in a spec; later logical dims asking for an already-used
    mesh axis are left replicated.
    """
    table = dict(rules)
    names = mesh_axis_names(mesh)
    used: set = set()
    spec = []
    for name in axes:
        if name is None:
            spec.append(None)
            continue
        if name not in table:
            raise ValueError(f"no partition rule for logical axis {name!r}")
        target = table[name]
        if target is None:
            spec.append(None)
            continue
        targets = target if isinstance(target, tuple) else (target,)
        avail = tuple(t for t in targets if t in names and t not in used)
        if not avail:
            spec.append(None)
            continue
        used.update(avail)
        spec.append(avail if len(avail) > 1 else avail[0])
    return tuple(spec)


def _divisible(shape, spec: tuple, mesh) -> tuple:
    """Drop mesh axes that do not evenly divide a dim (a prefix of the
    axes that still divides is kept), so no shard is padded."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        total = math.prod(sizes[n] for n in names)
        if total and dim % total == 0:
            out.append(entry)
        else:
            kept = []
            prod = 1
            for n in names:
                if dim % (prod * sizes[n]) == 0:
                    kept.append(n)
                    prod *= sizes[n]
            out.append(tuple(kept) if len(kept) > 1
                       else (kept[0] if kept else None))
    return tuple(out)


def param_spec(p: Param, mesh, rules: AxisRules = DEFAULT_RULES) -> tuple:
    """A boxed leaf's divisible spec on ``mesh``."""
    return _divisible(p.shape, logical_to_mesh_axes(p.axes, rules, mesh),
                      mesh)


def tree_shardings(boxed_tree, mesh, rules: AxisRules = DEFAULT_RULES):
    """Boxed tree -> tree of specs (same structure).  A spec is a tuple,
    so flatten the boxed tree, not this one, to pair leaves with specs."""
    return _map_boxes(lambda p: param_spec(p, mesh, rules), boxed_tree)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shard of ``shape`` one rank holds under ``spec`` (a divisible
    spec: each dim split by the product of its axes' sizes)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        split = math.prod(sizes[n] for n in names)
        if dim % split:
            raise ValueError(f"dim {dim} does not split over {names}")
        out.append(dim // split)
    return tuple(out)


# ---------------------------------------------------------------------------
# Placement on a mesh of processes (DTensor)
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _split_factor(entry: tuple, axis: str, names: tuple, sizes: dict
                  ) -> int:
    """How many pieces the axes before ``axis`` in ``entry`` (more major)
    but after it in the mesh have cut a dim into before ``axis`` cuts it:
    1 where the entry keeps the mesh's order."""
    i, k = entry.index(axis), names.index(axis)
    return math.prod(sizes[b] for b in entry[:i] if names.index(b) > k)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a spec (the counterpart of
    ``jax.sharding.NamedSharding``).

    ``placements`` has one ``DTensor`` placement a mesh axis:
    ``Shard(d)`` where the spec's entry for tensor dim ``d`` names that
    axis, else ``Replicate()``.  An entry naming several axes, such as
    ``("pod", "data")``, shards its dim over each of them, the entry's
    first axis major, which is the block order of ``P(("pod",
    "data"))``.  ``DTensor`` applies placements in the mesh's axis order,
    so an axis that the entry puts after a later mesh axis (``"data"``
    in ``("model", "data")`` on a ``("data", "model")`` mesh) gets
    ``_StridedShard(d, split_factor=...)``: the blocks JAX's
    ``P(("model", "data"))`` gives each device."""

    mesh: Any
    spec: tuple

    def __post_init__(self):
        names = mesh_axis_names(self.mesh)
        used: set = set()
        for entry in self.spec:
            for a in _entry_axes(entry):
                if a not in names or a in used:
                    raise ValueError(f"spec {self.spec} names {a!r} "
                                     f"twice or off the mesh's {names}")
                used.add(a)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.placement_types import _StridedShard
        names = mesh_axis_names(self.mesh)
        sizes = mesh_shape(self.mesh)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            for a in axes:
                sf = _split_factor(axes, a, names, sizes)
                out[names.index(a)] = (Shard(d) if sf == 1 else
                                       _StridedShard(d, split_factor=sf))
        return tuple(out)


def named_sharding(axes: Sequence[str | None], mesh,
                   rules: AxisRules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, logical_to_mesh_axes(axes, rules, mesh))


def tree_named_shardings(boxed_tree, mesh, rules: AxisRules = DEFAULT_RULES):
    """Boxed tree -> tree of :class:`NamedSharding` leaves on ``mesh``
    (each box's divisible spec, as :func:`tree_shardings` gives it)."""
    return _map_boxes(lambda p: NamedSharding(mesh, param_spec(p, mesh,
                                                               rules)),
                      boxed_tree)


def is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported (~1 s), so the
    # meshless paths never import it
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shard_of(pl):
    """(tensor dim, split factor) of a ``Shard`` or ``_StridedShard``
    placement; None for any other."""
    if type(pl).__name__ == "_StridedShard":
        return pl.dim, int(pl.split_factor)
    if pl.is_shard():
        return pl.dim, 1
    return None


def sharding_of(x) -> NamedSharding:
    """A ``DTensor``'s mesh and spec: each dim's axes in the order whose
    split factors its placements carry (the mesh's order where they all
    are 1)."""
    import itertools
    if not is_dtensor(x):
        raise TypeError(f"a partitioned state's leaves are DTensors, not "
                        f"{type(x).__name__}")
    mesh = x.device_mesh
    names, sizes = mesh_axis_names(mesh), mesh_shape(mesh)
    by_dim: dict = {}
    for a, pl in zip(names, x.placements):
        got = _shard_of(pl)
        if got is not None:
            by_dim.setdefault(got[0], {})[a] = got[1]
    spec = []
    for d in range(x.dim()):
        factors = by_dim.get(d, {})
        for order in itertools.permutations(factors):
            if all(_split_factor(order, a, names, sizes) == f
                   for a, f in factors.items()):
                break
        else:
            raise ValueError(f"placements {x.placements} give dim {d} no "
                             f"block order")
        spec.append(order if len(order) > 1 else (order[0] if order
                                                  else None))
    return NamedSharding(mesh, tuple(spec))


def block_of(x, sharding: NamedSharding):
    """This rank's block of the whole tensor ``x`` under ``sharding`` (a
    copy, so that ``x`` can go)."""
    sizes = mesh_shape(sharding.mesh)
    for d, entry in enumerate(sharding.spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {axes}")
        k = x.shape[d] // n
        x = x.narrow(d, pdist.block_index(sharding.mesh, axes) * k, k)
    return x.clone(memory_format=torch.contiguous_format)


def from_local(local, sharding: NamedSharding):
    """A ``DTensor`` from this rank's block ``local`` (no communication;
    the blocks are even, so the global shape is the block's times the
    split of each dim)."""
    from torch.distributed.tensor import DTensor
    if local.device.type != sharding.mesh.device_type:
        raise ValueError(
            f"a {local.device.type} tensor on a {sharding.mesh.device_type} "
            f"mesh would move there: build the mesh on the state's device "
            f"type (launch.mesh.make_test_mesh(device=...))")
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def place(tree, shardings):
    """Whole tensors -> ``DTensor`` leaves on the shardings' meshes, each
    rank keeping its block with no communication (the counterpart of
    ``jax.device_put(tree, shardings)``; every rank passes the same
    values).  ``shardings`` is a tree of :class:`NamedSharding` leaves of
    ``tree``'s structure.  A tensor stays on its device: one whose device
    type is not its mesh's raises, since ``DTensor`` would move it."""
    _, leaves, unflatten = _flatten_with_names(tree)
    shards = _flatten_with_names(shardings)[1]
    if len(shards) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(shards)} shardings")
    return unflatten([from_local(block_of(x, sh), sh)
                      for x, sh in zip(leaves, shards)])


def gather_block(local, sharding: NamedSharding):
    """The whole tensor from this rank's block ``local`` (one all-gather
    a sharded axis of more than one rank, each dim's minor axis first,
    through ``repro_torch.distributed``; shape-only on an abstract
    mesh)."""
    out, mesh = local, sharding.mesh
    for d, entry in enumerate(sharding.spec):
        for a in reversed(_entry_axes(entry)):
            if pdist.mesh_size(mesh, a) > 1:
                out = pdist.gather_dim(out, mesh, a, d)
    return out


def full_tensor(x, device=None):
    """A ``DTensor`` leaf whole on every rank (:func:`gather_block` of its
    block), on ``device`` (default: the leaf's); any other leaf as it
    is."""
    if not is_dtensor(x):
        return x
    out = gather_block(x.to_local(), sharding_of(x))
    return out.to(out.device if device is None else device)


def reduce_to_block(g: torch.Tensor, sharding: NamedSharding,
                    batch_axes=()) -> torch.Tensor:
    """A gradient of this rank's rows (the whole leaf: a part of the sum
    over ``batch_axes``) -> this rank's block of the summed gradient, in
    ``g``'s dtype (summed in fp32).  Each dim's axes major first: a batch
    axis the leaf is sharded on reduce-scatters, any other sharded axis
    takes this rank's block; then the batch axes the leaf is not sharded
    on sum (a sum commutes with taking blocks); an axis of one rank does
    nothing."""
    mesh = sharding.mesh
    x, held = g.float(), set()
    for d, entry in enumerate(sharding.spec):
        for axis in _entry_axes(entry):
            held.add(axis)
            n = pdist.mesh_size(mesh, axis)
            if n == 1:
                continue
            if axis in batch_axes:
                x = pdist.reduce_scatter_dim(x, mesh, axis, d)
            else:
                k = x.shape[d] // n
                x = x.narrow(d, pdist.mesh_rank(mesh, axis) * k, k)
    for axis in batch_axes:
        if axis not in held and pdist.mesh_size(mesh, axis) > 1:
            x = pdist.psum(x, mesh, axis)
    return x.to(g.dtype).contiguous()


class Blocked:
    """This rank's block ``local`` of a leaf placed by ``sharding`` (a
    :class:`NamedSharding` on a ``DeviceMesh`` or an abstract mesh): how
    the model functions see a partitioned leaf.  ``b[j]`` and
    ``b.unbind(0)`` take layers of a stack whose leading dim is not
    split, with no communication; :func:`whole` gathers it."""

    __slots__ = ("local", "sharding")

    def __init__(self, local: torch.Tensor, sharding: NamedSharding):
        self.local, self.sharding = local, sharding

    @property
    def spec(self) -> tuple:
        return tuple(self.sharding.spec) + (None,) * (
            self.local.dim() - len(self.sharding.spec))

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def dtype(self):
        return self.local.dtype

    def _rest(self) -> NamedSharding:
        if self.spec[0] is not None:
            raise ValueError(f"the leading dim of a leaf split as "
                             f"{self.spec} is not a stack of layers")
        return NamedSharding(self.mesh, self.spec[1:])

    def __getitem__(self, j):
        return Blocked(self.local[j], self._rest())

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a Blocked leaf unbinds its layers dim only")
        rest = self._rest()
        return [Blocked(x, rest) for x in self.local.unbind(0)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, sharding, batch_axes):
        ctx.sharding, ctx.batch_axes = sharding, batch_axes
        return gather_block(local, sharding)

    @staticmethod
    def backward(ctx, g):
        return reduce_to_block(g, ctx.sharding, ctx.batch_axes), None, None


def whole(x):
    """A leaf whole: a :class:`Blocked` gathered (its backward reduces
    the gradient of this rank's rows, :func:`current_row_shard`'s, to
    the block), a ``DTensor`` by :func:`full_tensor`, any other leaf as
    it is."""
    if isinstance(x, Blocked):
        shard = current_row_shard()
        return _Gather.apply(x.local, x.sharding,
                             () if shard is None else shard.axes)
    return full_tensor(x)


def whole_tree(tree):
    """:func:`whole` of every leaf of a dict tree (a super-block's
    parameters); a tree of plain tensors comes back as it is."""
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    return whole(tree)


def blocked(tree):
    """A tree's ``DTensor`` leaves as :class:`Blocked` (their local
    blocks, no copy); other leaves pass through."""
    _, leaves, unflatten = _flatten_with_names(tree)
    return unflatten([Blocked(x.to_local(), sharding_of(x))
                      if is_dtensor(x) else x for x in leaves])


def mesh_of(leaves):
    """The mesh of the first ``DTensor`` among ``leaves`` (None if there
    is none)."""
    for x in leaves:
        if is_dtensor(x):
            return x.device_mesh
    return None


# ---------------------------------------------------------------------------
# A partitioned step's rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows of a global batch in a partitioned step: the rows
    split over ``axes`` of ``mesh`` (the "batch" rule's axes, the first
    major), this rank's block ``index`` of ``blocks``."""

    mesh: Any
    axes: tuple

    @property
    def blocks(self) -> int:
        return math.prod(pdist.mesh_size(self.mesh, a) for a in self.axes)

    @property
    def index(self) -> int:
        return pdist.block_index(self.mesh, self.axes)


_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_row_shard", default=None)


@contextlib.contextmanager
def row_shard(mesh, axes):
    """Within the block the model functions see this rank's rows of the
    batch; ``models.moe.moe_apply`` routes the tokens of all ranks' rows
    (capacity, "first tokens win" and the aux loss are functions of the
    whole batch) and keeps this rank's, with its share of the aux loss."""
    token = _ROWS.set(RowShard(mesh, tuple(axes)))
    try:
        yield
    finally:
        _ROWS.reset(token)


def current_row_shard():
    return _ROWS.get()


# ---------------------------------------------------------------------------
# Ambient mesh/rules context (set by the launcher; no-op in plain tests)
# ---------------------------------------------------------------------------

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def activate(mesh, rules: AxisRules = DEFAULT_RULES):
    """Install ``mesh`` + ``rules`` as the ambient partitioning context
    (``moe_impl="shard_map"`` reads it)."""
    token = _CTX.set((mesh, rules))
    try:
        yield mesh
    finally:
        _CTX.reset(token)


def current_mesh_and_rules():
    return _CTX.get()


def with_logical_constraint(x, axes: Sequence[str | None], rules=None):
    """The sharding constraint by logical axis names.

    Without an active mesh it returns ``x``.  With one it resolves the
    axes (raising for an unknown name, as :func:`logical_to_mesh_axes`
    does) and returns ``x`` unchanged.  The port has no partitioner to
    hand the constraint to: its partitioned paths lay their activations
    out by hand (``train.loop``'s and ``models.partitioned``'s rows,
    ``models.partitioned``'s decode under ``DECODE_RULES``), so a
    constraint never moves or changes a value.
    """
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, ctx_rules = ctx
    _divisible(x.shape, logical_to_mesh_axes(axes, rules or ctx_rules, mesh),
               mesh)
    return x
