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
``shape``).  ``named_sharding`` has no counterpart: torch has no sharded
array type to attach a spec to.

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
from typing import Any, Sequence

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
    shards the production meshes' specs over."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs one "
                             f"axis name a dimension, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(shape, names) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(names))


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
    does) and returns ``x`` unchanged: the port has no partitioner, every
    rank holds the whole value, and a constraint never changes values.
    """
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, ctx_rules = ctx
    _divisible(x.shape, logical_to_mesh_axes(axes, rules or ctx_rules, mesh),
               mesh)
    return x
