"""The sharding seam of the port: a device mesh over processes and the
collectives the sharded engines need (the counterpart of the JAX
package's ``compat.make_mesh``, its ``shard_map`` axes and
``lax.ppermute``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``: NCCL on the
card, gloo on the CPU.  The 1-D mesh ``("routes",)`` splits routes or
lanes; the 2-D mesh ``("stages", "routes")`` (``launch/mesh.py``
``make_platform_mesh``) also places each pipeline stage group on its own
row of ranks, numbered stage-major as ``init_device_mesh`` numbers them.
Each rank runs its contiguous block of routes or lanes along one axis,
the route axis by default (a mesh's last axis), and ``all_gather`` gives
every rank of that axis the whole result back, as ``shard_map``'s
``out_specs=P(axis)`` does.  :func:`ring_hop` moves a stage's [R_local]
finish row to the next stage of the same route block after every
wavefront column.

Collectives carry tensors on the mesh's wire (:func:`wire`): host
memory for a gloo group, since gloo's ops take CPU tensors, else the
mesh's own device type.  So a gloo mesh carries the tensors of
processes that compute on the card through host memory, whether the
mesh is on ``"cpu"`` or on ``"cuda"`` (a ``"cuda"`` mesh over gloo keeps
a ``DTensor``'s shards on the card, ``sharding.place``).  That is the
transport for several processes that share one card, where NCCL refuses
two ranks on one GPU.  Within :func:`count_wire` every collective adds
its payload to the yielded counts.

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --flexai \\
        --dp --shard --td-kernel

Under ``torchrun`` the process group comes from its environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); without it
:func:`init_process_group` starts a world of one on a free local port.
A group that fails to start raises.

The expert-parallel MoE (``models/moe.py`` ``moe_apply_shard_map``)
uses three differentiable collectives, written as autograd functions
in the style of Megatron's tensor parallelism, so that every rank of a
replicated loss gets the single-process gradient of every leaf with no
reduction at the step: :func:`grad_psum` (identity forward, the
gradient summed over the given axes backward) on a replicated input a
rank uses only in part, :func:`all_to_all` (the tiled exchange along
one axis; its backward is the reverse exchange) and
:func:`gather_blocks` (every rank's block concatenated in block order;
backward: the rank's own block of the gradient).

Every helper also runs shape-only on an abstract mesh
(``sharding.AbstractMesh``: axis names and sizes, no processes; its
``coordinate`` says which rank the caller stands for, rank 0 by
default): it returns a tensor of the output's shape on the input's
device (meta in the dry run) and records what the collective would
move, so the dry run reads a rank's collectives with no process group.
Within :func:`count_wire` both kinds add each collective to ``ops``
under the JAX dry run's op names (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``): its count,
the bytes of its operand and of its output.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

AXIS = "routes"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device) -> None:
    """Join the process group (NCCL for a CUDA ``device``, gloo for the
    CPU) unless this process is in one already."""
    device = torch.device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)


def make_mesh(device, size: int | None = None, axis: str = AXIS, *,
              shape: tuple | None = None, axes: tuple | None = None):
    """A 1-D mesh named ``(axis,)`` over ``size`` processes (default:
    the whole world), or with ``shape`` and ``axes`` a mesh of that shape
    and those names (``(S, R)``, ``("stages", "routes")``), joining the
    process group first."""
    from torch.distributed.device_mesh import init_device_mesh
    device = torch.device(device)
    init_process_group(device)
    if shape is None:
        shape = (dist.get_world_size() if size is None else size,)
        axes = (axis,)
    elif axes is None or len(axes) != len(shape):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs one axis "
                         f"name a dimension, got {axes}")
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def is_abstract(mesh) -> bool:
    """Whether ``mesh`` is an abstract mesh (no processes behind it)."""
    return not hasattr(mesh, "get_group")


def _names(mesh) -> tuple:
    return tuple(mesh.axis_names if is_abstract(mesh)
                 else mesh.mesh_dim_names)


def _axis(mesh, axis: str | None) -> str:
    """``axis``, or the mesh's last axis (its route axis) for None."""
    names = _names(mesh)
    axis = names[-1] if axis is None else axis
    if axis not in names:
        raise ValueError(f"the mesh has axes {names}, not {axis!r}")
    return axis


def mesh_size(mesh, axis: str | None = None) -> int:
    """The number of ranks along ``axis`` (default: the route axis)."""
    axis = _axis(mesh, axis)
    if is_abstract(mesh):
        return mesh.shape[axis]
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_rank(mesh, axis: str | None = None) -> int:
    """This rank's index along ``axis`` (default: the route axis); on an
    abstract mesh, its ``coordinate``'s."""
    axis = _axis(mesh, axis)
    if is_abstract(mesh):
        return mesh.coordinate[_names(mesh).index(axis)]
    return mesh.get_local_rank(axis)


def local_block(mesh, total: int, what: str = "lanes",
                axis: str | None = None) -> slice:
    """This rank's contiguous block of ``total`` routes or lanes along
    ``axis``, which must split them evenly (``tasks.pad_route_batch``)."""
    n = mesh_size(mesh, axis)
    if total < 1 or total % n:
        raise ValueError(f"{what}={total} must be a positive multiple of "
                         f"the mesh size {n} (axis {_axis(mesh, axis)!r})")
    k = total // n
    r = mesh_rank(mesh, axis)
    return slice(r * k, (r + 1) * k)


def wire(mesh) -> str:
    """The device type ``mesh``'s collectives carry tensors on: ``"cpu"``
    for a gloo group, else the mesh's device type."""
    if dist.get_backend(mesh.get_group(0)) == "gloo":
        return "cpu"
    return mesh.device_type


_WIRE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_wire", default=None)


@contextlib.contextmanager
def count_wire():
    """Within the block, add to the yielded ``{"collectives", "bytes",
    "host_copies", "ops"}`` each collective this process starts, the
    bytes of the payload it hands the process group (an all-gather's and
    a reduce-scatter's input, an all-reduce's buffer, an all-to-all's
    send buffer), the copies between a tensor's device and the wire
    (each way), and under ``ops[name]`` its ``count``,
    ``operand_bytes`` and ``output_bytes`` (shape-only collectives on an
    abstract mesh too)."""
    stats = {"collectives": 0, "bytes": 0, "host_copies": 0, "ops": {}}
    token = _WIRE.set(stats)
    try:
        yield stats
    finally:
        _WIRE.reset(token)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _record(op: str, operand: torch.Tensor, output_bytes: int) -> None:
    """Count one collective ``op`` of ``operand`` giving ``output_bytes``
    in the active :func:`count_wire`."""
    stats = _WIRE.get()
    if stats is None:
        return
    stats["collectives"] += 1
    stats["bytes"] += _nbytes(operand)
    rec = stats["ops"].setdefault(op, {"count": 0, "operand_bytes": 0,
                                       "output_bytes": 0})
    rec["count"] += 1
    rec["operand_bytes"] += _nbytes(operand)
    rec["output_bytes"] += output_bytes


def _to_wire(x: torch.Tensor, mesh, op: str, output_bytes: int,
             copy: bool = False) -> torch.Tensor:
    """``x`` on the mesh's wire, contiguous (a copy when ``copy``), its
    payload counted as one ``op``."""
    w = wire(mesh)
    _record(op, x, output_bytes)
    stats = _WIRE.get()
    if stats is not None:
        stats["host_copies"] += x.device.type != w
    return x.to(w, copy=copy).contiguous()


def _from_wire(out: torch.Tensor, device) -> torch.Tensor:
    stats = _WIRE.get()
    if stats is not None:
        stats["host_copies"] += out.device != torch.device(device)
    return out.to(device)


def _reduce(x: torch.Tensor, mesh, axis, op) -> torch.Tensor:
    if is_abstract(mesh):
        _record("all-reduce", x, _nbytes(x))
        return torch.empty_like(x)
    out = _to_wire(x, mesh, "all-reduce", _nbytes(x), copy=True)
    dist.all_reduce(out, op=op, group=mesh.get_group(_axis(mesh, axis)))
    return _from_wire(out, x.device)


def psum(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    """The mean over the ranks of ``axis``: the sum, divided by their
    number."""
    return psum(x, mesh, axis) / mesh_size(mesh, axis)


def all_gather(x, mesh, axis: str | None = None):
    """Every ``axis`` rank's ``x`` (a tensor, a NumPy array, or a
    NamedTuple of them; None passes through) concatenated along the
    leading axis in rank order, on ``x``'s device."""
    if x is None:
        return None
    if isinstance(x, tuple):
        parts = [all_gather(f, mesh, axis) for f in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    if isinstance(x, np.ndarray):
        return all_gather(torch.from_numpy(x), mesh, axis).numpy()
    is_bool = x.dtype == torch.bool
    n = mesh_size(mesh, axis)
    x8 = x.to(torch.uint8) if is_bool else x
    if is_abstract(mesh):
        _record("all-gather", x8, n * _nbytes(x8))
        return x.new_empty((n * x.shape[0], *x.shape[1:]))
    t = _to_wire(x8, mesh, "all-gather", n * _nbytes(x8))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(_axis(mesh, axis)))
    out = _from_wire(torch.cat(parts), x.device)
    return out.bool() if is_bool else out


def gather_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every ``axis`` rank's ``x`` concatenated along ``dim`` in rank
    order (the whole of a dim that ``Shard(dim)`` split over ``axis``),
    on ``x``'s device."""
    return all_gather(x.movedim(dim, 0), mesh, axis).movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """The sum of every ``axis`` rank's ``x``, cut along ``dim`` into as
    many equal blocks as ``axis`` has ranks: this rank's block, on
    ``x``'s device (``Partial`` to ``Shard(dim)``)."""
    n = mesh_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over the {n} ranks of {axis!r}")
    if is_abstract(mesh):
        _record("reduce-scatter", x, _nbytes(x) // n)
        shape = list(x.shape)
        shape[dim] //= n
        return x.new_empty(shape)
    t = _to_wire(x.movedim(dim, 0), mesh, "reduce-scatter", _nbytes(x) // n)
    out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=mesh.get_group(axis))
    return _from_wire(out, x.device).movedim(0, dim)


def mesh_barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` reaches this call: a barrier
    over each axis in turn, which every rank joins only after the one
    before, so the last one passes only when all ranks have arrived."""
    if is_abstract(mesh):
        return
    for axis in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(axis))


def ring_hop(x: torch.Tensor, mesh, axis: str = "stages",
             stats: dict | None = None) -> torch.Tensor:
    """The ring hop of ``lax.ppermute(x, axis, [(i, i + 1)])``: this
    rank's ``x`` goes to the next rank along ``axis`` (same indices on
    the other axes), and the previous rank's comes back; the first rank
    gets zeros and the last sends nothing.  Both directions are posted as
    one batch of non-blocking ops, so no pair of ranks waits on the
    other.  On a gloo mesh a card's row goes through host memory, one
    copy out and one back in; ``stats`` counts ``hops`` (calls that moved
    a row) and those ``host_copies``."""
    n, s = mesh_size(mesh, axis), mesh_rank(mesh, axis)
    if is_abstract(mesh):
        if s + 1 < n:
            _record("collective-permute", x, _nbytes(x))
        return torch.zeros_like(x)
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())

    def peer(i: int) -> int:
        coord[dim] = i
        return int(mesh.mesh[tuple(coord)])

    group = mesh.get_group(axis)
    recv = torch.zeros(x.shape, dtype=x.dtype, device=wire(mesh))
    ops = []
    if s + 1 < n:
        _record("collective-permute", x, _nbytes(x))
        send = x.to(wire(mesh)).contiguous()
        ops.append(dist.P2POp(dist.isend, send, peer(s + 1), group))
    if s > 0:
        ops.append(dist.P2POp(dist.irecv, recv, peer(s - 1), group))
    if not ops:
        return torch.zeros_like(x)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stats is not None:
        stats["hops"] = stats.get("hops", 0) + 1
        if x.device.type != wire(mesh):
            stats["host_copies"] = stats.get("host_copies", 0) + len(ops)
    return recv.to(x.device)


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for axis in axes:
        x = psum(x, mesh, axis)
    return x


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


def grad_psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the ranks of ``axes``."""
    return _GradSum.apply(x, mesh, tuple(axes))


def _exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if is_abstract(mesh):
        _record("all-to-all", x, _nbytes(x))
        return torch.empty_like(x)
    send = _to_wire(x, mesh, "all-to-all", _nbytes(x))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(_axis(mesh,
                                                                  axis)))
    return _from_wire(recv, x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: the leading dim in
    as many equal chunks as ``axis`` has ranks, chunk i to rank i, the
    received chunks concatenated in rank order."""
    if x.shape[0] % mesh_size(mesh, axis):
        raise ValueError(f"{x.shape[0]} rows do not split over the "
                         f"{mesh_size(mesh, axis)} ranks of {axis!r}")
    return _AllToAll.apply(x, mesh, axis)


def block_index(mesh, axes) -> int:
    """This rank's block of a dim split over ``axes`` (the first axis
    major), as ``P(axes)`` numbers them."""
    idx = 0
    for axis in axes:
        idx = idx * mesh_size(mesh, axis) + mesh_rank(mesh, axis)
    return idx


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, sum_grad):
        ctx.n, ctx.blk = x.shape[0], block_index(mesh, axes)
        ctx.mesh, ctx.axes, ctx.sum_grad = mesh, axes, sum_grad
        for axis in reversed(axes):
            x = all_gather(x, mesh, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = _sum_over(g, ctx.mesh, ctx.axes)
        return g[ctx.blk * ctx.n:(ctx.blk + 1) * ctx.n], None, None, None


def gather_blocks(x: torch.Tensor, mesh, axes,
                  sum_grad: bool = False) -> torch.Tensor:
    """Every rank's block ``x`` of a dim split over ``axes`` (the first
    axis major), concatenated: the whole dim on every rank.  The backward
    takes this rank's block of the gradient: of one that every rank
    holds whole, or with ``sum_grad`` of the sum over the ranks of
    ``axes`` (where each rank's loss reads every rank's rows, so each
    holds a part of every block's gradient: a reduce-scatter)."""
    return _GatherBlocks.apply(x, mesh, tuple(axes), sum_grad)
