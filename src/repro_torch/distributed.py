"""The sharding seam of the port: a 1-D device mesh over processes and
the collectives the sharded engines need (the counterpart of the JAX
package's ``compat.make_mesh`` and its ``shard_map`` axis).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one axis,
``("routes",)``: NCCL on the card, gloo on the CPU.  Each rank runs its
contiguous block of routes or lanes, and ``all_gather`` gives every rank
the global result back, as ``shard_map``'s ``out_specs=P(axis)`` does.

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --flexai \\
        --dp --shard --td-kernel

Under ``torchrun`` the process group comes from its environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); without it
:func:`init_process_group` starts a world of one on a free local port.
A group that fails to start raises.
"""
from __future__ import annotations

import os
import socket

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


def make_mesh(device, size: int | None = None, axis: str = AXIS):
    """A 1-D mesh named ``(axis,)`` over ``size`` processes (default:
    the whole world), joining the process group first."""
    from torch.distributed.device_mesh import init_device_mesh
    device = torch.device(device)
    init_process_group(device)
    size = dist.get_world_size() if size is None else size
    return init_device_mesh(device.type, (size,), mesh_dim_names=(axis,))


def mesh_size(mesh) -> int:
    return mesh.size()


def mesh_rank(mesh) -> int:
    return mesh.get_local_rank()


def local_block(mesh, total: int, what: str = "lanes") -> slice:
    """This rank's contiguous block of ``total`` routes or lanes, which
    must split evenly over the mesh (``tasks.pad_route_batch``)."""
    n = mesh_size(mesh)
    if total < 1 or total % n:
        raise ValueError(f"{what}={total} must be a positive multiple of "
                         f"the mesh size {n}")
    k = total // n
    r = mesh_rank(mesh)
    return slice(r * k, (r + 1) * k)


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return out


def pmin(x: torch.Tensor, mesh) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=mesh.get_group())
    return out


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over ranks: the sum, divided by the mesh size."""
    return psum(x, mesh) / mesh_size(mesh)


def all_gather(x, mesh):
    """Every rank's ``x`` (a tensor, a NumPy array, or a NamedTuple of
    them; None passes through) concatenated along the leading axis in
    rank order."""
    import numpy as np
    if x is None:
        return None
    if isinstance(x, tuple):
        parts = [all_gather(f, mesh) for f in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    if isinstance(x, np.ndarray):   # through the mesh's device (NCCL)
        t = torch.from_numpy(x).to(mesh.device_type)
        return all_gather(t, mesh).cpu().numpy()
    is_bool = x.dtype == torch.bool
    t = x.to(torch.uint8) if is_bool else x
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh_size(mesh))]
    dist.all_gather(parts, t, group=mesh.get_group())
    out = torch.cat(parts)
    return out.bool() if is_bool else out
