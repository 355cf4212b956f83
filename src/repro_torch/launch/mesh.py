"""Mesh construction, the port of the JAX package's ``launch/mesh.py``.

``make_production_mesh`` is the dry run's abstract (16, 16) ``("data",
"model")`` mesh, or (2, 16, 16) ``("pod", "data", "model")`` with
``multi_pod``: axis names and sizes, no processes (the JAX package
forces 256 / 512 host devices for it).  ``make_test_mesh`` is a real
``DeviceMesh`` of that shape over the world's processes, on a gloo
group: on ``"cpu"`` for the tests, and on ``"cuda"`` for processes that
share a card and keep a partitioned state there (``sharding.place``
keeps each shard on the mesh's device type; gloo carries the
collectives through host memory).

``make_platform_mesh(1, device)`` is the 1-D ``("routes",)`` mesh of
pure data parallelism over route lanes; ``make_platform_mesh(S,
device)`` with ``S > 1`` is the 2-D ``("stages", "routes")`` mesh of the
stage pipeline (``core/pipeline.py`` ``make_sharded_pipeline_fn``): one
row of ranks a stage group, the route axis taking the rest.

    torchrun --nproc_per_node 4 ...   # make_platform_mesh(2, "cuda"): 2 x 2

NCCL takes one rank a card; processes that share a card build the mesh
on ``"cpu"`` (gloo) and compute on the card (``repro_torch.distributed``).
"""
from __future__ import annotations

import math
import os

import torch.distributed as dist

from repro_torch import distributed as pdist
from repro_torch.sharding.partition import abstract_mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_platform_mesh(n_stages: int = 1, device="cuda",
                       size: int | None = None):
    """The mesh of ``size`` processes (default: the whole world, joining
    the process group first): 1-D ``("routes",)`` for ``n_stages <= 1``,
    else ``(n_stages, size // n_stages)`` named ``("stages",
    "routes")``.  The stage axis must equal the ``StagePlan``'s stage
    count; a world that does not split into ``n_stages`` groups raises
    ``RuntimeError``."""
    pdist.init_process_group(device)
    n = dist.get_world_size() if size is None else size
    if n_stages <= 1:
        return pdist.make_mesh(device, n)
    if n % n_stages:
        raise RuntimeError(
            f"{n} process(es) not divisible into {n_stages} stage groups; "
            f"start a world of k*{n_stages} processes (torchrun "
            f"--nproc_per_node)")
    return pdist.make_mesh(device, shape=(n_stages, n // n_stages),
                           axes=("stages", pdist.AXIS))


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device="cpu"):
    """A ``DeviceMesh`` on ``device``'s type (``"cpu"`` by default) of
    ``shape`` named ``axes`` over the world's processes, joining a gloo
    process group first; a world of fewer processes than the mesh raises
    ``RuntimeError``.  Processes that share a card pass ``"cuda"``: their
    partitioned state stays on the card, and gloo carries it through
    host memory (NCCL refuses two ranks on one GPU)."""
    n = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world < n:
        raise RuntimeError(
            f"need {n} processes, the world has {world}; start them with "
            f"torchrun --nproc_per_node {n}")
    pdist.init_process_group("cpu")      # gloo, whatever the mesh's device
    return pdist.make_mesh(device, shape=tuple(shape), axes=tuple(axes))
