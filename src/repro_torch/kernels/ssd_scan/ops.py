"""``ssd_scan`` under the JAX package's signature
(``repro.kernels.ssd_scan.ops.ssd_scan``): u [B,S,H,P], a [B,S,H],
Bm/Cm [B,S,N] shared over heads -> (y [B,S,H,P], final state [B,H,N,P]).

The route follows the tensor's device: CPU tensors go to the plain
chunked scan (``ref.ssd_scan_ref``), CUDA tensors launch the kernel
(``kernel``) or raise; meta tensors (the dry run's shapes, which hold
no data) take the plain scan, counted by ``repro_torch.memory`` as the
CUDA route allocates: its inputs' copies where it makes them, the
kernel's two outputs and its workspace (:func:`workspace_floats`).  Either takes any S: a ragged last chunk is
padded (plain) or masked (kernel) with rows that leave the state as it
is.

Neither route has a backward (the JAX kernel has none either), so with
grad mode on an input that requires grad is refused on every device: no
kernel output can enter an autograd graph.  The models' training route
takes the plain chunked scan (``mamba_apply(kernel=False)``).
"""
from __future__ import annotations

import torch

from repro_torch import memory

from . import kernel
from .ref import ssd_scan_ref

TILE = 64      # rows of a query or key tile (csrc/ssd_scan.cu's T)


def workspace_floats(b: int, s: int, h: int, p: int, n: int,
                     chunk: int) -> int:
    """fp32 words of workspace a launch at this shape needs: the
    arithmetic of ``csrc/ssd_scan.cu``'s ``workspace_floats`` (which
    ``kernel.workspace_floats`` asks the built library for)."""
    if min(b, s, h, p, n, chunk) < 1:
        return 0
    q = min(chunk, s)
    nc = -(-s // q)
    qp = -(-q // TILE) * TILE
    p8 = -(-p // 8) * 8
    bhc = b * h * nc

    def r4(x):
        return -(-x // 4) * 4
    return r4(bhc * qp) + r4(bhc * n * p) + r4(bhc * n * p8)


def ssd_scan(u: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128):
    """u [B,S,H,P]; a [B,S,H] (any float dtype, used in fp32); Bm/Cm
    [B,S,N].  Returns (y [B,S,H,P] in u's dtype, state [B,H,N,P] fp32)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, a, Bm, Cm)):
        raise RuntimeError(
            "ssd_scan has no backward: an input requires grad; train "
            "through mamba_apply(kernel=False)")
    dev = u.device.type
    if dev == "cpu":
        return ssd_scan_ref(u, a, Bm, Cm, chunk=chunk)
    if dev == "meta":
        # the CUDA route's inputs as it takes them, then its outputs and
        # workspace
        b, s, h, p = u.shape
        return memory.as_kernel(
            ssd_scan_ref, u.contiguous(), a.float().contiguous(),
            Bm.contiguous(), Cm.contiguous(), chunk=chunk,
            workspace_bytes=4 * workspace_floats(b, s, h, p, Bm.shape[-1],
                                                 chunk))
    if dev == "cuda":
        return kernel.ssd_scan_cuda(
            u.contiguous(), a.float().contiguous(), Bm.contiguous(),
            Cm.contiguous(), chunk=chunk)
    raise ValueError(f"no ssd_scan route for device {dev!r}")
