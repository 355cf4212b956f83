"""``ssd_scan`` under the JAX package's signature
(``repro.kernels.ssd_scan.ops.ssd_scan``): u [B,S,H,P], a [B,S,H],
Bm/Cm [B,S,N] shared over heads -> (y [B,S,H,P], final state [B,H,N,P]).

The route follows the tensor's device: CPU tensors go to the plain
chunked scan (``ref.ssd_scan_ref``), CUDA tensors launch the kernel
(``kernel``) or raise; meta tensors (the dry run's shapes, which hold
no data) take the plain scan.  Either takes any S: a ragged last chunk is
padded (plain) or masked (kernel) with rows that leave the state as it
is.

Neither route has a backward (the JAX kernel has none either), so with
grad mode on an input that requires grad is refused on every device: no
kernel output can enter an autograd graph.  The models' training route
takes the plain chunked scan (``mamba_apply(kernel=False)``).
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import ssd_scan_ref


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
    if dev in ("cpu", "meta"):
        return ssd_scan_ref(u, a, Bm, Cm, chunk=chunk)
    if dev == "cuda":
        return kernel.ssd_scan_cuda(
            u.contiguous(), a.float().contiguous(), Bm.contiguous(),
            Cm.contiguous(), chunk=chunk)
    raise ValueError(f"no ssd_scan route for device {dev!r}")
