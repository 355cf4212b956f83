"""``flash_attention`` under the JAX package's signature
(``repro.kernels.flash_attention.ops.flash_attention``): q [B,Sq,H,D],
k/v [B,Skv,K,D] with K dividing H, scale 1/sqrt(D).

The route follows the tensor's device: CPU tensors go to the plain
version (``ref.flash_attention_ref``: K/V repeated to H heads, as the JAX
wrapper repeats them), CUDA tensors launch the kernel (``kernel``), which
reads the shared KV head in place, or raise.  Meta tensors (the dry
run's shapes, which hold no data) take the plain version too, counted
by ``repro_torch.memory`` as the CUDA route allocates: its inputs'
contiguous copies where it makes them, and the kernel's output.  ``block_q`` / ``block_k``
are the TPU kernel's tiling; the CUDA kernel's tiles are fixed (64 x 64)
and mask ragged lengths themselves, so both are accepted and unused.

Neither route has a backward (the JAX kernel has none either), so with
grad mode on an input that requires grad is refused on every device: no
kernel output can enter an autograd graph.  The models' training route
takes the plain attention branches (``attention_core(kernel=False)``).
"""
from __future__ import annotations

import torch

from repro_torch import memory

from . import kernel
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q [B,Sq,H,D]; k/v [B,Skv,K,D] -> [B,Sq,H,D] in q's dtype, fp32
    math."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: an input requires grad; "
            "train through attention_core(kernel=False)")
    dev = q.device.type
    if dev == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if dev == "meta":
        # the CUDA route's inputs as it takes them, then its output
        return memory.as_kernel(flash_attention_ref, q.contiguous(),
                                k.contiguous(), v.contiguous(), causal=causal)
    if dev == "cuda":
        return kernel.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    raise ValueError(f"no flash_attention route for device {dev!r}")
