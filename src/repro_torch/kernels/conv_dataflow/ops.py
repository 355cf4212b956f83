"""``conv2d`` through one of the paper's accelerator dataflows, under the
JAX package's signature (``repro.kernels.conv_dataflow.ops.conv2d``).

``padding="SAME"`` keeps that wrapper's own semantics: pad ``(k-1)//2``
before and ``k-1-(k-1)//2`` after, convolve at stride 1, subsample by
``[::stride]``.  For stride > 1 and even H that is *not* XLA's SAME (the
perception CNNs pad XLA's way themselves and call ``padding="VALID"``).
The kernels take the stride natively and skip the subsampled-away
outputs; the result is the same.

The route follows the tensor's device: CPU tensors go to the plain
version (``ref``), CUDA tensors launch the dataflow's kernel (``kernel``)
or raise.  ``dataflow="ref"`` asks for the plain version on any device,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel
from .kernel import DATAFLOWS
from .ref import conv2d_ref


def conv2d(x: torch.Tensor, w: torch.Tensor, *, dataflow: str = "MconvMC",
           stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """x [N,H,W,Cin], w [KH,KW,Cin,Cout] -> [N,Ho,Wo,Cout] in x's dtype,
    accumulated in fp32."""
    if dataflow not in DATAFLOWS + ("ref",):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        x = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    if dataflow == "ref":
        return conv2d_ref(x, w, stride)
    dev = x.device.type
    if dev == "cpu":
        return conv2d_ref(x, w, stride)
    if dev == "cuda":
        return kernel.conv2d_cuda(x.contiguous(), w.contiguous(),
                                  dataflow=dataflow, stride=stride)
    raise ValueError(f"no conv2d route for device {dev!r}")
