"""Plain PyTorch version of the three conv-dataflow kernels.

Layout: x [N, H, W, Cin], w [KH, KW, Cin, Cout], VALID padding, stride s.
Output [N, Ho, Wo, Cout] with Ho = (H - KH) // s + 1: the stride-1 VALID
convolution subsampled by ``[::s]`` (each output is computed directly, in
the same tap order).  One ``[N*Ho*Wo, Cin] @ [Cin, Cout]`` product per
tap, accumulated in fp32; the output is cast to ``x.dtype``, as the JAX
package's ``conv2d_ref``.  ``ops`` sends CPU tensors here;
``chip_smoke.py`` holds the CUDA kernels against it on the card.
"""
from __future__ import annotations

import torch


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1
               ) -> torch.Tensor:
    n, h, wd, cin = x.shape
    kh, kw, cin2, cout = w.shape
    if cin != cin2:
        raise ValueError(f"x has {cin} channels, w expects {cin2}")
    ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
    out = torch.zeros(n * ho * wo, cout, dtype=torch.float32,
                      device=x.device)
    xf, wf = x.float(), w.float()
    for di in range(kh):
        for dj in range(kw):
            patch = xf[:, di: di + (ho - 1) * stride + 1: stride,
                       dj: dj + (wo - 1) * stride + 1: stride, :]
            out += patch.reshape(-1, cin) @ wf[di, dj]
    return out.reshape(n, ho, wo, cout).to(x.dtype)
