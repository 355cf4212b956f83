"""Plain PyTorch version of the flash-attention kernel: full fp32 scores.

``attention_ref`` is the port of the JAX package's oracle: q [G, Sq, D],
k/v [G, Skv, D] -> [G, Sq, D] in q's dtype; causal means query i sees
key j for i >= j (no offset), masked scores are -1e30.
``flash_attention_ref`` is the kernel's function on its [B, S, H, D]
interface (K/V repeated to H heads, as the JAX wrapper repeats them,
scale 1/sqrt(D)).  ``ops`` sends CPU tensors here; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float) -> torch.Tensor:
    s = torch.einsum("gqd,gkd->gqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("gqk,gkd->gqd", p, v.float())
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool) -> torch.Tensor:
    """q [B,Sq,H,D]; k/v [B,Skv,K,D] with K dividing H -> [B,Sq,H,D]."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * h, skv, d)
    vf = v.transpose(1, 2).reshape(b * h, skv, d)
    of = attention_ref(qf, kf, vf, causal=causal, scale=1.0 / math.sqrt(d))
    return of.reshape(b, h, sq, d).transpose(1, 2)
