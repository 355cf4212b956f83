"""Plain PyTorch versions of the SSD scan kernel.

``ssd_scan_ref`` is the chunked scan on the CUDA kernel's interface
(u [B,S,H,P], a [B,S,H], B/C [B,S,N] shared by the heads of a batch
row): the JAX model's ``ssd_chunked`` arithmetic (intra-chunk
``(C Bᵀ ∘ L) u``, chunk summary states, the state carried over chunks,
off-diagonal ``(C ∘ e^{a_cum}) S_prev``), padding a ragged last chunk
with zero rows.  ``ops`` sends CPU tensors there and ``chip_smoke.py``
holds the CUDA kernel against it on the card.

``ssd_ref`` is the token recurrence, a copy of the JAX package's oracle:

    h_t = exp(a_t) * h_{t-1} + B_t (outer) u_t
    y_t = C_t . h_t
"""
from __future__ import annotations

import torch


def segsum_exp(a_cum: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = exp(a_cum[..., i] - a_cum[..., j]) masked to i >= j
    (the JAX model's ``_segsum_exp``).  a_cum: [..., Q] -> [..., Q, Q].

    The mask goes on before the exponential (exp(-inf) = 0): the same
    values as the JAX function, which exponentiates every entry and
    masks after, but where a chunk decays by more than e^88 its masked
    entries overflow to inf there, and the backward's 0 * inf makes every
    gradient NaN; here they stay finite."""
    q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    lower = torch.ones(q, q, dtype=torch.bool, device=a_cum.device).tril()
    return torch.exp(torch.where(lower, diff,
                                 torch.full_like(diff, -torch.inf)))


def ssd_scan_ref(u: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, *, chunk: int,
                 init_state: torch.Tensor | None = None):
    """u [B,S,H,P]; a [B,S,H]; Bm/Cm [B,S,N] shared by the heads;
    init_state [B,H,N,P] starts the carry (zeros when None).  Returns
    (y [B,S,H,P] in u's dtype, final state [B,H,N,P] fp32)."""
    bb, s, h, p = u.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    uf = torch.nn.functional.pad(u.float(), (0, 0, 0, 0, 0, pad))
    af = torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    uf = uf.reshape(bb, nc, q, h, p).permute(0, 3, 1, 2, 4)     # [b,h,c,q,p]
    af = af.reshape(bb, nc, q, h).permute(0, 3, 1, 2)          # [b,h,c,q]
    Bf = Bf.reshape(bb, nc, q, n)
    Cf = Cf.reshape(bb, nc, q, n)

    a_cum = af.cumsum(dim=-1)                                  # [b,h,c,q]
    # intra-chunk (diagonal blocks)
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)           # [b,c,q,q]
    L = segsum_exp(a_cum)                                      # [b,h,c,q,q]
    y_diag = torch.einsum("bcij,bhcij,bhcjp->bhcip", scores, L, uf)
    # chunk summary states and the carry over chunks
    decay_end = torch.exp(a_cum[..., -1:] - a_cum)             # [b,h,c,q]
    s_chunk = torch.einsum("bcjn,bhcj,bhcjp->bhcnp", Bf, decay_end, uf)
    chunk_decay = torch.exp(a_cum[..., -1])                    # [b,h,c]
    state = (torch.zeros(bb, h, n, p, device=u.device)
             if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = s_chunk[:, :, c] + chunk_decay[:, :, c, None, None] * state
    s_prev = torch.stack(prevs, dim=2)                         # [b,h,c,n,p]
    # off-diagonal contribution
    y_off = torch.einsum("bcin,bhci,bhcnp->bhcip", Cf, torch.exp(a_cum),
                         s_prev)
    y = (y_diag + y_off).reshape(bb, h, nc * q, p)[:, :, :s]
    return y.transpose(1, 2).to(u.dtype), state


def ssd_ref(u: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor):
    """u [G,S,P]; a [G,S]; Bm/Cm [G,S,N] (pre-broadcast to G).

    Returns (y [G,S,P] in u's dtype, final state [G,N,P] fp32).
    """
    g, s, p = u.shape
    n = Bm.shape[-1]
    h = torch.zeros(g, n, p, device=u.device)
    ys = []
    for t in range(s):
        h = torch.exp(a[:, t].float())[:, None, None] * h + torch.einsum(
            "gn,gp->gnp", Bm[:, t].float(), u[:, t].float())
        ys.append(torch.einsum("gn,gnp->gp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(u.dtype), h
