"""Mamba-2 (SSD — state-space duality) blocks, the port of
``repro.models.ssm``.

Prefill runs the chunked SSD scan through the SSD kernel
(``kernels.ssd_scan.ops.ssd_scan``: the hand-written kernel on a CUDA
tensor, its plain chunked version on a CPU tensor); single-token decode
is the O(1)-state recurrence in plain tensor code, as in the JAX package.
``mamba_apply(kernel=False)`` runs the plain ``ssd_chunked`` instead, as
the JAX model does: the training route, since the kernel has no backward
and its op refuses inputs that require grad.

State per layer: conv ring buffer [B, W-1, d_conv] + SSD state
[B, H, P, N] fp32.  The scan returns its state as [B, H, N, P] (the
kernel's layout); ``mamba_apply`` hands it on transposed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class SSMState(NamedTuple):
    conv: torch.Tensor  # [B, W-1, d_inner + 2*N]
    ssd: torch.Tensor   # [B, H, P, N] fp32


def init_mamba(gen: torch.Generator, cfg: ModelConfig, n: int | None = None,
               dtype=torch.float32) -> dict:
    d, di, ns, h = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_heads
    w = cfg.ssm_conv_width
    dev = gen.device
    lead = () if n is None else (n,)
    pdt = L.torch_dtype(dtype)
    # dt bias: softplus^{-1}(0.01), the middle of dt ~ U[1e-3, 1e-1]
    dt_init = math.log(math.expm1(0.01))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    dense = dict(n=n, dtype=pdt)
    return {
        "wz": L.dense_init(gen, (d, di), ("embed", "mlp"), fan_in=d, **dense),
        "wx": L.dense_init(gen, (d, di), ("embed", "mlp"), fan_in=d, **dense),
        "wB": L.dense_init(gen, (d, ns), ("embed", "ssm_state"), fan_in=d,
                           **dense),
        "wC": L.dense_init(gen, (d, ns), ("embed", "ssm_state"), fan_in=d,
                           **dense),
        "wdt": L.dense_init(gen, (d, h), ("embed", "ssm_heads"), fan_in=d,
                            **dense),
        "conv_w": L.dense_init(gen, (w, di + 2 * ns), ("conv_kernel", "mlp"),
                               fan_in=w, scale=1.0, **dense),
        "conv_b": L.zeros_init((di + 2 * ns,), ("mlp",), dev, **dense),
        "A_log": L.const_init(a_log, ("ssm_heads",), **dense),
        "dt_bias": L.const_init(torch.full((h,), dt_init, device=dev),
                                ("ssm_heads",), **dense),
        "D": L.ones_init((h,), ("ssm_heads",), dev, **dense),
        "norm": L.ones_init((di,), ("mlp",), dev, **dense),
        "wo": L.dense_init(gen, (di, d), ("mlp", "embed"), fan_in=di,
                           **dense),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. xbc [B, S, C]; w [W, C]."""
    width = w.shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    s = xbc.shape[1]
    out = torch.zeros_like(xbc) + b.to(xbc.dtype)
    for i in range(width):
        out = out + padded[:, i: i + s, :] * w[i].to(xbc.dtype)
    return F.silu(out)


def ssd_chunked(u: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """Chunked SSD scan in plain tensor code (any device).

    u  [B, S, H, P]   discretized inputs (x * dt)
    a  [B, S, H]      log-decay per step (dt * A, negative)
    Bm [B, S, N], Cm [B, S, N]  input/output projections (shared over heads)
    init_state [B, H, P, N] or None

    Returns y [B, S, H, P] and final state [B, H, P, N].
    """
    init = None if init_state is None else init_state.transpose(-1, -2)
    y, state = ssd_scan_ref(u, a, Bm, Cm, chunk=chunk, init_state=init)
    return y, state.transpose(-1, -2)


def ssd_discretize(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor):
    """The SSD's discretisation, fp32: (dt = softplus(dt_raw + dt_bias),
    the log-decay dt * A with A = -exp(A_log)), both [..., H]."""
    dt = F.softplus(dt_raw.float() + dt_bias.float())
    return dt, dt * -torch.exp(A_log.float())


def conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """The causal conv's output for the last position of ``window``
    [B, W, C] (depthwise weights ``w`` [W, C], bias [C]) -> [B, C]."""
    dt = window.dtype
    return F.silu(torch.einsum("bwc,wc->bc", window, w.to(dt)) + b.to(dt))


def ssd_step(state: torch.Tensor, xs: torch.Tensor, dt: torch.Tensor,
             decay: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             D: torch.Tensor):
    """One step of the SSD recurrence: state [B,H,P,N], xs [B,H,P], dt
    and decay [B,H] fp32, Bm / Cm [B,N], D [H] -> (y [B,H,P] in xs's
    dtype with the D skip, the new state fp32)."""
    u = (xs * dt[..., None].to(xs.dtype)).float()
    s_new = (decay[:, :, None, None] * state.float()
             + torch.einsum("bhp,bn->bhpn", u, Bm.float()))
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), s_new)
    return y.to(xs.dtype) + xs * D.to(xs.dtype)[None, :, None], s_new


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False, kernel: bool = True):
    """x [B,S,E] -> [B,S,E] (+ final SSMState for prefill->decode handoff)."""
    dt_ = x.dtype
    b, s, _ = x.shape
    di, n, h, pdim = (cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_heads,
                      cfg.ssm_head_dim)

    z = x @ p["wz"].to(dt_)
    xs = x @ p["wx"].to(dt_)
    Bm = x @ p["wB"].to(dt_)
    Cm = x @ p["wC"].to(dt_)
    dt_raw = x @ p["wdt"].to(dt_)

    xbc_pre = torch.cat([xs, Bm, Cm], dim=-1)   # conv INPUT (cached)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = xbc[..., :di], xbc[..., di: di + n], xbc[..., di + n:]

    dt, a = ssd_discretize(dt_raw, p["dt_bias"], p["A_log"])  # [B,S,H]
    u = xs.reshape(b, s, h, pdim) * dt[..., None].to(dt_)

    if kernel:
        y, s_final = ssd_scan(u, a, Bm, Cm, chunk=cfg.ssm_chunk)
        s_final = s_final.transpose(-1, -2)
    else:
        y, s_final = ssd_chunked(u, a, Bm, Cm, cfg.ssm_chunk)
    y = y + xs.reshape(b, s, h, pdim) * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["wo"].to(dt_)
    if return_state:
        width = cfg.ssm_conv_width
        if s >= width - 1:
            conv_hist = xbc_pre[:, s - (width - 1):, :]
        else:
            conv_hist = F.pad(xbc_pre, (0, 0, width - 1 - s, 0))
        return out, SSMState(conv=conv_hist, ssd=s_final)
    return out


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: SSMState):
    """Single-token decode. x [B,1,E]; returns (y [B,1,E], new state)."""
    dt_ = x.dtype
    b = x.shape[0]
    di, n, h, pdim = (cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_heads,
                      cfg.ssm_head_dim)

    z = x @ p["wz"].to(dt_)
    xs = x @ p["wx"].to(dt_)
    Bm = x @ p["wB"].to(dt_)
    Cm = x @ p["wC"].to(dt_)
    dt_raw = x @ p["wdt"].to(dt_)

    xbc_new = torch.cat([xs, Bm, Cm], dim=-1)                     # [B,1,C]
    window = torch.cat([state.conv.to(dt_), xbc_new], dim=1)      # [B,W,C]
    conv_out = conv_step(window, p["conv_w"], p["conv_b"])[:, None, :]
    new_conv = window[:, 1:, :]

    xs, Bm, Cm = (conv_out[..., :di], conv_out[..., di: di + n],
                  conv_out[..., di + n:])
    dt, a = ssd_discretize(dt_raw[:, 0], p["dt_bias"], p["A_log"])  # [B,H]
    y, s_new = ssd_step(state.ssd, xs.reshape(b, h, pdim), dt, torch.exp(a),
                        Bm[:, 0], Cm[:, 0], p["D"])
    y = y.reshape(b, 1, di)
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["wo"].to(dt_)
    return out, SSMState(conv=new_conv, ssd=s_new)
