"""Top-k routed MoE with capacity-bounded scatter dispatch, the port of
``repro.models.moe`` (its GSPMD path, ``moe_apply_gspmd``).

Routing follows the JAX package step by step: router logits in the
compute dtype, an fp32 softmax, the top k (ties to the lower expert
index, as ``jax.lax.top_k``: a stable descending sort), the gates
renormalised, the Switch aux loss from the top-1 one-hot.  Each (token,
choice) takes the next of its expert's ``cap`` slots in token order (a
stable sort: first tokens win); a choice past its expert's capacity goes
to a dump row, which is dropped, and its token's residual passes through
unchanged.  The expert products are batched matrix products
(``torch.bmm``), as the reference computes them outside any kernel.

``moe_impl="shard_map"`` takes this path too: the reference takes it
whenever no mesh with a "model" axis is active, and the port has no such
mesh yet.  The expert-parallel ``moe_apply_shard_map`` and its
``_pack_by_bucket`` wait for the mesh (ROADMAP item 14.6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int | None = None,
             dtype=torch.float32) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(n=n, dtype=dtype)
    p = {
        "router": L.dense_init(gen, (d, e), fan_in=d, **kw),
        "wi_gate": L.dense_init(gen, (e, d, f), fan_in=d, **kw),
        "wi_up": L.dense_init(gen, (e, d, f), fan_in=d, **kw),
        "wo": L.dense_init(gen, (e, f, d), fan_in=f, **kw),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, d, f * cfg.num_shared_experts, **kw)
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.num_experts_per_token * cfg.moe_capacity_factor
            / cfg.num_experts)
    # round up to a lane-friendly multiple
    return max(8, -(-c // 8) * 8)


def _route(p: dict, cfg: ModelConfig, xf: torch.Tensor):
    """xf [N, D] -> (router logits [N, E] fp32, probs [N, E], gates [N, k]
    renormalised, expert ids [N, k] in descending probability, ties to
    the lower id)."""
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.num_experts_per_token
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    return logits, probs, gate_vals, expert_idx


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar fp32)."""
    return moe_apply_gspmd(p, cfg, x)


def moe_apply_gspmd(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar fp32)."""
    dt = x.dtype
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_token
    cap = _capacity(cfg, n)
    dev = x.device

    xf = x.reshape(n, d)
    _, probs, gate_vals, expert_idx = _route(p, cfg, xf)

    # ---- load-balancing aux loss (Switch eq. 4) ----
    me = probs.mean(dim=0)
    fe = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    aux_loss = cfg.router_aux_loss_coef * e * (me * fe).sum()

    # ---- slot of each (token, choice) in its expert, first tokens win ----
    flat_e = expert_idx.reshape(n * k)    # all k choices of token 0 first
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n * k, device=dev) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)  # dump row

    # ---- dispatch into [E*C (+1 dump), D]; only the dump row repeats ----
    buf = torch.zeros(e * cap + 1, d, dtype=dt, device=dev)
    buf[slot] = xf.repeat_interleave(k, dim=0)
    buf = buf[: e * cap].view(e, cap, d)

    # ---- expert FFN (SwiGLU) ----
    gate = torch.bmm(buf, p["wi_gate"].to(dt))
    up = torch.bmm(buf, p["wi_up"].to(dt))
    y = torch.bmm(F.silu(gate) * up, p["wo"].to(dt))

    # ---- combine: gather back, weight, sum over the k choices ----
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros(1, d)])
    w = (gate_vals.reshape(n * k, 1) * keep[:, None]).to(dt)
    out = (y_flat[slot] * w).reshape(n, k, d).sum(dim=1)

    if cfg.num_shared_experts:
        out = out + L.mlp_apply(p["shared"], x).reshape(n, d)
    return out.reshape(b, s, d), aux_loss
