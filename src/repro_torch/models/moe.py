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

``moe_impl="shard_map"`` takes the expert-parallel path,
``moe_apply_shard_map``, exactly when the reference does: an active
mesh (``sharding.activate``) with a "model" axis whose size divides the
expert count; otherwise it takes the GSPMD path.  The expert-parallel
path runs over a ``DeviceMesh`` of processes: every rank holds the whole
activations and routes all the tokens, then takes its block of tokens
(split over ``("pod", "data", "model")``), exchanges the routed rows
with the ranks of its "model" row (``distributed.all_to_all``: the
rows, their metadata, and the expert outputs back), multiplies its own
``E / model`` experts, and gathers every block back, so every rank ends
with the whole output.  Its collectives are differentiable
(``distributed``): each rank's gradient of each leaf is the
single-process one.  The expert stacks may be whole (the rank slices
its experts) or this rank's slice already (``shard_experts``), which
then holds half of the expert bytes on each of two ranks.
:func:`count_drops` counts the choices each path drops.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch import distributed as pdist
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.partition import (AbstractMesh,
                                            current_mesh_and_rules,
                                            current_row_shard,
                                            mesh_axis_names, mesh_shape)
from repro_torch.sharding.partition import with_logical_constraint as wlc


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int | None = None,
             dtype=torch.float32) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(n=n, dtype=dtype)
    p = {
        "router": L.dense_init(gen, (d, e), ("embed", "unsharded"),
                               fan_in=d, **kw),
        "wi_gate": L.dense_init(gen, (e, d, f),
                                ("expert", "embed", "expert_mlp"), fan_in=d,
                                **kw),
        "wi_up": L.dense_init(gen, (e, d, f),
                              ("expert", "embed", "expert_mlp"), fan_in=d,
                              **kw),
        "wo": L.dense_init(gen, (e, f, d), ("expert", "expert_mlp", "embed"),
                           fan_in=f, **kw),
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


_DROPS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_drops", default=None)


@contextlib.contextmanager
def count_drops():
    """Within the block, add to the yielded ``{"dropped": n}`` the
    (token, choice) pairs each MoE call on this process drops for
    capacity (one host read a call).  On the expert-parallel path a rank
    counts the choices of its tokens that its send buffers drop and the
    received choices its expert buffers drop: the sum over the ranks is
    the call's total."""
    stats = {"dropped": 0}
    token = _DROPS.set(stats)
    try:
        yield stats
    finally:
        _DROPS.reset(token)


def _count(dropped: torch.Tensor) -> None:
    stats = _DROPS.get()
    if stats is not None:
        stats["dropped"] += int(dropped.sum())


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor,
              expert_idx: torch.Tensor) -> torch.Tensor:
    """The load-balancing aux loss (Switch eq. 4) over all tokens."""
    e = cfg.num_experts
    me = probs.mean(dim=0)
    fe = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    return cfg.router_aux_loss_coef * e * (me * fe).sum()


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar fp32).

    Inside a partitioned step whose rows split over more than one block
    (``sharding.row_shard``) it takes :func:`moe_apply_rows`.  Otherwise
    it dispatches to the expert-parallel path when ``cfg.moe_impl ==
    "shard_map"`` and an active mesh has a "model" axis whose size
    divides the expert count, and to the GSPMD path below else.
    """
    shard = current_row_shard()
    if shard is not None and shard.blocks > 1:
        return moe_apply_rows(p, cfg, x, shard)
    if cfg.moe_impl == "shard_map":
        ctx = current_mesh_and_rules()
        if ctx is not None and "model" in mesh_axis_names(ctx[0]) \
                and cfg.num_experts % mesh_shape(ctx[0])["model"] == 0:
            return moe_apply_shard_map(p, cfg, x, ctx[0])
    return moe_apply_gspmd(p, cfg, x)


def expert_ffn(buf: torch.Tensor, wi_gate: torch.Tensor,
               wi_up: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their capacity rows: buf [E, C, D] and each
    expert's weights -> [E, C, D]."""
    dt = buf.dtype
    gate = torch.bmm(buf, wi_gate.to(dt))
    up = torch.bmm(buf, wi_up.to(dt))
    return torch.bmm(F.silu(gate) * up, wo.to(dt))


def combine(y: torch.Tensor, slot: torch.Tensor, gate_vals: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """Each token's output: the expert rows ``y`` [R, D] that its k
    choices went to (``slot`` [N*k], R for a choice dropped or not held
    here), each weighted by its gate where kept, summed over the k
    choices -> [N, D]."""
    n, k = gate_vals.shape
    d = y.shape[-1]
    y_flat = torch.cat([y, y.new_zeros(1, d)])
    w = (gate_vals.reshape(n * k, 1) * keep[:, None]).to(y.dtype)
    return (y_flat[slot] * w).reshape(n, k, d).sum(dim=1)


def moe_apply_gspmd(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar fp32)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_token
    cap = _capacity(cfg, n)

    xf = x.reshape(n, d)
    _, probs, gate_vals, expert_idx = _route(p, cfg, xf)
    aux_loss = _aux_loss(cfg, probs, expert_idx)

    # ---- dispatch each (token, choice) into its expert's next slot, first
    # tokens first; a choice past capacity goes to the dump slot e * cap
    flat_e = expert_idx.reshape(n * k)    # all k choices of token 0 first
    buf, _, slot, keep = _pack_by_bucket(
        flat_e, e, cap, xf.repeat_interleave(k, dim=0),
        flat_e.new_zeros(n * k, 0))
    buf = buf.view(e, cap, d)
    _count(~keep)

    y = expert_ffn(buf, p["wi_gate"], p["wi_up"], p["wo"])
    out = combine(y.reshape(e * cap, d), slot, gate_vals, keep)

    if cfg.num_shared_experts:
        out = out + L.mlp_apply(p["shared"], x).reshape(n, d)
    return wlc(out.reshape(b, s, d), ("batch", None, None)), aux_loss


def moe_apply_rows(p: dict, cfg: ModelConfig, x: torch.Tensor, shard):
    """The layer on this rank's block ``x`` of a partitioned step's rows.

    Capacity, "first tokens win" and the aux loss are functions of every
    token of the batch, so the rows are gathered over the shard's axes
    (``distributed.gather_blocks`` with the summed backward: each rank's
    loss reads every rank's rows), the GSPMD path computes the layer on
    all of them, and the rank keeps its rows.  The aux loss is divided
    by the number of blocks, so that the ranks' losses hold it once.
    Every rank counts the drops of all tokens (``count_drops``).  The
    expert-parallel path needs the whole batch on every rank, so a
    partitioned step takes this route whatever ``cfg.moe_impl`` says."""
    b = x.shape[0]
    out, aux = moe_apply_gspmd(
        p, cfg, pdist.gather_blocks(x, shard.mesh, shard.axes,
                                    sum_grad=True))
    i = shard.index
    return out[i * b:(i + 1) * b], aux / shard.blocks


# ---------------------------------------------------------------------------
# Explicit expert parallelism (all-to-all over the "model" axis)
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def _pack_by_bucket(bucket: torch.Tensor, n_buckets: int, cap: int,
                    rows: torch.Tensor, extra: torch.Tensor):
    """Pack ``rows`` [A, D] into [n_buckets*cap, D] by bucket id (stable,
    first-come capacity).  ``extra`` [A, m] int32 rides along (dropped rows
    get sentinel -1).  Returns (packed_rows, packed_extra, slot_of_row,
    keep_mask)."""
    a = bucket.shape[0]
    dev = bucket.device
    bucket = bucket.long()
    order = torch.sort(bucket, stable=True).indices
    counts = torch.zeros(n_buckets, dtype=torch.long, device=dev
                         ).scatter_add_(0, bucket, torch.ones_like(bucket))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(a, device=dev) - starts[bucket[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, bucket * cap + pos, n_buckets * cap)
    packed = rows.new_zeros(n_buckets * cap + 1, rows.shape[1]).index_put(
        (slot,), rows)[:-1]
    pext = torch.full((n_buckets * cap + 1, extra.shape[1]), -1,
                      dtype=torch.int32, device=dev).index_put(
        (slot,), torch.where(keep[:, None], extra.to(torch.int32),
                             -1))[:-1]
    return packed, pext, slot, keep


def _token_axes(mesh) -> tuple:
    """The axes the tokens split over: ``("pod", "data")`` present in the
    mesh, then "model" (``P(batch_axes + ("model",))``)."""
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names) + ("model",)


def shard_experts(params, cfg: ModelConfig, mesh):
    """``params`` (a MoE layer's dict, or a model's tree of them, stacked
    over "layers" or not) with each expert stack cut to this rank's
    ``E / model`` experts along the "model" axis; the rest shared.  The
    expert-parallel path takes such slices as they are; the GSPMD path
    needs the whole stacks."""
    m = pdist.mesh_size(mesh, "model")
    e_loc = cfg.num_experts // m
    lo = pdist.mesh_rank(mesh, "model") * e_loc

    def cut(node):
        if not isinstance(node, dict):
            return node
        if "router" in node and all(k in node for k in EXPERT_LEAVES):
            dim = node["wi_gate"].dim() - 3      # 1 when stacked
            return {k: v.narrow(dim, lo, e_loc).clone()
                    if k in EXPERT_LEAVES else v for k, v in node.items()}
        return {k: cut(v) for k, v in node.items()}
    return cut(params)


def moe_apply_shard_map(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh):
    """Expert parallelism over ``mesh``'s "model" axis: tokens split over
    ``("pod", "data", "model")``, routed rows exchanged with the "model"
    row's ranks (three all-to-alls: rows, metadata, combine), each rank's
    ``E / model`` experts multiplied there, the blocks gathered back.
    Routing and the aux loss run over all ``n`` tokens on every rank, as
    the reference computes them outside ``shard_map``.  Where ``n`` does
    not split over the ranks it takes the GSPMD path, as the reference
    does.  x [B, S, D] -> (out [B, S, D] on every rank, aux_loss)."""
    if isinstance(mesh, AbstractMesh):
        raise ValueError("moe_apply_shard_map needs a mesh of processes "
                         "(a DeviceMesh), not an abstract mesh")
    dt = x.dtype
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_token
    m_size = pdist.mesh_size(mesh, "model")
    e_loc = e // m_size
    axes = _token_axes(mesh)
    n_shards = 1
    for a in axes:
        n_shards *= pdist.mesh_size(mesh, a)
    local = p["wi_gate"].shape[0] == e_loc != e
    if n % n_shards:
        if local:
            raise ValueError(f"{n} tokens do not split over {n_shards} "
                             f"ranks, and the GSPMD path needs every "
                             f"expert: this rank holds {e_loc} of {e}")
        return moe_apply_gspmd(p, cfg, x)

    xf = x.reshape(n, d)
    _, probs, gate_vals, expert_idx = _route(p, cfg, xf)
    aux_loss = _aux_loss(cfg, probs, expert_idx)

    n_loc = n // n_shards
    a_loc = n_loc * k
    send_cf = getattr(cfg, "moe_send_capacity_factor", 1.5)
    cap_send = max(8, -(- int(a_loc / m_size * send_cf) // 8) * 8)
    cap_loc = max(8, -(- int(cap_send * m_size / e_loc
                             * cfg.moe_capacity_factor) // 8) * 8)

    # this rank's tokens; a replicated input used in part sums its
    # gradient over the ranks
    rows = slice(pdist.block_index(mesh, axes) * n_loc,
                 (pdist.block_index(mesh, axes) + 1) * n_loc)
    x_loc = pdist.grad_psum(xf, mesh, axes)[rows]
    gates_loc = pdist.grad_psum(gate_vals.to(dt), mesh, axes)[rows]
    idx_loc = expert_idx[rows]
    j = pdist.mesh_rank(mesh, "model")
    if local:
        # a slice's gradient sums over the ranks that share the experts
        w = [pdist.grad_psum(p[n_], mesh, axes[:-1]) for n_ in EXPERT_LEAVES]
    else:
        w = [pdist.grad_psum(p[n_], mesh, axes)[j * e_loc:(j + 1) * e_loc]
             for n_ in EXPERT_LEAVES]
    wg, wu, wo = (t.to(dt) for t in w)

    # ---- dispatch: pack by destination rank, exchange ----
    flat_e = idx_loc.reshape(a_loc)
    dest = flat_e // e_loc
    le = (flat_e % e_loc).to(torch.int32)
    meta = torch.stack([le, torch.arange(a_loc, dtype=torch.int32,
                                         device=x.device)], dim=1)
    send, send_meta, slot, keep = _pack_by_bucket(
        dest, m_size, cap_send, x_loc.repeat_interleave(k, dim=0), meta)
    recv = pdist.all_to_all(send, mesh, "model")
    recv_meta = pdist.all_to_all(send_meta, mesh, "model")

    # ---- pack the received rows by local expert (row e_loc: empty) ----
    r = recv.shape[0]
    valid = recv_meta[:, 0] >= 0
    le_r = torch.where(valid, recv_meta[:, 0], e_loc)
    buf, _, slot_r, keep_r = _pack_by_bucket(
        le_r, e_loc + 1, cap_loc, recv,
        torch.zeros(r, 1, dtype=torch.int32, device=x.device))
    buf = buf.reshape(e_loc + 1, cap_loc, d)[:e_loc]
    _count(~keep)
    _count(valid & ~keep_r)

    # ---- this rank's experts (SwiGLU) ----
    gate = torch.bmm(buf, wg)
    up = torch.bmm(buf, wu)
    y = torch.bmm(F.silu(gate) * up, wo)

    # ---- combine: back to the sending ranks, weight, sum over k ----
    y_flat = torch.cat([y.reshape(e_loc * cap_loc, d),
                        y.new_zeros(cap_loc + 1, d)])
    back = y_flat[slot_r.clamp_max(e_loc * cap_loc + cap_loc)]
    back = torch.where(keep_r[:, None], back, 0.0)
    ret = pdist.all_to_all(back, mesh, "model")
    ret_all = torch.cat([ret, ret.new_zeros(1, d)])
    out_rep = ret_all[slot.clamp_max(m_size * cap_send)]
    out_rep = torch.where(keep[:, None], out_rep, 0.0)
    out_loc = (out_rep * gates_loc.reshape(a_loc, 1)).reshape(
        n_loc, k, d).sum(dim=1)

    out = pdist.gather_blocks(out_loc, mesh, axes).reshape(b, s, d)
    if cfg.num_shared_experts:
        out = out + L.mlp_apply(p["shared"], x)
    return wlc(out, ("batch", None, None)), aux_loss
