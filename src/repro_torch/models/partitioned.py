"""Partitioned prefill and decode over a mesh of processes, the serving
half of the program the JAX dry run lowers (``repro.launch.dryrun``
``build_cell``: the prefill on parameters placed under
``DEFAULT_RULES``, ``make_serve_step`` on parameters and cache placed
under ``DECODE_RULES``).

Parameters (and the decode cache) come in as ``DTensor`` leaves placed
by their specs (``sharding.place`` of ``sharding.tree_named_shardings``
of the boxed trees); inside, each is a ``sharding.Blocked`` leaf, this
rank's block and its sharding.  ``ModelAPI.prefill`` / ``decode_step``
send such trees here, so ``serve.engine.make_serve_step`` runs
partitioned as it is.  Every rank passes the whole batch (the tokens,
and the frontend embeddings where there are any).

**Prefill** (:func:`prefill`, ``DEFAULT_RULES``): the rank computes the
rows its "batch" axes hold (``sharding.row_shard``; ranks that differ
only along "model" compute the same rows) through the one-process
``lm_prefill`` / ``encdec_prefill``, each super-block's parameters
gathered when it runs and the embedding and unembedding on their own
(``sharding.whole``); flash attention and the SSD scan run on the
rank's rows; MoE layers gather their tokens over the batch axes
(``moe.moe_apply_rows``).  The rank's rows of the cache (every
position) are cut to its block of each leaf's spec with no further
communication (``cache_len`` first pads them to a decode cache's
length, as ``ServeEngine`` merges a prefill cache), and the logits come
back split over the batch axes.

**Decode** (:func:`decode_step`, ``DECODE_RULES``): weights are split
on their non-embed dims and stay where they are; the activations of a
step (its rows: the "batch" rule's axes, ``("pod",)``) are replicated
over "data" and "model", and what moves between ranks is
activation-sized, through ``repro_torch.distributed``:

* a projection multiplies the rank's weight block (:func:`_dot`): its
  output comes out split as the weight's output dims are, and a split
  contraction (``wo`` over heads and head dim, an MLP's ``wo`` over
  ``("model", "data")``) is summed over the axes that split it;
* q / k / v blocks are gathered whole (a few KB a token) before RoPE;
  an RMS norm over a split dim sums its squares over the split;
* attention reads the rank's cache block (its "cache_batch" rows, its
  "kv_seq" positions): the softmax max and sum and the PV partials are
  reduced over the "kv_seq" axes (flash decoding, as the JAX
  annotations of ``gqa_decode`` describe), then the rows gathered;
* the new token's K/V row, latent or SSM state is written by the ranks
  that hold that position (or those heads and channels);
* a Mamba layer's conv window moves to its weights' channel blocks
  (an all-to-all of window rows, where the weights split the channels
  finer than the state does), its SSD state updates in place;
* MoE routes every token on every rank (the router is replicated; the
  capacity is over all tokens, the port's one-process semantics), each
  rank multiplies its experts' blocks of its capacity rows, and the
  outputs are summed over "model" and "data";
* the vocabulary-split embedding sums its looked-up rows, the
  vocabulary-split unembedding gathers its logits.

No parameter or cache leaf is gathered, whole or in part.  The logits
come back whole on every rank (so ``make_serve_step``'s argmax takes
them as they are) and the cache in its blocks, written in place.  What
does not depend on the partitioning (the write slot, the mask and
scale of the scores, the SSD discretisation and step, the conv step,
the experts' SwiGLU and their combine) is the one-process modules' own
helpers, so the two decodes differ only in what moves between ranks.

``prefill_blocks`` / ``decode_blocks`` run the same on ``Blocked``
trees directly, also on an abstract mesh (rank 0's blocks, shape-only
collectives): the dry run's rank-local programs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import distributed as pdist
from repro_torch import memory
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partition as P
from repro_torch.train.checkpoint import (_flatten_with_names, tree_leaves,
                                          tree_map)

# ---------------------------------------------------------------------------
# Blocks of activations
# ---------------------------------------------------------------------------


def _size(mesh, entry) -> int:
    return math.prod(pdist.mesh_size(mesh, a) for a in P._entry_axes(entry))


def _entry(axes: tuple):
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


def _norm(mesh, entry):
    """``entry`` without its axes of one rank (they split nothing; a
    ``DTensor``'s placements do not keep their order)."""
    return _entry(tuple(a for a in P._entry_axes(entry)
                        if pdist.mesh_size(mesh, a) > 1))


def _normalized(tree):
    """``tree``'s ``Blocked`` leaves with :func:`_norm`'d specs (the same
    blocks)."""
    def one(x):
        if not isinstance(x, P.Blocked):
            return x
        return P.Blocked(x.local, P.NamedSharding(
            x.mesh, tuple(_norm(x.mesh, e) for e in x.spec)))
    return tree_map(one, tree)


def _cut(x, dim: int, entry, mesh):
    """This rank's block of ``x``'s whole dim ``dim`` split over
    ``entry`` (no communication)."""
    n = _size(mesh, entry)
    if n == 1:
        return x
    k = x.shape[dim] // n
    return x.narrow(dim, pdist.block_index(mesh, P._entry_axes(entry)) * k,
                    k)


def _join(x, dim: int, entry, mesh):
    """The whole dim ``dim`` from this rank's block of it (an all-gather
    an axis of ``entry``, the minor axis first)."""
    for a in reversed(P._entry_axes(entry)):
        if pdist.mesh_size(mesh, a) > 1:
            x = pdist.gather_dim(x, mesh, a, dim)
    return x


def _sum(x, mesh, axes):
    for a in axes:
        if pdist.mesh_size(mesh, a) > 1:
            x = pdist.psum(x, mesh, a)
    return x


def _max(x, mesh, axes):
    for a in axes:
        if pdist.mesh_size(mesh, a) > 1:
            x = pdist.pmax(x, mesh, a)
    return x


def _held(w):
    """The value of a leaf every rank holds whole (a norm scale, a
    router, ...); a split one raises: decode never gathers a weight."""
    if isinstance(w, P.Blocked):
        if any(_size(w.mesh, e) > 1 for e in w.spec):
            raise ValueError(f"decode expects this leaf whole on every "
                             f"rank (DECODE_RULES), it is split {w.spec}")
        return w.local
    return w


def _dot(x, w: P.Blocked, k: int, x_entries=None):
    """``x`` [..., c1..ck] times the leaf ``w`` [c1..ck, o...]: this
    rank's block of the product's output dims, split as ``w``'s are, and
    summed over the mesh axes that split the contraction.  ``x_entries``
    says how ``x``'s last ``k`` dims are split (None: whole); a dim split
    otherwise than ``w``'s is gathered and cut to ``w``'s block (an
    activation, never the weight).  Returns (product, its output dims'
    entries)."""
    mesh, spec = w.mesh, w.spec
    x_entries = tuple(x_entries or (None,) * k)
    nd = x.dim()
    summed: list = []
    for i in range(k):
        d = nd - k + i
        if x_entries[i] != spec[i]:
            x = _cut(_join(x, d, x_entries[i], mesh), d, spec[i], mesh)
        summed += P._entry_axes(spec[i])
    wl = w.local.to(x.dtype)
    c, o = wl.shape[:k], wl.shape[k:]
    y = x.reshape(*x.shape[:nd - k], math.prod(c)) @ wl.reshape(
        math.prod(c), math.prod(o))
    y = y.reshape(*x.shape[:nd - k], *o)
    return _sum(y, mesh, summed), spec[k:]


def _rmsnorm_split(scale, x, entry, mesh, eps: float):
    """``layers.rmsnorm`` over ``x``'s last dim, which is split over
    ``entry`` as ``scale``'s only dim is: the squares summed over the
    split."""
    if isinstance(scale, P.Blocked):
        if scale.spec[0] != entry:
            raise ValueError(f"a norm scale split {scale.spec} over an "
                             f"activation split {entry}")
        scale = scale.local
    dt = x.dtype
    xf = x.float()
    n = xf.shape[-1] * _size(mesh, entry)
    var = _sum(xf.square().sum(dim=-1, keepdim=True), mesh,
               P._entry_axes(entry)) / n
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _inner(cache_entry, rows: tuple, mesh) -> tuple:
    """The axes that split a cache leaf's batch rows within the rows of
    a step (whose axes lead the cache's batch entry)."""
    axes = P._entry_axes(_norm(mesh, cache_entry))
    if axes[:len(rows)] != rows:
        raise ValueError(f"a cache split over {axes} by batch under rows "
                         f"split over {rows}")
    return axes[len(rows):]


def _softmax_pv(scores, v, eq: str, mesh, seq_axes, dt):
    """``softmax(scores) @ v`` over keys split along ``seq_axes``: the
    max and the sum reduced over them, then the partial products
    (``eq`` the einsum of probabilities and values)."""
    m = _max(scores.amax(dim=-1, keepdim=True), mesh, seq_axes)
    e = torch.exp(scores - m)
    s = _sum(e.sum(dim=-1, keepdim=True), mesh, seq_axes)
    return _sum(torch.einsum(eq, (e / s).to(dt), v), mesh, seq_axes)


# ---------------------------------------------------------------------------
# Decode mixers and FFNs on a rank's blocks
# ---------------------------------------------------------------------------

def gqa_decode(p: dict, cfg: ModelConfig, x, cache: A.KVCacheEntry, pos: int,
               rows: tuple, *, window=None):
    """``attention.gqa_decode`` on this rank's blocks: x [Br,1,E] (the
    step's rows), the cache's k/v blocks [Bc,Sc,K,D] ("cache_batch",
    "kv_seq") written in place.  Returns the mixer's output [Br,1,E]."""
    mesh = p["wq"].mesh
    dt, br, pos = x.dtype, x.shape[0], int(pos)
    q, qe = _dot(x, p["wq"], 1)
    k, ke = _dot(x, p["wk"], 1)
    v, ve = _dot(x, p["wv"], 1)
    if cfg.qk_norm:
        q = _rmsnorm_split(p["q_norm"], q, qe[-1], mesh, cfg.norm_eps)
        k = _rmsnorm_split(p["k_norm"], k, ke[-1], mesh, cfg.norm_eps)
    q = _join(_join(q, 2, qe[0], mesh), 3, qe[1], mesh)
    k = _join(_join(k, 2, ke[0], mesh), 3, ke[1], mesh)
    v = _join(_join(v, 2, ve[0], mesh), 3, ve[1], mesh)
    posb = torch.full((br, 1), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k = L.apply_rope(k, posb, cfg.rope_theta)

    kb, vb = cache.k, cache.v
    eb, es = kb.spec[0], kb.spec[1]
    if any(_size(mesh, e) > 1 for e in kb.spec[2:]):
        raise ValueError(f"a KV cache split {kb.spec} past its positions")
    inner = _inner(eb, rows, mesh)
    kl, vl = kb.local, vb.local
    bc, sc = kl.shape[:2]
    s0 = pdist.block_index(mesh, P._entry_axes(es)) * sc
    write_at = A.decode_slot(pos, sc * _size(mesh, es), window)
    q, k, v = (_cut(t, 0, _entry(inner), mesh) for t in (q, k, v))
    if s0 <= write_at < s0 + sc:
        kl[:, write_at - s0] = k[:, 0].to(kl.dtype)
        vl[:, write_at - s0] = v[:, 0].to(vl.dtype)
    h, kh = q.shape[2], kl.shape[2]
    qg = q.reshape(bc, 1, kh, h // kh, q.shape[-1])
    scores = A.decode_scores(
        torch.einsum("bskgd,btkd->bkgst", qg.float(), kl.float()),
        q.shape[-1], s0 + torch.arange(sc, device=x.device), pos)
    out = _softmax_pv(scores, vl.to(dt), "bkgst,btkd->bskgd", mesh,
                      P._entry_axes(es), dt)
    out = _join(out.reshape(bc, 1, h, q.shape[-1]), 0, _entry(inner), mesh)
    return _dot(out, p["wo"], 2)[0]


def mla_decode(p: dict, cfg: ModelConfig, x, cache: A.KVCacheEntry, pos: int,
               rows: tuple):
    """``attention.mla_decode`` (weight-absorbed) on this rank's blocks:
    the latent [Bc,Sc,R] and rope key [Bc,Sc,P] blocks written in
    place."""
    mesh = p["wo"].mesh
    dt, br, pos = x.dtype, x.shape[0], int(pos)
    posb = torch.full((br, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.q_lora_rank:
        cq, ce = _dot(x, p["wq_a"], 1)
        cq = _rmsnorm_split(p["q_norm"], cq, ce[0], mesh, cfg.norm_eps)
        q, qe = _dot(cq, p["wq_b"], 1, x_entries=ce)
    else:
        q, qe = _dot(x, p["wq"], 1)
    q = _join(_join(q, 2, qe[0], mesh), 3, qe[1], mesh)
    nope = cfg.qk_nope_dim
    q_nope = q[..., :nope]
    q_rope = L.apply_rope(q[..., nope:], posb, cfg.rope_theta)
    ckv, cke = _dot(x, p["wkv_a"], 1)
    ckv = _join(ckv, 2, cke[0], mesh)
    r = cfg.kv_lora_rank
    c_new = _rmsnorm_split(p["kv_norm"], ckv[..., :r], None, mesh,
                           cfg.norm_eps)
    kr_new = L.apply_rope(ckv[..., r:][:, :, None, :], posb, cfg.rope_theta)

    cb, rb = cache.k, cache.v
    eb, es = cb.spec[0], cb.spec[1]
    inner = _entry(_inner(eb, rows, mesh))
    cl, rl = cb.local, rb.local
    sc = cl.shape[1]
    s0 = pdist.block_index(mesh, P._entry_axes(es)) * sc
    write_at = A.decode_slot(pos, sc * _size(mesh, es))
    if s0 <= write_at < s0 + sc:
        cl[:, write_at - s0] = _cut(c_new, 0, inner, mesh)[:, 0].to(cl.dtype)
        rl[:, write_at - s0] = _cut(kr_new, 0, inner,
                                    mesh)[:, 0, 0].to(rl.dtype)

    # absorb: latent-space queries for this rank's heads, then all heads
    wk = p["wk_b"]
    eh, ed = wk.spec[1], wk.spec[2]
    qn = _cut(_cut(q_nope, 2, eh, mesh), 3, ed, mesh)
    q_lat = _sum(torch.einsum("bshd,rhd->bshr", qn, wk.local.to(dt)), mesh,
                 P._entry_axes(ed))
    q_lat = _join(q_lat, 2, eh, mesh)
    scores = A.decode_scores(
        torch.einsum("bshr,btr->bhst", _cut(q_lat, 0, inner, mesh).float(),
                     cl.float())
        + torch.einsum("bshp,btp->bhst", _cut(q_rope, 0, inner, mesh).float(),
                       rl.float()),
        nope + cfg.qk_rope_dim, s0 + torch.arange(sc, device=x.device), pos)
    o_lat = _softmax_pv(scores, cl.float(), "bhst,btr->bshr", mesh,
                        P._entry_axes(es), torch.float32)
    o_lat = _join(o_lat, 0, inner, mesh)
    wv = p["wv_b"]
    ev = (wv.spec[1], wv.spec[2])
    out = torch.einsum("bshr,rhd->bshd",
                       _cut(o_lat, 2, ev[0], mesh).to(dt), wv.local.to(dt))
    return _dot(out, p["wo"], 2, x_entries=ev)[0]


def _conv_window(p: dict, conv: P.Blocked, new, rows: tuple, dt):
    """The causal conv's step on this rank's blocks: ``new`` [Br,1,C] the
    step's whole conv input.  Writes the state block [Bc,W-1,Cs]
    ("cache_batch", None, "mlp") in place and returns the conv's output
    [Br,C] whole."""
    mesh = conv.mesh
    cw, cb = p["conv_w"], p["conv_b"]
    if _size(mesh, cw.spec[0]) > 1 or cb.spec[0] != cw.spec[1]:
        raise ValueError(f"conv weights split {cw.spec} / {cb.spec}")
    eb, es, ew = conv.spec[0], conv.spec[2], cw.spec[1]
    inner = _inner(eb, rows, mesh)
    EW, ES = P._entry_axes(ew), P._entry_axes(es)
    state = conv.local
    window = torch.cat([state.to(dt), _cut(_cut(new, 0, _entry(inner),
                                                 mesh), 2, es, mesh)], dim=1)
    state.copy_(window[:, 1:])
    if ES[:len(EW)] == EW:
        # the rank's weight block covers its state's channels
        rest = _entry(ES[len(EW):])
        out = S.conv_step(window, _cut(cw.local, 1, rest, mesh),
                          _cut(cb.local, 0, rest, mesh))
        return _join(_join(out, 1, es, mesh), 0, _entry(inner), mesh)
    if EW[:len(ES)] == ES and not inner:
        # the state block covers the weight's channels, every row
        out = S.conv_step(_cut(window, 2, _entry(EW[len(ES):]), mesh),
                          cw.local, cb.local)
        return _join(out, 1, ew, mesh)
    if EW == ES + inner and len(inner) == 1:
        # the weight splits the state's channels further along the axis
        # that splits its rows: one all-to-all of window rows
        n = pdist.mesh_size(mesh, inner[0])
        bc, w, cs = window.shape
        got = pdist.all_to_all(window.permute(2, 0, 1).contiguous(), mesh,
                               inner[0])
        win = got.reshape(n, cs // n, bc, w).permute(0, 2, 3, 1).reshape(
            n * bc, w, cs // n)
        return _join(S.conv_step(win, cw.local, cb.local), 1, ew, mesh)
    raise NotImplementedError(f"a conv state split {conv.spec} under "
                              f"weights split {cw.spec}")


def mamba_decode(p: dict, cfg: ModelConfig, x, state, rows: tuple):
    """``ssm.mamba_decode`` on this rank's blocks: the conv state and the
    SSD state [Bc,Hs,P,N] ("cache_batch", "ssm_heads") written in
    place."""
    mesh = p["wo"].mesh
    dt_, di = x.dtype, cfg.d_inner
    n, h, pdim = cfg.ssm_state_dim, cfg.ssm_heads, cfg.ssm_head_dim
    z, ze = _dot(x, p["wz"], 1)
    xs, xe = _dot(x, p["wx"], 1)
    Bm, be = _dot(x, p["wB"], 1)
    Cm, ce = _dot(x, p["wC"], 1)
    dt_raw, dte = _dot(x, p["wdt"], 1)
    new = torch.cat([_join(xs, 2, xe[0], mesh), _join(Bm, 2, be[0], mesh),
                     _join(Cm, 2, ce[0], mesh)], dim=-1)
    conv = _conv_window(p, state.conv, new, rows, dt_)
    xs, Bm, Cm = conv[:, :di], conv[:, di: di + n], conv[:, di + n:]

    sb = state.ssd
    eb, eh = sb.spec[0], sb.spec[1]
    inner = _entry(_inner(eb, rows, mesh))
    for name in ("A_log", "dt_bias", "D"):
        if p[name].spec[0] != eh:
            raise ValueError(f"{name} split {p[name].spec}, the SSD state "
                             f"{sb.spec}")
    dtr = _cut(_join(dt_raw, 2, dte[0], mesh), 2, eh, mesh)
    dt, a = S.ssd_discretize(_cut(dtr, 0, inner, mesh)[:, 0],
                             p["dt_bias"].local, p["A_log"].local)
    bc = dt.shape[0]
    xs_h = _cut(_cut(xs, 0, inner, mesh).reshape(bc, h, pdim), 1, eh, mesh)
    y, s_new = S.ssd_step(sb.local, xs_h, dt, torch.exp(a),
                          _cut(Bm, 0, inner, mesh), _cut(Cm, 0, inner, mesh),
                          p["D"].local)
    sb.local.copy_(s_new)
    y = _join(_join(y, 1, eh, mesh), 0, inner, mesh).reshape(-1, 1, di)
    y = _rmsnorm_split(p["norm"], _cut(y, 2, ze[0], mesh) * F.silu(z),
                       ze[0], mesh, cfg.norm_eps)
    return _dot(y, p["wo"], 1, x_entries=ze)[0]


def mlp_decode(p: dict, x):
    """``layers.mlp_apply`` on this rank's blocks: the hidden units stay
    split as ``wi_gate``'s; ``wo``'s contraction summed."""
    mesh = p["wo"].mesh
    g, ge = _dot(x, p["wi_gate"], 1)
    u, ue = _dot(x, p["wi_up"], 1)
    if ue != ge:
        u = _cut(_join(u, -1, ue[0], mesh), -1, ge[0], mesh)
    return _dot(F.silu(g) * u, p["wo"], 1, x_entries=ge)[0]


def moe_decode(p: dict, cfg: ModelConfig, x, rows: tuple):
    """``moe.moe_apply_gspmd`` on this rank's expert blocks: every token
    of the step routed on every rank (capacity over all of them), the
    rank's experts x its ``expert_mlp`` block at their capacity rows,
    the outputs summed over "model" and "data"."""
    mesh = p["wo"].mesh
    d = x.shape[-1]
    xa = _join(x, 0, _entry(rows), mesh)
    nt = xa.shape[0] * xa.shape[1]
    e, k = cfg.num_experts, cfg.num_experts_per_token
    cap = M._capacity(cfg, nt)
    xf = xa.reshape(nt, d)
    _, _, gate_vals, expert_idx = M._route({"router": _held(p["router"])},
                                           cfg, xf)
    flat_e = expert_idx.reshape(nt * k)
    buf, _, slot, keep = M._pack_by_bucket(
        flat_e, e, cap, xf.repeat_interleave(k, dim=0),
        flat_e.new_zeros(nt * k, 0))
    M._count(~keep)
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    ex, ef = wg.spec[0], wg.spec[2]
    if (_size(mesh, wg.spec[1]) > 1 or _size(mesh, wo.spec[2]) > 1
            or (wu.spec[0], wo.spec[0]) != (ex, ex)
            or (wu.spec[2], wo.spec[1]) != (ef, ef)):
        raise ValueError(f"experts split {wg.spec} / {wu.spec} / {wo.spec}")
    el = wg.local.shape[0]
    x0 = pdist.block_index(mesh, P._entry_axes(ex)) * el
    y = M.expert_ffn(buf.view(e, cap, d)[x0:x0 + el], wg.local, wu.local,
                     wo.local)
    local = slot - x0 * cap
    mine = keep & (local >= 0) & (local < el * cap)
    out = M.combine(y.reshape(el * cap, d),
                    torch.where(mine, local, el * cap), gate_vals, keep)
    out = _sum(out, mesh, P._entry_axes(ex) + P._entry_axes(ef))
    out = _cut(out.reshape(xa.shape), 0, _entry(rows), mesh)
    if cfg.num_shared_experts:
        out = out + mlp_decode(p["shared"], x)
    return out


def cross_decode(p: dict, cfg: ModelConfig, x, kv: A.KVCacheEntry,
                 rows: tuple):
    """``attention.cross_attention_apply`` on this rank's blocks of the
    cross cache [Bc,T,Hc,D] ("cache_batch", None, "heads")."""
    mesh = p["wo"].mesh
    q, qe = _dot(x, p["wq"], 1)
    q = _join(_join(q, 2, qe[0], mesh), 3, qe[1], mesh)
    spec = kv.k.spec
    if _size(mesh, spec[1]) > 1 or _size(mesh, spec[3]) > 1:
        raise ValueError(f"a cross cache split {spec} past its heads")
    inner, eh = _entry(_inner(spec[0], rows, mesh)), spec[2]
    qh = _cut(_cut(q, 0, inner, mesh), 2, eh, mesh)
    out = A.attention_core(qh, kv.k.local, kv.v.local, cfg, causal=False)
    out = _join(out, 0, inner, mesh)
    return _dot(out, p["wo"], 2, x_entries=(eh, None))[0]


# ---------------------------------------------------------------------------
# Embedding and logits on vocabulary blocks
# ---------------------------------------------------------------------------

def _embed_rows(table: P.Blocked, tokens, dt):
    """The rows of a vocabulary-split table for ``tokens``: each rank
    looks up the tokens in its block, the rows summed over the split."""
    mesh, (ev, ee) = table.mesh, table.spec
    if _size(mesh, ee) > 1:
        raise ValueError(f"an embedding split {table.spec} past its vocab")
    n = table.local.shape[0]
    t = tokens.long() - pdist.block_index(mesh, P._entry_axes(ev)) * n
    inside = ((t >= 0) & (t < n))[..., None].to(table.dtype)
    rows = table.local[t.clamp(0, n - 1)] * inside
    return _sum(rows, mesh, P._entry_axes(ev)).to(L.torch_dtype(dt))


def _logits_rows(params, cfg: ModelConfig, x):
    """Whole logits [Br,1,V] of the step's rows from the vocabulary
    blocks of the unembedding."""
    x = L.rmsnorm(_held(params["final_norm"]), x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    if _size(table.mesh, table.spec[1]) > 1:
        raise ValueError(f"an unembedding split {table.spec} past its vocab")
    out = L.unembed_logits(table.local, x, cfg.logits_dtype)
    return _join(out, 2, table.spec[0], table.mesh)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _mesh(params):
    for x in tree_leaves(params):
        if isinstance(x, P.Blocked):
            return x.mesh
    raise ValueError("no partitioned leaf")


def _rows(n: int, mesh, rules) -> tuple:
    """The axes a batch of ``n`` rows splits over under ``rules`` (the
    "batch" rule's, those that divide ``n``)."""
    spec = P._divisible((n,), P.logical_to_mesh_axes(("batch",), rules,
                                                     mesh), mesh)
    return P._entry_axes(_norm(mesh, spec[0]))


def decode_blocks(cfg: ModelConfig, params, cache, token, pos):
    """One decode step on ``Blocked`` trees (parameters and cache placed
    under ``DECODE_RULES``): token [B,1] whole, pos an int.  Writes the
    cache's blocks in place; returns the logits [B,1,V] whole."""
    mesh = _mesh(params)
    params, cache = _normalized(params), _normalized(cache)
    rows = _rows(token.shape[0], mesh, P.DECODE_RULES)
    x = _embed_rows(params["embed"], _cut(token, 0, _entry(rows), mesh),
                    cfg.dtype)
    if cfg.is_encoder_decoder:
        for j in range(cfg.num_layers):
            p = T._layer(params["dec_blocks"], j)
            h = L.rmsnorm(_held(p["norm1"]), x, cfg.norm_eps)
            x = x + gqa_decode(p["self_attn"], cfg, h,
                               T._layer(cache["self"], j), pos, rows)
            hx = L.rmsnorm(_held(p["norm_x"]), x, cfg.norm_eps)
            x = x + cross_decode(p["cross_attn"], cfg, hx,
                                 T._layer(cache["cross"], j), rows)
            h2 = L.rmsnorm(_held(p["norm2"]), x, cfg.norm_eps)
            x = x + mlp_decode(p["mlp"], h2)
    else:
        specs = T.block_specs(cfg)
        for j in range(T._n_super(cfg, specs)):
            layer = T._layer(params["blocks"], j)
            for i, spec in enumerate(specs):
                p, entry = layer[f"pos{i}"], T._layer(cache[f"pos{i}"], j)
                h = L.rmsnorm(_held(p["norm1"]), x, cfg.norm_eps)
                if spec.kind == "M":
                    mix = mamba_decode(p["mamba"], cfg, h, entry, rows)
                elif cfg.attention_kind == "mla":
                    mix = mla_decode(p["attn"], cfg, h, entry, pos, rows)
                else:
                    mix = gqa_decode(p["attn"], cfg, h, entry, pos, rows,
                                     window=T._attn_window(cfg))
                x = x + mix
                if spec.has_ffn:
                    h = L.rmsnorm(_held(p["norm2"]), x, cfg.norm_eps)
                    x = x + (moe_decode(p["moe"], cfg, h, rows)
                             if spec.is_moe else mlp_decode(p["mlp"], h))
    return _join(_logits_rows(params, cfg, x), 0, _entry(rows), mesh)


def prefill_blocks(cfg: ModelConfig, params, batch: dict, *,
                   cache_len: int | None = None):
    """The prefill on a ``Blocked`` parameter tree placed under
    ``DEFAULT_RULES``, every rank passing the whole ``batch``.  Returns
    (this rank's rows of the last-position logits [Br,1,V], the row
    axes, the cache as ``Blocked`` leaves placed under
    ``DEFAULT_RULES``, or, with ``cache_len``, padded to that many
    positions and placed under ``DECODE_RULES`` for the decode step)."""
    from repro_torch.models.api import model_api
    api = model_api(cfg)
    mesh = _mesh(params)
    b = batch["tokens"].shape[0]
    rows = _rows(b, mesh, P.DEFAULT_RULES)
    shard = P.RowShard(mesh, rows)
    k = b // shard.blocks
    mine = {key: v[shard.index * k:(shard.index + 1) * k]
            for key, v in batch.items()}
    fn = ED.encdec_prefill if cfg.is_encoder_decoder else T.lm_prefill
    with P.row_shard(mesh, rows):
        logits, cache = fn(params, cfg, mine)
    _, leaves, unflatten = _flatten_with_names(cache)
    s = max(x.shape[2] for x in leaves)
    if cache_len is not None:
        with memory.untracked():
            target = tree_leaves(api.init_cache(k, cache_len, device="meta"))
        padded = []
        for x, z in zip(leaves, target):
            if tuple(x.shape) != tuple(z.shape):
                if (x.shape[:2] != z.shape[:2] or x.shape[3:] != z.shape[3:]
                        or x.shape[2] > z.shape[2]):
                    raise ValueError(f"cache merge mismatch: "
                                     f"{tuple(z.shape)} vs {tuple(x.shape)}")
                x = F.pad(x, (0, 0) * (x.dim() - 3)
                          + (0, z.shape[2] - x.shape[2]))
            padded.append(x.to(z.dtype))
        leaves, s = padded, cache_len
    with memory.untracked():
        boxes = tree_leaves(L.abstract(api.init_cache, b, s))
    out = []
    for x, box in zip(leaves, boxes):
        whole = (x.shape[0], b) + tuple(x.shape[2:])
        spec = P._divisible(whole, P.logical_to_mesh_axes(
            box.axes, P.DEFAULT_RULES if cache_len is None
            else P.DECODE_RULES, mesh), mesh)
        x = _cut(x, 1, _entry(_inner(spec[1], rows, mesh)), mesh)
        for d, e in enumerate(spec):
            if d != 1:
                x = _cut(x, d, e, mesh)
        out.append(P.Blocked(x.clone(memory_format=torch.contiguous_format),
                             P.NamedSharding(mesh, spec)))
    return logits, rows, unflatten(out)


def prefill(cfg: ModelConfig, params, batch: dict, *,
            cache_len: int | None = None):
    """The partitioned prefill of ``DTensor`` parameters (see
    :func:`prefill_blocks`): (logits [B,1,V] as a ``DTensor`` split over
    the batch axes, the cache as ``DTensor`` leaves placed by their
    specs)."""
    params = P.blocked(params)
    mesh, device = _mesh(params), params["embed"].local.device
    logits, rows, cache = prefill_blocks(
        cfg, params, {k: torch.as_tensor(v, device=device)
                      for k, v in batch.items()}, cache_len=cache_len)
    _, leaves, unflatten = _flatten_with_names(cache)
    logits = P.from_local(logits.contiguous(), P.NamedSharding(
        mesh, (_entry(rows), None, None)))
    return logits, unflatten([P.from_local(x.local, x.sharding)
                              for x in leaves])


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """The partitioned decode step of ``DTensor`` parameters and cache
    (see :func:`decode_blocks`): (logits [B,1,V] whole, the cache, its
    blocks written in place)."""
    params = P.blocked(params)
    logits = decode_blocks(cfg, params, P.blocked(cache), torch.as_tensor(
        token, device=params["embed"].local.device), pos)
    return logits, cache
