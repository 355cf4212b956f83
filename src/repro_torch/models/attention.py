"""Attention: GQA/MHA, sliding-window (SWA), MLA (latent) and the
encoder-decoder's cross-attention, the port of ``repro.models.attention``.

Prefill self-attention goes through the flash-attention kernel
(``kernels.flash_attention.ops.flash_attention``) wherever its function
is the model's: queries and keys aligned (``q_offset == 0``, Sq == Skv),
no window or S <= window, and value dim <= head dim.  A narrower V
(MLA: q/k dim nope + rope, V dim ``v_head_dim``) is zero-padded to the
head dim and the output's first ``dv`` columns kept: a zero column of V
adds nothing to the others, and the scale stays 1/sqrt(q/k dim), as in
the JAX ``attention_core``.  On a CUDA tensor that launches the
hand-written kernel, on a CPU tensor its plain version.  Elsewhere the
JAX package's branches stay:

* ``naive``     — full-scores attention (``attention_impl="naive"``).
* ``chunked``   — online softmax over KV chunks.
* SWA prefill   — exact chunk+neighbour decomposition (each query chunk of
                  width W attends to its own and the previous KV chunk).

``kernel=False`` (on ``attention_core`` and each mixer above it) takes
exactly the JAX ``attention_core``'s branches instead: the training
route, since the flash kernel has no backward and its op refuses inputs
that require grad.

Decode (``gqa_decode``, ``mla_decode``) is plain tensor code, as in the
JAX package: one query against the whole cache, grouped heads without
repeating KV (GQA), or weight-absorbed queries against the latent cache
(MLA).  Each writes the new entry into the cache in place (the JAX
engine donates the cache to the same effect).

Cross-attention (``cross_attention_*``) projects Q, K and V per head
(``[d, H, hd]``: the cross cache holds ``num_heads``, not
``num_kv_heads``) and attends over every encoder row with no mask; its
Sq differs from Skv, so ``attention_core`` sends it to the plain naive /
chunked branches, as the JAX ``attention_core`` does (the JAX package
has no Pallas cross-attention).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   n: int | None = None, dtype=torch.float32) -> dict:
    if cfg.attention_kind == "mla":
        return init_mla_attention(gen, cfg, n=n, dtype=dtype)
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(n=n, dtype=dtype)
    p = {
        "wq": L.dense_init(gen, (d, h, hd), ("embed", "heads", "head_dim"),
                           fan_in=d, **kw),
        "wk": L.dense_init(gen, (d, k, hd),
                           ("embed", "kv_heads", "head_dim"), fan_in=d, **kw),
        "wv": L.dense_init(gen, (d, k, hd),
                           ("embed", "kv_heads", "head_dim"), fan_in=d, **kw),
        "wo": L.dense_init(gen, (h, hd, d), ("heads", "head_dim", "embed"),
                           fan_in=h * hd, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.ones_init((hd,), ("head_dim",), gen.device, **kw)
        p["k_norm"] = L.ones_init((hd,), ("head_dim",), gen.device, **kw)
    return p


def init_mla_attention(gen: torch.Generator, cfg: ModelConfig,
                       n: int | None = None, dtype=torch.float32) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(n=n, dtype=dtype)
    p = {
        "wkv_a": L.dense_init(gen, (d, kvr + rope), ("embed", "lora"),
                              fan_in=d, **kw),
        "kv_norm": L.ones_init((kvr,), ("lora",), gen.device, **kw),
        "wk_b": L.dense_init(gen, (kvr, h, nope), ("lora", "heads",
                                                  "head_dim"),
                             fan_in=kvr, **kw),
        "wv_b": L.dense_init(gen, (kvr, h, vd), ("lora", "heads", "head_dim"),
                             fan_in=kvr, **kw),
        "wo": L.dense_init(gen, (h, vd, d), ("heads", "head_dim", "embed"),
                           fan_in=h * vd, **kw),
    }
    if qr:
        p["wq_a"] = L.dense_init(gen, (d, qr), ("embed", "lora"), fan_in=d,
                                 **kw)
        p["q_norm"] = L.ones_init((qr,), ("lora",), gen.device, **kw)
        p["wq_b"] = L.dense_init(gen, (qr, h, nope + rope),
                                 ("lora", "heads", "head_dim"), fan_in=qr,
                                 **kw)
    else:
        p["wq"] = L.dense_init(gen, (d, h, nope + rope),
                               ("embed", "heads", "head_dim"), fan_in=d, **kw)
    return p


# ---------------------------------------------------------------------------
# Core softmax-attention primitives
# ---------------------------------------------------------------------------

def _broadcast_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, K, D] -> [B, T, H, D] by repeating each KV head H//K times."""
    kh = k.shape[2]
    if kh == num_heads:
        return k
    return k.repeat_interleave(num_heads // kh, dim=2)


def naive_attention(q, k, v, *, causal: bool, scale: float,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,K,D]. Full-score reference path."""
    h = q.shape[2]
    k = _broadcast_kv(k, h)
    v = _broadcast_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    sq, tk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(sq, tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def chunked_attention(q, k, v, *, causal: bool, scale: float,
                      chunk_kv: int, window: Optional[int] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the JAX package's XLA
    analogue of flash attention).  q [B,S,H,D]; k/v [B,T,K,D]."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    t = k.shape[1]
    chunk_kv = min(chunk_kv, t)
    n_chunks = -(-t // chunk_kv)
    qf = q.float()
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    m = torch.full((b, h, s), NEG_INF, device=q.device)
    l = torch.zeros(b, h, s, device=q.device)
    acc = torch.zeros(b, h, s, dv, device=q.device)
    for idx in range(n_chunks):
        lo = idx * chunk_kv
        k_blk = _broadcast_kv(k[:, lo: lo + chunk_kv], h).float()
        v_blk = _broadcast_kv(v[:, lo: lo + chunk_kv], h).float()
        scores = torch.einsum("bshd,bthd->bhst", qf, k_blk) * scale
        kpos = lo + torch.arange(chunk_kv, device=q.device)[None, :]
        kpos = kpos[:, : k_blk.shape[1]]
        mask = torch.ones(s, kpos.shape[1], dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= (qpos - kpos) < window
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhst,bthd->bhsd", p,
                                                    v_blk)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def sliding_window_attention(q, k, v, *, scale: float, window: int
                             ) -> torch.Tensor:
    """Exact causal SWA via chunk+neighbour decomposition: O(S·W) compute.

    Requires q and k aligned (self-attention).  The sequence is padded to
    a multiple of W; each query chunk attends to [prev, self] KV chunks
    with an exact relative-position mask.
    """
    b, s, h, d = q.shape
    k = _broadcast_kv(k, h)
    v = _broadcast_kv(v, h)
    w = window
    n = -(-s // w)
    pad = n * w - s
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (q, k, v))
    qc = q.reshape(b, n, w, h, d)
    kc = k.reshape(b, n, w, h, d)
    vc = v.reshape(b, n, w, h, d)
    k_prev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kc], dim=2)     # [B, n, 2W, H, D]
    v2 = torch.cat([v_prev, vc], dim=2)
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qc.float(), k2.float()) \
        * scale
    qpos = torch.arange(w, device=q.device)[:, None]
    kpos = torch.arange(2 * w, device=q.device)[None, :] - w
    rel = qpos - kpos
    mask = (rel >= 0) & (rel < w)
    first = torch.arange(n, device=q.device) == 0
    mask_first = mask & (kpos >= 0)
    full_mask = torch.where(first[:, None, None], mask_first[None],
                            mask[None])
    scores = torch.where(full_mask[None, :, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v2.float())
    return out.reshape(b, n * w, h, d)[:, :s].to(q.dtype)


def attention_core(q, k, v, cfg: ModelConfig, *, causal=True, window=None,
                   q_offset=0, kernel=True) -> torch.Tensor:
    """Softmax attention, q [B,Sq,H,Dq], k [B,Skv,K,Dq], v [B,Skv,K,Dv] ->
    [B,Sq,H,Dv].  ``kernel``: the flash kernel where its function is the
    model's; False: the JAX package's plain branches only."""
    sq, skv = q.shape[1], k.shape[1]
    dq, dv = q.shape[-1], v.shape[-1]
    if (kernel and q_offset == 0 and sq == skv
            and (window is None or sq <= window) and dv <= dq):
        if dv == dq:
            return flash_attention(q, k, v, causal=causal)
        # MLA: V's zero columns add nothing, the scale stays 1/sqrt(dq)
        v = torch.nn.functional.pad(v, (0, dq - dv))
        return flash_attention(q, k, v, causal=causal)[..., :dv]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if window is not None and causal and cfg.attention_impl != "naive" \
            and sq == skv and sq > window:
        return sliding_window_attention(q, k, v, scale=scale, window=window)
    if cfg.attention_impl == "naive" or sq * skv <= 512 * 512:
        return naive_attention(q, k, v, causal=causal, scale=scale,
                               window=window, q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal, scale=scale,
                             chunk_kv=cfg.attn_chunk_kv, window=window,
                             q_offset=q_offset)


# ---------------------------------------------------------------------------
# GQA self-attention (prefill / decode)
# ---------------------------------------------------------------------------

class KVCacheEntry(NamedTuple):
    k: torch.Tensor  # [B, S, K, D]  (GQA)  /  latent [B, S, R] (MLA)
    v: torch.Tensor  # [B, S, K, D]         /  rope   [B, S, P] (MLA)


def _project(x, w):
    """x [B,S,E] x w [E, heads, D] -> [B, S, heads, D]."""
    e, nh, d = w.shape
    return (x @ w.to(x.dtype).reshape(e, nh * d)).reshape(
        *x.shape[:2], nh, d)


def _out_project(out, w):
    """out [B,S,H,D] x w [H, D, E] -> [B, S, E]."""
    h, d, e = w.shape
    return out.reshape(*out.shape[:2], h * d) @ w.to(out.dtype).reshape(
        h * d, e)


def gqa_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, return_cache: bool = False,
              kernel: bool = True):
    """x [B,S,E] -> [B,S,E] (+ optional KV cache entries)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = attention_core(q, k, v, cfg, causal=causal, window=window,
                         kernel=kernel)
    y = _out_project(out, p["wo"])
    if return_cache:
        return y, KVCacheEntry(k=k, v=v)
    return y


def decode_slot(pos: int, s_cache: int, window: Optional[int] = None
                ) -> int:
    """The slot of a cache of ``s_cache`` positions that a decode step at
    ``pos`` writes: ``pos % s_cache`` once a sliding window fills the
    cache (a ring buffer), else ``pos``; a position past the cache writes
    the last slot, as JAX's ``dynamic_update_slice`` clamps."""
    if window is not None and s_cache >= window:
        return pos % s_cache
    return min(pos, s_cache - 1)


def decode_scores(raw: torch.Tensor, head_dim: int, kpos: torch.Tensor,
                  pos: int) -> torch.Tensor:
    """A decode step's scores: the q.k products ``raw`` [..., S] scaled
    by 1/sqrt(head_dim), the slots ``kpos`` [S] past ``pos`` masked.  A
    full cache: slots > pos are future positions; a ring buffer: every
    written slot is in the window, and kpos <= pos masks the slots not
    yet written during warm-up."""
    scores = raw * (1.0 / math.sqrt(head_dim))
    return torch.where(kpos <= pos, scores, torch.full_like(scores, NEG_INF))


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: KVCacheEntry, pos: int, *,
               window: Optional[int] = None):
    """One-token decode. x [B,1,E]; cache k/v [B,S,K,D]; pos an int.

    The new KV is written at ``pos`` (``pos % S`` once a sliding window
    fills the cache: a ring buffer), in place; the returned entry holds
    the same tensors.  A position past the cache writes the last slot,
    as JAX's ``dynamic_update_slice`` clamps.
    """
    dt = x.dtype
    b = x.shape[0]
    pos = int(pos)
    q = _project(x, p["wq"])
    k_new = _project(x, p["wk"])
    v_new = _project(x, p["wv"])
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k_new = L.rmsnorm(p["k_norm"], k_new, cfg.norm_eps)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k_new = L.apply_rope(k_new, posb, cfg.rope_theta)

    s_cache = cache.k.shape[1]
    write_at = decode_slot(pos, s_cache, window)
    cache.k[:, write_at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, write_at] = v_new[:, 0].to(cache.v.dtype)

    # grouped heads against the cache, KV never repeated to H heads
    h = q.shape[2]
    kh = cache.k.shape[2]
    g = h // kh
    qg = q.reshape(b, 1, kh, g, q.shape[-1])
    scores = decode_scores(
        torch.einsum("bskgd,btkd->bkgst", qg.float(), cache.k.float()),
        q.shape[-1], torch.arange(s_cache, device=x.device), pos)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cache.v.to(dt))
    out = out.reshape(b, 1, h, q.shape[-1])
    return _out_project(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_q(p, cfg: ModelConfig, x, positions):
    if cfg.q_lora_rank:
        cq = x @ p["wq_a"].to(x.dtype)
        cq = L.rmsnorm(p["q_norm"], cq, cfg.norm_eps)
        q = _project(cq, p["wq_b"])
    else:
        q = _project(x, p["wq"])
    nope = cfg.qk_nope_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x, positions):
    """x [B,S,E] -> (normed latent [B,S,R], roped key [B,S,1,P])."""
    ckv = x @ p["wkv_a"].to(x.dtype)
    r = cfg.kv_lora_rank
    c_kv = L.rmsnorm(p["kv_norm"], ckv[..., :r], cfg.norm_eps)
    k_rope = L.apply_rope(ckv[..., r:][:, :, None, :], positions,
                          cfg.rope_theta)
    return c_kv, k_rope


def mla_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              return_cache: bool = False, kernel: bool = True):
    """MLA prefill / train: the latent expanded to per-head K/V.  x [B,S,E] ->
    [B,S,E] (+ the latent cache entry: latent [B,S,R], rope key
    [B,S,P])."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = _project(c_kv, p["wk_b"])
    v = _project(c_kv, p["wv_b"])
    h = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope.expand(-1, -1, h, -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_core(q, k, v, cfg, causal=causal, kernel=kernel)
    y = _out_project(out, p["wo"])
    if return_cache:
        return y, KVCacheEntry(k=c_kv, v=k_rope[:, :, 0, :])
    return y


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: KVCacheEntry, pos: int):
    """Weight-absorbed MLA decode (DeepSeek-V2 style).  x [B,1,E]; cache
    latent [B,S,R] + rope key [B,S,P]; pos an int.

    The new latent and rope key are written at ``pos`` in place (a
    position past the cache writes the last slot, as JAX's
    ``dynamic_update_slice`` clamps).  Queries are absorbed into the
    latent space, so decode attends MQA-style over the latent.
    """
    dt = x.dtype
    b = x.shape[0]
    pos = int(pos)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, posb)
    c_new, kr_new = _mla_latent(p, cfg, x, posb)

    s_cache = cache.k.shape[1]
    write_at = decode_slot(pos, s_cache)
    cache.k[:, write_at] = c_new[:, 0].to(cache.k.dtype)
    cache.v[:, write_at] = kr_new[:, 0, 0].to(cache.v.dtype)

    # absorb: latent-space queries q_nope @ wk_b^T [B,1,H,R]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["wk_b"].to(dt))
    c_all = cache.k.float()
    s_nope = torch.einsum("bshr,btr->bhst", q_lat.float(), c_all)
    s_rope = torch.einsum("bshp,btp->bhst", q_rope.float(),
                          cache.v.float())
    scores = decode_scores(s_nope + s_rope,
                           cfg.qk_nope_dim + cfg.qk_rope_dim,
                           torch.arange(s_cache, device=x.device), pos)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs, c_all)
    out = torch.einsum("bshr,rhd->bshd", o_lat.to(dt), p["wv_b"].to(dt))
    return _out_project(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ModelConfig,
                         n: int | None = None, dtype=torch.float32) -> dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    kw = dict(n=n, dtype=dtype)
    heads = ("embed", "heads", "head_dim")
    return {
        "wq": L.dense_init(gen, (d, h, hd), heads, fan_in=d, **kw),
        "wk": L.dense_init(gen, (d, h, hd), heads, fan_in=d, **kw),
        "wv": L.dense_init(gen, (d, h, hd), heads, fan_in=d, **kw),
        "wo": L.dense_init(gen, (h, hd, d), ("heads", "head_dim", "embed"),
                           fan_in=h * hd, **kw),
    }


def cross_attention_kv(p: dict, enc_out: torch.Tensor) -> KVCacheEntry:
    """enc_out [B,T,E] -> the cross cache entry, k/v [B,T,H,D] in
    enc_out's dtype."""
    return KVCacheEntry(k=_project(enc_out, p["wk"]),
                        v=_project(enc_out, p["wv"]))


def cross_attention_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                          kv: KVCacheEntry, kernel: bool = True
                          ) -> torch.Tensor:
    """x [B,S,E] attends over every row of kv (no mask) -> [B,S,E]."""
    q = _project(x, p["wq"])
    out = attention_core(q, kv.k, kv.v, cfg, causal=False, kernel=kernel)
    return _out_project(out, p["wo"])
