"""Decoder-only LM: blocks, layers, caches — the port of
``repro.models.transformer``.

Layer heterogeneity (attention/Mamba patterns) is grouped into
*super-blocks* of ``period`` distinct sub-layers, as in the JAX package;
each sub-layer position ``pos{i}`` holds its parameters stacked on a
leading "layers" axis of ``n_super = num_layers / period``.  The JAX
package runs the super-blocks with ``lax.scan``; here they run as a
Python loop over that axis.  Caches are stacked the same way:
``{"pos{i}": KVCacheEntry | SSMState}`` with leaves ``[n_super, ...]``.
Attention layers run GQA or MLA (``cfg.attention_kind``), FFNs an MLP or
a routed MoE (``BlockSpec.is_moe``); prefill and decode discard the MoE
aux loss, as the reference's do.  A config with a frontend
(``vision_stub`` / ``audio_stub``) has a ``projector`` MLP: prefill and
the loss project ``batch["frontend_embeds"]`` [B, T, d_model] with it and
prepend them to the token embeddings.

Training: ``lm_loss`` runs the layers through ``_scan_blocks`` (a loop
over the super-blocks; ``cfg.remat == "full"`` recomputes each in the
backward, as ``jax.checkpoint`` does) on the plain attention and scan
branches (``kernel=False``), as the JAX model does: the flash and SSD
kernels have no backward.  It returns the cross-entropy plus the MoE aux
loss, and the metrics ``loss``, ``aux_loss`` and ``perplexity``.
"""
from __future__ import annotations

import contextvars
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partition as P


# ---------------------------------------------------------------------------
# Super-block structure
# ---------------------------------------------------------------------------

class BlockSpec(NamedTuple):
    kind: str      # "A" | "M"
    is_moe: bool
    has_ffn: bool


def superblock_period(cfg: ModelConfig) -> int:
    pat = 1 if cfg.layer_pattern is None else len(cfg.layer_pattern)
    moe = cfg.moe_layer_period if cfg.num_experts else 1
    period = pat * moe // math.gcd(pat, moe)
    if cfg.num_layers % period:
        return cfg.num_layers  # no clean repeat: one unrolled super-block
    return period


def block_specs(cfg: ModelConfig) -> list[BlockSpec]:
    """Specs for the sub-layers of one super-block (length == period)."""
    period = superblock_period(cfg)
    pattern = cfg.pattern
    return [BlockSpec(kind=pattern[i], is_moe=cfg.is_moe_layer(i),
                      has_ffn=cfg.d_ff > 0) for i in range(period)]


def _n_super(cfg: ModelConfig, specs) -> int:
    return cfg.num_layers // len(specs)


def _unstack(tree, n: int) -> list:
    """The n layers of a "layers"-stacked tree of tensors, each leaf
    ``unbind`` once: their gradients come back stacked in one write,
    where a slice a layer would add a zero-filled stack's worth each."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[j] for k, v in subs.items()} for j in range(n)]
    return list(tree.unbind(0))


def _layer(tree, j: int):
    """Layer j of a "layers"-stacked tree (dicts and NamedTuples)."""
    if isinstance(tree, dict):
        return {k: _layer(v, j) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*[_layer(v, j) for v in tree])
    return tree[j]


# ---------------------------------------------------------------------------
# Sub-layer init / apply
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               n: int | None = None) -> dict:
    """One sub-layer's parameters (stacked over ``n`` layers if given), in
    ``cfg.param_dtype``."""
    dev = gen.device
    kw = dict(n=n, dtype=L.torch_dtype(cfg.param_dtype))
    p: dict = {"norm1": L.ones_init((cfg.d_model,), ("embed",), dev, **kw)}
    if spec.kind == "A":
        p["attn"] = A.init_attention(gen, cfg, **kw)
    else:
        p["mamba"] = S.init_mamba(gen, cfg, **kw)
    if spec.has_ffn:
        p["norm2"] = L.ones_init((cfg.d_model,), ("embed",), dev, **kw)
        if spec.is_moe:
            p["moe"] = M.init_moe(gen, cfg, **kw)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)
    return p


def _attn_window(cfg: ModelConfig) -> Optional[int]:
    if cfg.family == "hybrid":
        return cfg.hybrid_attn_window
    return cfg.sliding_window


def _ffn(p: dict, cfg: ModelConfig, spec: BlockSpec, x):
    """The sub-layer's FFN on the residual x.  Returns (x, the MoE aux
    loss: a fp32 scalar, None without MoE)."""
    aux = None
    if spec.has_ffn:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        if spec.is_moe:
            ffn, aux = M.moe_apply(p["moe"], cfg, h)
        else:
            ffn = L.mlp_apply(p["mlp"], h)
        x = x + ffn
    return x, aux


def block_apply(p: dict, cfg: ModelConfig, spec: BlockSpec, x, positions,
                causal: bool = True, kernel: bool = True):
    """One sub-layer (mixer + optional FFN). Returns (x, aux_loss)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "A":
        if cfg.attention_kind == "mla":
            mix = A.mla_apply(p["attn"], cfg, h, positions, causal=causal,
                              kernel=kernel)
        else:
            mix = A.gqa_apply(p["attn"], cfg, h, positions, causal=causal,
                              window=_attn_window(cfg), kernel=kernel)
    else:
        mix = S.mamba_apply(p["mamba"], cfg, h, kernel=kernel)
    x, aux = _ffn(p, cfg, spec, x + mix)
    return x, torch.zeros((), device=x.device) if aux is None else aux


def block_apply_prefill(p: dict, cfg: ModelConfig, spec: BlockSpec, x,
                        positions):
    """Forward + cache construction (prefill). Returns (x, cache_entry)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "A":
        if cfg.attention_kind == "mla":
            mix, entry = A.mla_apply(p["attn"], cfg, h, positions,
                                     causal=True, return_cache=True)
        else:
            mix, entry = A.gqa_apply(p["attn"], cfg, h, positions,
                                     causal=True, window=_attn_window(cfg),
                                     return_cache=True)
    else:
        mix, entry = S.mamba_apply(p["mamba"], cfg, h, return_state=True)
    return _ffn(p, cfg, spec, x + mix)[0], entry


def block_apply_cached(p: dict, cfg: ModelConfig, spec: BlockSpec, x, cache,
                       pos):
    """Decode step for one sub-layer against its cache entry."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "A":
        if cfg.attention_kind == "mla":
            mix, new_cache = A.mla_decode(p["attn"], cfg, h, cache, pos)
        else:
            mix, new_cache = A.gqa_decode(p["attn"], cfg, h, cache, pos,
                                          window=_attn_window(cfg))
    else:
        mix, new_cache = S.mamba_decode(p["mamba"], cfg, h, cache)
    return _ffn(p, cfg, spec, x + mix)[0], new_cache


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Seeded parameters on ``gen``'s device, in ``cfg.param_dtype``, in
    the JAX package's unboxed tree layout, drawn in its order (the
    projector last)."""
    pdt = L.torch_dtype(cfg.param_dtype)
    specs = block_specs(cfg)
    n_super = _n_super(cfg, specs)
    params: dict = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, pdt),
        "final_norm": L.ones_init((cfg.d_model,), ("embed",), gen.device,
                                  dtype=pdt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(
            gen, (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            scale=1.0 / math.sqrt(cfg.d_model), dtype=pdt)
    params["blocks"] = {f"pos{i}": init_block(gen, cfg, spec, n=n_super)
                        for i, spec in enumerate(specs)}
    if cfg.frontend in ("vision_stub", "audio_stub"):
        params["projector"] = L.init_mlp(gen, cfg.d_model, cfg.d_model * 2,
                                         dtype=pdt)
    return params


def _leaf_tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # an ml_dtypes bfloat16 array: its bits, reinterpreted
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def lm_params_from_numpy(tree, device) -> dict:
    """The JAX package's unboxed ``init_lm`` tree (numpy arrays: ``embed``,
    ``final_norm``, optional ``unembed`` and ``projector``,
    ``blocks/pos{i}/...`` stacked on a leading layers axis; float32 or
    ``ml_dtypes`` bfloat16) as the port's parameters on ``device``, in the
    same dtypes.  Any dict tree of arrays carries across alike: the
    ``init_encdec`` tree too."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_tensor(tree, device)


def _logits(params, cfg: ModelConfig, x):
    x = L.rmsnorm(P.whole(params["final_norm"]), x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_logits(P.whole(table), x, cfg.logits_dtype)


def _embed(params, cfg: ModelConfig, batch: dict):
    """Token embeddings in ``cfg.dtype``, after a frontend's projected
    ``frontend_embeds``; returns (x [B,S',E], positions [B,S'])."""
    dt = L.torch_dtype(cfg.dtype)
    x = L.embed_lookup(P.whole(params["embed"]), batch["tokens"], dt)
    if cfg.frontend is not None:
        fe = L.mlp_apply(P.whole_tree(params["projector"]),
                         batch["frontend_embeds"].to(dt))
        x = torch.cat([fe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def remat(cfg: ModelConfig, body):
    """``body`` recomputed in the backward when ``cfg.remat == "full"``
    (``jax.checkpoint``): the same numbers, less memory.  The recompute
    runs in the context variables of the first call (the ambient mesh,
    ``sharding.row_shard``, ``moe.count_drops``): the autograd engine
    runs the backward of CUDA tensors on a thread of its own, which does
    not see the caller's."""
    if cfg.remat != "full":
        return body

    def run(*args):
        ctx = contextvars.copy_context()
        return checkpoint(ctx.run, body, *args, use_reentrant=False)
    return run


def _scan_blocks(params, cfg: ModelConfig, x, positions, causal=True):
    """All layers, a super-block at a time, on the plain attention and
    scan branches.  Partitioned leaves (``sharding.Blocked``) are
    gathered a super-block at a time, inside the recomputed body, so a
    rank holds one super-block's parameters whole at once.  Returns (x,
    the summed MoE aux loss)."""
    specs = block_specs(cfg)

    def body(x, aux, layer):
        layer = P.whole_tree(layer)
        for i, spec in enumerate(specs):
            x, a = block_apply(layer[f"pos{i}"], cfg, spec, x, positions,
                               causal=causal, kernel=False)
            aux = aux + a
        return x, aux

    body = remat(cfg, body)
    aux = torch.zeros((), device=x.device)
    for layer in _unstack(params["blocks"], _n_super(cfg, specs)):
        x, aux = body(x, aux, layer)
    return x, aux


def lm_loss(params, cfg: ModelConfig, batch: dict):
    """batch: tokens [B,S] int, labels [B,S] int, loss_mask [B,S]; with a
    frontend also frontend_embeds [B,T,d_model], projected and prepended
    (the loss covers the token positions only).  Returns (loss + MoE aux
    loss, {"loss", "aux_loss", "perplexity"})."""
    x, positions = _embed(params, cfg, batch)
    x, aux = _scan_blocks(params, cfg, x, positions)
    logits = _logits(params, cfg, x[:, -batch["tokens"].shape[1]:, :])
    loss = L.softmax_cross_entropy(logits, batch["labels"],
                                   batch.get("loss_mask"))
    return loss + aux, {"loss": loss, "aux_loss": aux,
                        "perplexity": torch.exp(loss.clamp_max(20.0))}


def lm_prefill(params, cfg: ModelConfig, batch: dict):
    """Forward pass building the cache. batch["tokens"] [B,S] int; with a
    frontend also batch["frontend_embeds"] [B,T,d_model], projected in
    ``cfg.dtype`` and prepended (the cache then holds T + S rows).
    Partitioned leaves (``sharding.Blocked``) are gathered a super-block
    at a time.  Returns (last-position logits [B,1,V], cache)."""
    x, positions = _embed(params, cfg, batch)
    specs = block_specs(cfg)
    entries: dict = {f"pos{i}": [] for i in range(len(specs))}
    for j in range(_n_super(cfg, specs)):
        layer = P.whole_tree(_layer(params["blocks"], j))
        for i, spec in enumerate(specs):
            x, entry = block_apply_prefill(layer[f"pos{i}"], cfg, spec, x,
                                           positions)
            entries[f"pos{i}"].append(entry)
    cache = {k: type(v[0])(*[torch.stack(xs) for xs in zip(*v)])
             for k, v in entries.items()}
    return _logits(params, cfg, x[:, -1:, :]), cache


def lm_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step. token [B,1] int; pos an int (the new token's
    position).

    cache: {"pos{i}": stacked entry [n_super, ...]} as produced by
    lm_prefill / init_cache.  The cache is updated in place and returned
    (the JAX engine donates it); returns (logits [B,1,V], cache).
    """
    dt = L.torch_dtype(cfg.dtype)
    x = L.embed_lookup(params["embed"], token, dt)
    specs = block_specs(cfg)
    for j in range(_n_super(cfg, specs)):
        layer = _layer(params["blocks"], j)
        for i, spec in enumerate(specs):
            entry = _layer(cache[f"pos{i}"], j)
            x, new = block_apply_cached(layer[f"pos{i}"], cfg, spec, x,
                                        entry, pos)
            for old, upd in zip(entry, new):
                if upd.data_ptr() != old.data_ptr():
                    old.copy_(upd)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int,
               device=None):
    """Zero cache for decode.

    Attention layers get [n_super, B, S_kv, K, D] KV entries (S_kv bounded
    by the sliding window for SWA archs); MLA layers the latent
    [n_super, B, S_kv, R] and rope key [n_super, B, S_kv, P]; Mamba layers
    get SSM states (the SSD state in fp32).
    """
    dt = L.torch_dtype(cfg.dtype)
    specs = block_specs(cfg)
    n_super = _n_super(cfg, specs)
    window = _attn_window(cfg)
    s_kv = seq_len if window is None else min(seq_len, window)
    cache = {}
    for i, spec in enumerate(specs):
        if spec.kind == "A" and cfg.attention_kind == "mla":
            lead = (n_super, batch_size, s_kv)
            axes = ("layers", "cache_batch", "kv_seq", "lora")
            entry = A.KVCacheEntry(
                k=L.zeros_init(lead + (cfg.kv_lora_rank,), axes, device,
                               dtype=dt),
                v=L.zeros_init(lead + (cfg.qk_rope_dim,), axes, device,
                               dtype=dt))
        elif spec.kind == "A":
            shape = (n_super, batch_size, s_kv, cfg.num_kv_heads,
                     cfg.head_dim)
            axes = ("layers", "cache_batch", "kv_seq", "kv_heads",
                    "head_dim")
            entry = A.KVCacheEntry(k=L.zeros_init(shape, axes, device,
                                                  dtype=dt),
                                   v=L.zeros_init(shape, axes, device,
                                                  dtype=dt))
        else:
            entry = S.SSMState(
                conv=L.zeros_init(
                    (n_super, batch_size, cfg.ssm_conv_width - 1,
                     cfg.d_inner + 2 * cfg.ssm_state_dim),
                    ("layers", "cache_batch", None, "mlp"), device,
                    dtype=dt),
                ssd=L.zeros_init(
                    (n_super, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state_dim),
                    ("layers", "cache_batch", "ssm_heads", None,
                     "ssm_state"), device))
        cache[f"pos{i}"] = entry
    return cache
