"""Encoder-decoder transformer (the seamless-m4t backbone), the port of
``repro.models.encdec``.

The speech frontend is a stub: ``frontend_embeds`` [B, T_src, d_model]
arrive precomputed (fbank-frame embeddings); a learned projector maps them
into the encoder.  Encoder layers are non-causal self-attention -> FFN
(their self-attention runs the flash kernel with ``causal=False``);
decoder layers are causal self-attention -> cross-attention -> FFN.
Prefill returns the decoder's self-attention KV cache and each layer's
cross K/V, computed once from the encoder's output; decode carries both,
writing the self-attention entry in place (as ``lm_decode_step`` does)
and reading the cross entry as it is.

Parameters are the JAX package's unboxed ``init_encdec`` tree, stacked on
a leading layers axis (``enc_blocks`` / ``dec_blocks``); the layers run as
a Python loop where the JAX package scans.  Caches are
``{"self": KVCacheEntry, "cross": KVCacheEntry}`` with leaves
``[num_layers, B, ...]``.

Training: ``encdec_loss`` runs the encoder and the decoder on the plain
attention branches (``kernel=False``, as the JAX model does: the flash
kernel has no backward), each layer recomputed in the backward when
``cfg.remat == "full"``, and returns the cross-entropy with the metrics
``loss`` and ``perplexity``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _layer, _logits, _unstack, remat
from repro_torch.sharding import partition as P


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, n: int,
                    pdt) -> dict:
    kw = dict(n=n, dtype=pdt)
    return {
        "norm1": L.ones_init((cfg.d_model,), ("embed",), gen.device, **kw),
        "attn": A.init_attention(gen, cfg, **kw),
        "norm2": L.ones_init((cfg.d_model,), ("embed",), gen.device, **kw),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, n: int,
                    pdt) -> dict:
    kw = dict(n=n, dtype=pdt)
    return {
        "norm1": L.ones_init((cfg.d_model,), ("embed",), gen.device, **kw),
        "self_attn": A.init_attention(gen, cfg, **kw),
        "norm_x": L.ones_init((cfg.d_model,), ("embed",), gen.device, **kw),
        "cross_attn": A.init_cross_attention(gen, cfg, **kw),
        "norm2": L.ones_init((cfg.d_model,), ("embed",), gen.device, **kw),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Seeded parameters on ``gen``'s device, in ``cfg.param_dtype``, in
    the JAX package's unboxed tree layout, drawn in its order."""
    pdt = L.torch_dtype(cfg.param_dtype)
    dev = gen.device
    return {
        "projector": L.init_mlp(gen, cfg.d_model, cfg.d_model * 2,
                                dtype=pdt),
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, pdt),
        "enc_blocks": _init_enc_block(gen, cfg, cfg.num_encoder_layers, pdt),
        "enc_norm": L.ones_init((cfg.d_model,), ("embed",), dev, dtype=pdt),
        "dec_blocks": _init_dec_block(gen, cfg, cfg.num_layers, pdt),
        "final_norm": L.ones_init((cfg.d_model,), ("embed",), dev,
                                  dtype=pdt),
        "unembed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"),
                                scale=1.0 / math.sqrt(cfg.d_model),
                                dtype=pdt),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        b, s)


def encode(params, cfg: ModelConfig, frontend_embeds: torch.Tensor,
           kernel: bool = True) -> torch.Tensor:
    """frontend_embeds [B,T,d_model] -> the encoder's output [B,T,d_model]
    in ``cfg.dtype``.  ``kernel=False``: the plain attention branches."""
    x = L.mlp_apply(P.whole_tree(params["projector"]),
                    frontend_embeds.to(L.torch_dtype(cfg.dtype)))
    positions = _positions(x)

    def body(x, p):
        p = P.whole_tree(p)
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        x = x + A.gqa_apply(p["attn"], cfg, h, positions, causal=False,
                            kernel=kernel)
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        return x + L.mlp_apply(p["mlp"], h2)

    body = remat(cfg, body)
    for p in _unstack(params["enc_blocks"], cfg.num_encoder_layers):
        x = body(x, p)
    return L.rmsnorm(P.whole(params["enc_norm"]), x, cfg.norm_eps)


def _dec_block(p: dict, cfg: ModelConfig, x, positions, enc_out,
               kernel: bool = True):
    """One decoder layer over the whole prompt.  Returns (x, its cache
    entry {"self": KVCacheEntry, "cross": KVCacheEntry})."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, entry = A.gqa_apply(p["self_attn"], cfg, h, positions, causal=True,
                             return_cache=True, kernel=kernel)
    x = x + mix
    hx = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    kv = A.cross_attention_kv(p["cross_attn"], enc_out)
    x = x + A.cross_attention_apply(p["cross_attn"], cfg, hx, kv,
                                    kernel=kernel)
    h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h2)
    return x, {"self": entry, "cross": kv}


def encdec_loss(params, cfg: ModelConfig, batch: dict):
    """batch: frontend_embeds [B,T_src,d_model], tokens [B,S], labels,
    loss_mask.  Returns (loss, {"loss", "perplexity"})."""
    enc_out = encode(params, cfg, batch["frontend_embeds"], kernel=False)
    x = L.embed_lookup(P.whole(params["embed"]), batch["tokens"],
                       L.torch_dtype(cfg.dtype))
    positions = _positions(x)

    def body(x, p):
        return _dec_block(P.whole_tree(p), cfg, x, positions, enc_out,
                          kernel=False)[0]

    body = remat(cfg, body)
    for p in _unstack(params["dec_blocks"], cfg.num_layers):
        x = body(x, p)
    logits = _logits(params, cfg, x)
    loss = L.softmax_cross_entropy(logits, batch["labels"],
                                   batch.get("loss_mask"))
    return loss, {"loss": loss,
                  "perplexity": torch.exp(loss.clamp_max(20.0))}


def encdec_prefill(params, cfg: ModelConfig, batch: dict):
    """Encode batch["frontend_embeds"] [B,T,d_model], run the decoder over
    batch["tokens"] [B,S].  Returns (last-position logits [B,1,V], cache):
    the self-attention KV [n, B, S, K, D] and the cross K/V
    [n, B, T, H, D]."""
    enc_out = encode(params, cfg, batch["frontend_embeds"])
    x = L.embed_lookup(P.whole(params["embed"]), batch["tokens"],
                       L.torch_dtype(cfg.dtype))
    positions = _positions(x)
    entries = []
    for j in range(cfg.num_layers):
        x, entry = _dec_block(P.whole_tree(_layer(params["dec_blocks"], j)),
                              cfg, x, positions, enc_out)
        entries.append(entry)
    cache = {key: A.KVCacheEntry(*[torch.stack(xs) for xs in zip(
        *[e[key] for e in entries])]) for key in ("self", "cross")}
    return _logits(params, cfg, x[:, -1:, :]), cache


def encdec_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step. token [B,1] int; pos an int.  The self-attention
    cache is written in place and the cache returned (the JAX engine
    donates it); the cross cache is read as it is, every row of it
    attended (no mask).  Returns (logits [B,1,V], cache)."""
    x = L.embed_lookup(params["embed"], token, L.torch_dtype(cfg.dtype))
    for j in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], j)
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        # gqa_decode writes the new K/V into the layer's view in place
        mix, _ = A.gqa_decode(p["self_attn"], cfg, h,
                              _layer(cache["self"], j), pos)
        x = x + mix
        hx = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
        x = x + A.cross_attention_apply(p["cross_attn"], cfg, hx,
                                        _layer(cache["cross"], j))
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h2)
    return _logits(params, cfg, x), cache


def init_encdec_cache(cfg: ModelConfig, batch_size: int, seq_len: int,
                      src_len: int, device=None):
    """Zero cache for decode: the decoder's self-attention KV
    [n, B, seq_len, K, D] and the cross K/V [n, B, src_len, H, D], in
    ``cfg.dtype``."""
    dt = L.torch_dtype(cfg.dtype)
    n = cfg.num_layers
    kv = (n, batch_size, seq_len, cfg.num_kv_heads, cfg.head_dim)
    cross = (n, batch_size, src_len, cfg.num_heads, cfg.head_dim)

    kv_axes = ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim")
    cross_axes = ("layers", "cache_batch", None, "heads", "head_dim")

    def zeros(shape, axes):
        return L.zeros_init(shape, axes, device, dtype=dt)

    return {"self": A.KVCacheEntry(k=zeros(kv, kv_axes),
                                   v=zeros(kv, kv_axes)),
            "cross": A.KVCacheEntry(k=zeros(cross, cross_axes),
                                    v=zeros(cross, cross_axes))}
