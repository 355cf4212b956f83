"""Gradient compression with error feedback, the port of
``repro.train.compression``.

* ``bf16``     — the train step casts the gradients to bf16 (half the
                 bytes of every gradient all-reduce) and Adam casts them
                 back.
* ``int8_ef``  — per-tensor-scaled int8 quantization with an error-feedback
                 residual carried in the train state (1-bit-SGD/EF-SGD
                 lineage), applied to the gradient tree before the
                 optimizer.  The quantize -> dequantize round trip is what
                 a wire transfer would carry; the residual is added back
                 the next step, so the applied updates sum to the true
                 gradients.

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.train.checkpoint import (_flatten_with_names, tree_leaves,
                                          tree_map)


def ef_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None):
    """Symmetric per-tensor int8. Returns (q, scale).  ``amax``: the
    tensor's max |x|, where ``x`` is one shard of it (the max over every
    shard); by default ``x``'s own."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().max() if amax is None else amax, 1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_int8_ef(grads, ef_state, reduce_amax=None):
    """Error-feedback int8 compression of a grad tree.  Returns
    (decompressed grads, new ef_state).  Where the leaves are shards,
    ``reduce_amax`` maps the list of each leaf's local max |g + e| to the
    max over all its shards, so that the scale is per tensor."""

    def one(g, e, amax=None):
        gf = g.float() + e
        deq = dequantize_int8(*quantize_int8(gf, amax))
        return deq, gf - deq

    _, flat_g, unflatten = _flatten_with_names(grads)
    flat_e = tree_leaves(ef_state)
    amaxes = [None] * len(flat_g)
    if reduce_amax is not None:
        amaxes = reduce_amax([(g.float() + e).abs().max()
                              for g, e in zip(flat_g, flat_e)])
    outs = [one(g, e, a) for g, e, a in zip(flat_g, flat_e, amaxes)]
    return (unflatten([o[0] for o in outs]),
            unflatten([o[1] for o in outs]))
