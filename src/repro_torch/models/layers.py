"""Core building blocks: initializers, norms, embeddings, RoPE, MLPs,
the LM loss.

The port of ``repro.models.layers``.  Parameters are plain tensors in
nested dicts (the JAX package's unboxed tree, same keys), in the
config's ``param_dtype`` (fp32 by default); apply-side functions cast
them to the compute dtype (``cfg.dtype``, bf16 by default) at use, as
the JAX package does.  Initializers draw from an explicit
``torch.Generator`` in fp32 and cast to ``dtype``, creating the tensor
on the generator's device; ``n`` stacks ``n`` layers' draws on a leading
"layers" axis, allocated in ``dtype`` and filled a layer at a time, so a
bf16 stack never holds more than one layer's fp32 draw.

Each initializer takes its leaf's logical axes at the call site, as the
JAX package's do; a stack of ``n`` gains a leading "layers" axis.  They
are used only under :func:`abstract` (the counterpart of
``jax.eval_shape`` over an initializer), where every initializer returns
a ``Param`` box around an empty tensor on the meta device and draws
nothing; otherwise it returns the plain tensor.
"""
from __future__ import annotations

import contextvars
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.sharding.partition import Param


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype field) or a
    torch dtype -> the torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# Param creation
# ---------------------------------------------------------------------------

_ABSTRACT = contextvars.ContextVar("repro_torch_abstract_init",
                                   default=False)


def abstract(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every initializer returning a
    ``Param`` box of an empty meta tensor (its shape, dtype and logical
    axes) instead of a drawn one: the boxed tree of an ``api.init`` or
    ``api.init_cache``, allocated nowhere."""
    token = _ABSTRACT.set(True)
    try:
        return fn(*args, **kwargs)
    finally:
        _ABSTRACT.reset(token)


def _box(shape, axes, n, dtype):
    """Under :func:`abstract`, the box of a leaf (stacked over ``n``
    layers if given); else None."""
    if not _ABSTRACT.get():
        return None
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} for a leaf of shape "
                         f"{tuple(shape)}")
    lead, lead_axes = ((), ()) if n is None else ((n,), ("layers",))
    return Param(torch.empty(lead + tuple(shape), dtype=torch_dtype(dtype),
                             device="meta"), lead_axes + tuple(axes))


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def _scaled_normal(gen: torch.Generator, shape, std: float, dtype,
                   n: int | None) -> torch.Tensor:
    dtype = torch_dtype(dtype)
    if n is None:
        return _normal(gen, shape).mul_(std).to(dtype)
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=gen.device)
    for j in range(n):
        out[j] = _normal(gen, shape).mul_(std)
    return out


def dense_init(gen: torch.Generator, shape: Sequence[int],
               axes: Sequence[str | None], fan_in: int | None = None,
               scale: float = 1.0, n: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Scaled-normal (LeCun-ish) init for a dense kernel: std = scale /
    sqrt(fan_in), fan_in = shape[0] unless given."""
    box = _box(shape, axes, n, dtype)
    if box is not None:
        return box
    if fan_in is None:
        fan_in = shape[0]
    std = scale / math.sqrt(max(fan_in, 1))
    return _scaled_normal(gen, shape, std, dtype, n)


def embed_init(gen: torch.Generator, shape, axes, scale: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    box = _box(shape, axes, None, dtype)
    if box is not None:
        return box
    return _scaled_normal(gen, shape, scale, dtype, None)


def ones_init(shape, axes, device, n: int | None = None,
              dtype=torch.float32) -> torch.Tensor:
    box = _box(shape, axes, n, dtype)
    if box is not None:
        return box
    lead = () if n is None else (n,)
    return torch.ones(lead + tuple(shape), device=device,
                      dtype=torch_dtype(dtype))


def zeros_init(shape, axes, device, n: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    box = _box(shape, axes, n, dtype)
    if box is not None:
        return box
    lead = () if n is None else (n,)
    return torch.zeros(lead + tuple(shape), device=device,
                       dtype=torch_dtype(dtype))


def const_init(value: torch.Tensor, axes, n: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """``value`` in ``dtype`` (repeated over ``n`` layers if given)."""
    box = _box(value.shape, axes, n, dtype)
    if box is not None:
        return box
    value = value.to(torch_dtype(dtype))
    return value if n is None else value.expand(n, *value.shape).clone()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    return embed_init(gen, (vocab, d), ("vocab", "embed"),
                      scale=1.0 / math.sqrt(d), dtype=dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype
                 ) -> torch.Tensor:
    """[V, D] x [..., S] -> [..., S, D] in ``dtype``."""
    return table[tokens.long()].to(torch_dtype(dtype))


def unembed_logits(table: torch.Tensor, x: torch.Tensor, dtype
                   ) -> torch.Tensor:
    """[..., S, D] x [V, D] -> [..., S, V]: the table cast to x's dtype,
    products accumulated in fp32 (the JAX ``preferred_element_type``)."""
    w = table.to(x.dtype).float()
    return (x.float() @ w.T).to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int).  The two halves of the
    head dim are the rotated pairs."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [D/2]
    angles = positions[..., None].float() * freqs                # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Feed-forward (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, n: int | None = None,
             dtype=torch.float32) -> dict:
    return {
        "wi_gate": dense_init(gen, (d, f), ("embed", "mlp"), fan_in=d, n=n,
                              dtype=dtype),
        "wi_up": dense_init(gen, (d, f), ("embed", "mlp"), fan_in=d, n=n,
                            dtype=dtype),
        "wo": dense_init(gen, (f, d), ("mlp", "embed"), fan_in=f, n=n,
                         dtype=dtype),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = x @ p["wi_gate"].to(dt)
    up = x @ p["wi_up"].to(dt)
    return (F.silu(gate) * up) @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits [B,S,V], labels [B,S] int -> the mean NLL in fp32, over the
    positions ``mask`` [B,S] keeps (denominator at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.take_along_dim(
        logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = logz - label_logits
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
