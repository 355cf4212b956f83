"""AdamW and the learning-rate schedule, the port of
``repro.train.optimizer``.

The optimizer state mirrors the parameter tree: first and second moments
in fp32 and a 0-d int32 step.  Every scalar the reference computes in
float32 (``b1 ** step``, the bias corrections, the cosine, the learning
rate) is a float32 tensor here too, and the global gradient norm folds
the leaves in the JAX package's order (dict keys sorted).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.train.checkpoint import (_flatten_with_names, tree_leaves,
                                          tree_map)


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any             # first moment  (tree like params, fp32)
    nu: Any             # second moment (tree like params, fp32)


def adamw_init(params) -> OptState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 grad_clip_norm: float | None = 1.0, gnorm=None):
    """Returns (new_params, new_state, {"grad_norm"}).  Gradients are
    clipped to ``grad_clip_norm`` by their global norm; decoupled weight
    decay goes on every leaf with ndim >= 2 (the stacked norm scales
    [layers, d] too, as in the reference).  ``gnorm``: the global norm,
    where the leaves are shards (the caller sums each leaf's squares
    over its shards); by default the norm of ``grads``."""
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
    if grad_clip_norm is not None:
        scale = torch.clamp_max(gnorm.new_tensor(grad_clip_norm)
                                / torch.clamp_min(gnorm, 1e-9), 1.0)
    else:
        scale = gnorm.new_tensor(1.0)

    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if p.ndim >= 2:
            delta = delta + weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new, v_new

    _, flat_p, unflatten = _flatten_with_names(params)
    results = [upd(*xs) for xs in zip(flat_p, tree_leaves(grads),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu))]
    new_p, new_m, new_v = (unflatten(list(r)) for r in zip(*results))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm}


def lr_schedule(step, *, peak_lr=3e-4, warmup_steps=100, total_steps=10_000,
                min_ratio=0.1):
    """Linear warmup + cosine decay; ``step`` an int tensor, returns a
    fp32 0-d tensor."""
    s = step.float()
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
