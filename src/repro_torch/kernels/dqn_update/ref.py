"""Plain PyTorch version of the fused TD-update kernel.

As in the JAX package, the kernel's oracle is the trainer math itself:
:func:`repro_torch.core.flexai.dqn.dqn_td_grads` (autograd over the
Huber double-DQN loss + global-norm clip) and ``dqn_td_update`` (grads +
``adam_apply``).  The lane-batched versions run it lane by lane, which
is what ``jax.vmap`` of the kernel computes: each lane's batch through
the shared nets (the data-parallel trainer) or through its own nets,
moments and step (the population trainer).  ``ops`` sends CPU tensors
here; ``chip_smoke.py`` holds the CUDA kernel against these on the card.
"""
import torch

from repro_torch.core.flexai.dqn import (AdamState, DQNParams, dqn_td_grads,
                                         dqn_td_update)

dqn_td_grads_ref = dqn_td_grads
dqn_td_update_ref = dqn_td_update


def lane_of(params: DQNParams, lane: int) -> DQNParams:
    """Lane ``lane``'s nets: the lane's slice of per-lane params ([L, ...]
    leaves), or the shared params themselves."""
    if params.w1.dim() == 2:
        return params
    return DQNParams(*[p[lane] for p in params])


def _stack(trees):
    return type(trees[0])(*[torch.stack(leaves) for leaves in zip(*trees)])


def dqn_td_grads_lanes_ref(eval_p: DQNParams, targ_p: DQNParams,
                           batch: dict, gamma: float = 0.95):
    """Per-lane ``(loss [L], grads [L, ...])`` of a [L, B, ...] batch."""
    out = [dqn_td_grads(lane_of(eval_p, i), lane_of(targ_p, i),
                        {k: v[i] for k, v in batch.items()}, gamma=gamma)
           for i in range(batch["s"].shape[0])]
    return torch.stack([o[0] for o in out]), _stack([o[1] for o in out])


def dqn_td_update_lanes_ref(eval_p: DQNParams, targ_p: DQNParams,
                            opt: AdamState, batch: dict, gamma: float = 0.95,
                            lr: float = 0.01):
    """Per-lane updates: ``(new_eval_p [L, ...], new_opt (step [L]),
    loss [L])``; ``opt`` is per lane."""
    out = []
    for i in range(batch["s"].shape[0]):
        opt_i = AdamState(opt.step[i], lane_of(opt.mu, i), lane_of(opt.nu, i))
        out.append(dqn_td_update(lane_of(eval_p, i), lane_of(targ_p, i),
                                 opt_i, {k: v[i] for k, v in batch.items()},
                                 gamma=gamma, lr=lr))
    new_p = _stack([o[0] for o in out])
    new_opt = AdamState(torch.stack([o[1].step for o in out]),
                        _stack([o[1].mu for o in out]),
                        _stack([o[1].nu for o in out]))
    return new_p, new_opt, torch.stack([o[2] for o in out])
