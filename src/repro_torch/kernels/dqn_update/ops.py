"""Fused TD-update entry points under the JAX package's signatures.

``dqn_td_grads_fused`` / ``dqn_td_update_fused`` take and return what
:func:`repro_torch.core.flexai.dqn.dqn_td_grads` / ``dqn_td_update`` do.
``dqn_td_grads_lanes`` / ``dqn_td_update_lanes`` are the same over a
[L, B, ...] batch of L lanes, one launch for all lanes: what ``jax.vmap``
of the fused entry points computes.  The route follows the batch's
device: CPU tensors go to the plain version (``ref``), CUDA tensors
launch the kernel (``kernel``) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.flexai.dqn import AdamState, DQNParams

from . import kernel, ref


def _route(batch: dict) -> str:
    dev = batch["s"].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no TD-update route for device {dev!r}")
    return dev


def _batch(batch: dict):
    s = batch["s"]
    return (s.float().contiguous(), batch["a"].to(torch.int32).contiguous(),
            batch["r"].float().contiguous(),
            batch["s_next"].float().contiguous(),
            batch["done"].float().contiguous())


def dqn_td_grads_fused(eval_p: DQNParams, targ_p: DQNParams, batch: dict,
                       gamma: float = 0.95):
    """Returns ``(loss, grads)`` with the 10.0 global-norm clip applied."""
    if _route(batch) == "cpu":
        return ref.dqn_td_grads_ref(eval_p, targ_p, batch, gamma=gamma)
    loss, grads = kernel.dqn_td_cuda(*_batch(batch), eval_p, targ_p,
                                     gamma=gamma)
    return loss[0], DQNParams(*grads)


def dqn_td_update_fused(eval_p: DQNParams, targ_p: DQNParams,
                        opt: AdamState, batch: dict, gamma: float = 0.95,
                        lr: float = 0.01):
    """Gradients and the Adam step in one launch.  Returns
    ``(new_eval_p, new_opt, loss)``."""
    if _route(batch) == "cpu":
        return ref.dqn_td_update_ref(eval_p, targ_p, opt, batch,
                                     gamma=gamma, lr=lr)
    loss, new_p, new_mu, new_nu = kernel.dqn_td_cuda(
        *_batch(batch), eval_p, targ_p, gamma=gamma,
        adam=(opt.mu, opt.nu, opt.step), lr=lr)
    new_opt = AdamState(opt.step + 1, DQNParams(*new_mu), DQNParams(*new_nu))
    return DQNParams(*new_p), new_opt, loss[0]


def dqn_td_grads_lanes(eval_p: DQNParams, targ_p: DQNParams, batch: dict,
                       gamma: float = 0.95):
    """``(loss [L], grads [L, ...])`` for a [L, B, ...] batch; each net is
    shared (unbatched leaves, read by every lane) or per lane ([L, ...])."""
    if _route(batch) == "cpu":
        return ref.dqn_td_grads_lanes_ref(eval_p, targ_p, batch, gamma=gamma)
    loss, grads = kernel.dqn_td_lanes_cuda(*_batch(batch), eval_p, targ_p,
                                           gamma=gamma)
    return loss, DQNParams(*grads)


def dqn_td_update_lanes(eval_p: DQNParams, targ_p: DQNParams,
                        opt: AdamState, batch: dict, gamma: float = 0.95,
                        lr: float = 0.01):
    """Every lane's gradients and Adam step in one launch; ``opt`` is per
    lane (step [L] i32).  Returns ``(new_eval_p, new_opt, loss [L])``."""
    if _route(batch) == "cpu":
        return ref.dqn_td_update_lanes_ref(eval_p, targ_p, opt, batch,
                                           gamma=gamma, lr=lr)
    loss, new_p, new_mu, new_nu = kernel.dqn_td_lanes_cuda(
        *_batch(batch), eval_p, targ_p, gamma=gamma,
        adam=(opt.mu, opt.nu, opt.step), lr=lr)
    new_opt = AdamState(opt.step + 1, DQNParams(*new_mu), DQNParams(*new_nu))
    return DQNParams(*new_p), new_opt, loss
