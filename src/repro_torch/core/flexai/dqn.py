"""DQN networks for FlexAI (paper §7.1), in PyTorch.

EvalNet / TargNet: identical MLPs of two fully-connected layers (256, 64
neurons, ReLU) followed by a linear head producing one Q value per
accelerator.  Parameters are a ``DQNParams`` tuple of six plain tensors
(the JAX package's p0..p5 layout: w1 [D,256], b1 [256], w2 [256,64],
b2 [64], w3 [64,A], b3 [A]), so weights cross between the two packages
through :func:`params_from_numpy` and the shared npz checkpoint.

The TD update here is the plain version: autograd over the Huber
double-DQN loss, global-norm clip at 10, then Adam.  The fused CUDA kernel
(``repro_torch.kernels.dqn_update``) computes the same function.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

HIDDEN = (256, 64)
GRAD_CLIP = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class DQNParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


class AdamState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the params' device
    mu: DQNParams
    nu: DQNParams


def init_qnet(state_dim: int, n_actions: int, generator: torch.Generator,
              device="cpu") -> DQNParams:
    """Glorot-uniform weights, zero biases, drawn from ``generator`` (the
    JAX package's ``init_qnet`` draws the same distribution from its own
    key; weights that must agree come across by ``params_from_numpy``)."""
    s1, s2 = HIDDEN

    def glorot(fan_in, fan_out):
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        u = torch.rand(fan_in, fan_out, generator=generator,
                       dtype=torch.float32, device=device)
        return u * (2 * lim) - lim

    def zeros(k):
        return torch.zeros(k, dtype=torch.float32, device=device)

    return DQNParams(
        w1=glorot(state_dim, s1), b1=zeros(s1),
        w2=glorot(s1, s2), b2=zeros(s2),
        w3=glorot(s2, n_actions), b3=zeros(n_actions),
    )


def qnet_apply(p: DQNParams, state: torch.Tensor) -> torch.Tensor:
    """state [..., state_dim] -> Q values [..., n_actions].

    Per-lane params (a leading [L] axis on every leaf, as ``jax.vmap``
    over lanes has them) take state [L, state_dim] or [L, B, state_dim]:
    lane l's rows go through lane l's net.  (A plain ``[L, D] @ [L, D,
    256]`` would broadcast to [L, L, 256].)"""
    if p.w1.dim() == 3:
        one = state.dim() == 2
        x = state[:, None] if one else state
        h = torch.relu(torch.bmm(x, p.w1) + p.b1[:, None])
        h = torch.relu(torch.bmm(h, p.w2) + p.b2[:, None])
        q = torch.bmm(h, p.w3) + p.b3[:, None]
        return q[:, 0] if one else q
    h = torch.relu(state @ p.w1 + p.b1)
    h = torch.relu(h @ p.w2 + p.b2)
    return h @ p.w3 + p.b3


def adam_init(params: DQNParams) -> AdamState:
    """Zero moments and step; per-lane params ([L, ...]) get a step a
    lane ([L])."""
    z = DQNParams(*[torch.zeros_like(p) for p in params])
    return AdamState(torch.zeros(params.w1.shape[:-2], dtype=torch.int32,
                                 device=params.w1.device), z, z)


def dqn_td_grads(eval_p: DQNParams, targ_p: DQNParams, batch: dict,
                 gamma: float = 0.95):
    """TD loss + norm-clipped gradients on a replay batch.

    batch: s [B,D], a [B] int, r [B], s_next [B,D], done [B].
    Returns (loss, grads) with the 10.0 global-norm clip applied.
    """
    a = batch["a"].long()
    with torch.no_grad():
        # double DQN: EvalNet picks the argmax action (first max), TargNet
        # values it; y is a constant of the backward pass
        a_star = qnet_apply(eval_p, batch["s_next"]).argmax(-1)
        q_tn = qnet_apply(targ_p, batch["s_next"]).gather(
            1, a_star[:, None])[:, 0]
        y = batch["r"] + gamma * (1.0 - batch["done"]) * q_tn
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in eval_p]
        q = qnet_apply(DQNParams(*leaves), batch["s"])
        q_sel = q.gather(1, a[:, None])[:, 0]
        # Huber (smooth-L1), delta = 1
        err = y - q_sel
        abse = err.abs()
        loss = torch.where(abse <= 1.0, 0.5 * err * err, abse - 0.5).mean()
        grads = torch.autograd.grad(loss, leaves)
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = torch.clamp(GRAD_CLIP / gnorm.clamp_min(1e-9), max=1.0)
    return loss.detach(), DQNParams(*[g * clip for g in grads])


def adam_apply(eval_p: DQNParams, opt: AdamState, grads: DQNParams,
               lr: float = 0.01):
    """One Adam step on already-clipped gradients.
    Returns (new_eval_p, new_opt)."""
    step = opt.step + 1
    stepf = step.float()
    c1 = 1.0 - ADAM_B1 ** stepf
    c2 = 1.0 - ADAM_B2 ** stepf
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(eval_p, grads, opt.mu, opt.nu):
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        new_p.append(p - lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
        new_m.append(m)
        new_v.append(v)
    return DQNParams(*new_p), AdamState(step, DQNParams(*new_m),
                                        DQNParams(*new_v))


def dqn_td_update(eval_p: DQNParams, targ_p: DQNParams, opt: AdamState,
                  batch: dict, gamma: float = 0.95, lr: float = 0.01):
    """One TD update: grads, then Adam.  Returns (new_eval_p, new_opt,
    loss)."""
    loss, grads = dqn_td_grads(eval_p, targ_p, batch, gamma=gamma)
    new_p, new_opt = adam_apply(eval_p, opt, grads, lr=lr)
    return new_p, new_opt, loss


def dqn_update(eval_p: DQNParams, targ_p: DQNParams, opt: AdamState,
               batch: dict, *, gamma: float = 0.95, lr: float = 0.01):
    """The host-loop entry point around :func:`dqn_td_update` (the JAX
    package jits it; here it runs op by op on the params' device)."""
    return dqn_td_update(eval_p, targ_p, opt, batch, gamma=gamma, lr=lr)


class DQNLearner:
    """EvalNet + TargNet + Adam + target syncing, for the loop trainer
    (``agent.FlexAIAgent``).  Plain PyTorch on ``device``: the JAX loop
    learner does not use the fused kernel either.  Weights are drawn from
    a generator seeded with ``seed``; weights that must agree with the
    JAX learner's come across by :func:`params_from_numpy`."""

    def __init__(self, state_dim: int, n_actions: int, gamma: float = 0.95,
                 lr: float = 0.01, target_sync_every: int = 100,
                 seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.eval_p = init_qnet(state_dim, n_actions, gen, self.device)
        self.targ_p = self.eval_p
        self.opt = adam_init(self.eval_p)
        self.gamma = gamma
        self.lr = lr
        self.target_sync_every = target_sync_every
        self.updates = 0

    def q_values(self, state) -> torch.Tensor:
        return qnet_apply(self.eval_p, torch.as_tensor(
            np.asarray(state, np.float32), device=self.device))

    def update(self, batch: dict) -> float:
        """One TD update on a host batch (numpy arrays, ``ReplayBuffer``
        layout); returns the loss."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        self.eval_p, self.opt, loss = dqn_update(
            self.eval_p, self.targ_p, self.opt, batch, gamma=self.gamma,
            lr=self.lr)
        self.updates += 1
        if self.updates % self.target_sync_every == 0:
            self.targ_p = self.eval_p
        return float(loss)


# ---------------------------------------------------------------------------
# weights across packages: the shared p0..p5 npz
# ---------------------------------------------------------------------------

def params_from_numpy(arrays, device="cpu") -> DQNParams:
    """Six arrays in p0..p5 order (e.g. a JAX ``DQNParams`` passed through
    ``np.asarray``) -> f32 tensors on ``device``."""
    arrays = list(arrays)
    if len(arrays) != 6:
        raise ValueError(f"expected 6 parameter arrays, got {len(arrays)}")
    return DQNParams(*[torch.tensor(np.asarray(a, np.float32), device=device)
                       for a in arrays])


def save_dqn_npz(path: str, params: DQNParams) -> None:
    """THE checkpoint format (p0..p5 EvalNet arrays), shared with the JAX
    package's ``save_dqn_npz``/``load_dqn_npz``."""
    np.savez(path, **{f"p{i}": w.detach().cpu().numpy()
                      for i, w in enumerate(params)})


def load_dqn_npz(path: str, device="cpu") -> DQNParams:
    with np.load(path) as data:
        return params_from_numpy([data[f"p{i}"] for i in range(6)], device)
