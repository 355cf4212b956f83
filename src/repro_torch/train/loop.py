"""Train state and train step (mixed precision, grad accumulation,
optional gradient compression), the port of ``repro.train.loop``.

``make_train_step(api, hyper)`` returns ``train_step(state, batch) ->
(state, metrics)``, a pure function of its inputs as the JAX step is: it
differentiates ``api.loss`` with autograd on detached copies of the
parameters (so no state tensor ever requires grad), accumulates
``cfg.use_grad_accum_microbatches`` microbatches in fp32 in order, then
compresses the gradients (``hyper.compression``) and applies AdamW.  The
batch may be NumPy arrays (``train.data``); they go to the parameters'
device.

``TrainState``'s field names are the JAX package's, so an LM checkpoint
(``.params/['blocks']/...``, ``.opt/.mu/...``) restores in either package
by leaf name.  ``train_state_boxed`` gives the state's boxed tree from a
boxed parameter tree (``models.layers.abstract`` of ``api.init``): the
optimizer moments (and ``int8_ef``'s residuals) fp32 boxes with each
parameter's logical axes, the step a ``()`` int32 box; the dry run
shards it with ``sharding.tree_shardings``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import lm_params_from_numpy
from repro_torch.sharding import Param, boxed_axes, is_param
from repro_torch.train import compression as C
from repro_torch.train.checkpoint import (_flatten_with_names, tree_leaves,
                                          tree_map)
from repro_torch.train.optimizer import (OptState, adamw_init, adamw_update,
                                         lr_schedule)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ef: Any  # error-feedback residuals (None unless int8_ef)


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    compression: str = "none"  # none | bf16 | int8_ef


def init_train_state(params, hyper: TrainHyper) -> TrainState:
    return TrainState(
        params=params,
        opt=adamw_init(params),
        ef=C.ef_init(params) if hyper.compression == "int8_ef" else None,
    )


def train_state_boxed(boxed_params, hyper: TrainHyper) -> TrainState:
    """Boxed TrainState (for tree_shardings / dry-run input specs).

    Optimizer moments inherit the parameter logical axes.
    """
    def as_f32(p):
        return Param(torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.value.device), p.axes)

    def moments():
        return tree_map(lambda p: as_f32(p) if is_param(p) else p,
                        boxed_params)

    return TrainState(
        params=boxed_params,
        opt=OptState(step=Param(torch.zeros(
            (), dtype=torch.int32,
            device=tree_leaves(boxed_params)[0].value.device), ()),
                     mu=moments(), nu=moments()),
        ef=moments() if hyper.compression == "int8_ef" else None,
    )


def train_state_axes(boxed_state: TrainState):
    """Logical-axes tree matching TrainState (for documentation/tests)."""
    return boxed_axes(boxed_state)


def train_state_from_numpy(tree, device) -> TrainState:
    """A JAX package's ``TrainState`` on the host (NumPy leaves, e.g.
    ``jax.device_get`` of one) as the port's on ``device``: the same
    values and dtypes (bf16 leaves by their bits)."""
    def conv(t):
        return None if t is None else lm_params_from_numpy(t, device)
    return TrainState(params=conv(tree.params),
                      opt=OptState(step=conv(tree.opt.step),
                                   mu=conv(tree.opt.mu),
                                   nu=conv(tree.opt.nu)),
                      ef=conv(tree.ef))


def _split_microbatches(batch: dict, n: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
            for k, v in batch.items()}


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``: grads a tree like ``params`` in their dtypes (zeros where
    a leaf does not reach the loss), loss and metrics detached."""
    _, leaves, unflatten = _flatten_with_names(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(grads))


def make_train_step(api: ModelAPI, hyper: TrainHyper):
    cfg = api.cfg
    n_micro = max(1, cfg.use_grad_accum_microbatches)

    def compute_grads(params, batch):
        if n_micro == 1:
            return value_and_grad(api.loss, params, batch)
        micro = _split_microbatches(batch, n_micro)
        device = tree_leaves(params)[0].device
        loss_sum = torch.zeros((), device=device)
        grads = tree_map(lambda p: torch.zeros(p.shape, device=device),
                         params)
        for i in range(n_micro):
            loss, metrics, g = value_and_grad(
                api.loss, params, {k: v[i] for k, v in micro.items()})
            tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / n_micro, grads)
        return loss_sum / n_micro, metrics, grads

    @torch.no_grad()
    def train_step(state: TrainState, batch: dict):
        device = tree_leaves(state.params)[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        loss, metrics, grads = compute_grads(state.params, batch)

        ef = state.ef
        if hyper.compression == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        elif hyper.compression == "int8_ef":
            grads, ef = C.compress_grads_int8_ef(grads, state.ef)

        lr = lr_schedule(state.opt.step, peak_lr=hyper.peak_lr,
                         warmup_steps=hyper.warmup_steps,
                         total_steps=hyper.total_steps)
        new_params, new_opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, lr,
            b1=hyper.b1, b2=hyper.b2,
            weight_decay=hyper.weight_decay,
            grad_clip_norm=hyper.grad_clip_norm)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, ef), metrics

    return train_step
