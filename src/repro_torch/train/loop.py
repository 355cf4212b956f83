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

When the state's leaves are ``DTensor``s (``sharding.place`` of a state
by ``sharding.tree_named_shardings(train_state_boxed(...), mesh)``) the
step runs partitioned over their mesh, as the JAX step runs on arrays
whose shardings travel with them: every rank passes the whole batch and
takes its rows of each microbatch (the "batch" rule's axes,
``("pod", "data")``), computes the loss and gradient of its rows
(``sharding.row_shard``; the cross-entropy scaled by the rows' share of
the microbatch's kept positions, the loss then rebuilt as ``loss +
aux_loss`` of the metrics, which is what ``lm_loss`` and
``encdec_loss`` return) on its blocks (``sharding.Blocked``), each
gathered whole only where the model uses it (a super-block at a time in
``transformer._scan_blocks``, the embedding and unembedding on their
own), and the gather's backward reduces each gradient to its leaf's
block (``sharding.reduce_to_block``: a reduce-scatter over the batch
axes the leaf is sharded on, a sum over the others).
``train_step.on_blocks(local, shardings, batch)`` runs that step on
blocks directly (an abstract mesh's in the dry run).  Compression and AdamW run on the
shards, with the global norm and int8's per-tensor scale reduced over
each leaf's shards.  Ranks that differ only on other axes ("model") hold
the same rows and compute the same thing.  The result is the function
the meshless step computes, up to the order of floating-point sums.

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

from repro_torch import distributed as pdist
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import lm_params_from_numpy
from repro_torch.sharding import Param, boxed_axes, is_param
from repro_torch.sharding import partition as P
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


def _batch_axes(mesh) -> tuple:
    """The mesh axes the "batch" rule splits rows over, by the ambient
    rules (``sharding.activate``) or the default ones."""
    ctx = P.current_mesh_and_rules()
    rules = P.DEFAULT_RULES if ctx is None else ctx[1]
    return P._entry_axes(P.logical_to_mesh_axes(("batch",), rules, mesh)[0])


def _kept(batch) -> torch.Tensor:
    """The positions the loss keeps (fp32): ``loss_mask``'s sum, else
    every label."""
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["labels"].numel()))
    return mask.float().sum()


def _over_shards(values, shardings, reduce):
    """Each leaf's ``values`` entry (a 0-d tensor of its shard) reduced
    over the mesh axes the leaf is sharded on, one collective a group of
    leaves sharded alike; a replicated leaf's value counts once."""
    out = list(values)
    groups: dict = {}
    for i, sh in enumerate(shardings):
        held = {a for e in sh.spec for a in P._entry_axes(e)}
        axes = tuple(a for a in P.mesh_axis_names(sh.mesh)
                     if a in held and pdist.mesh_size(sh.mesh, a) > 1)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        v = torch.stack([out[i] for i in idx])
        mesh = shardings[idx[0]].mesh
        for axis in axes:
            v = reduce(v, mesh, axis)
        for j, i in enumerate(idx):
            out[i] = v[j]
    return out


def make_train_step(api: ModelAPI, hyper: TrainHyper):
    cfg = api.cfg
    n_micro = max(1, cfg.use_grad_accum_microbatches)

    def whole_grad(params, batch):
        return value_and_grad(api.loss, params, batch)

    def compute_grads(params, batch, grad_fn=whole_grad):
        if n_micro == 1:
            return grad_fn(params, batch)
        micro = _split_microbatches(batch, n_micro)
        device = tree_leaves(params)[0].device
        loss_sum = torch.zeros((), device=device)
        grads = tree_map(lambda p: torch.zeros(p.shape, device=device),
                         params)
        for i in range(n_micro):
            loss, metrics, g = grad_fn(
                params, {k: v[i] for k, v in micro.items()})
            tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / n_micro, grads)
        return loss_sum / n_micro, metrics, grads

    def update(params, grads, opt, ef, reduce_amax=None, gnorm_fn=None):
        if hyper.compression == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        elif hyper.compression == "int8_ef":
            grads, ef = C.compress_grads_int8_ef(grads, ef, reduce_amax)
        lr = lr_schedule(opt.step, peak_lr=hyper.peak_lr,
                         warmup_steps=hyper.warmup_steps,
                         total_steps=hyper.total_steps)
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt, lr,
            b1=hyper.b1, b2=hyper.b2,
            weight_decay=hyper.weight_decay,
            grad_clip_norm=hyper.grad_clip_norm,
            gnorm=None if gnorm_fn is None else gnorm_fn(grads))
        return new_params, new_opt, ef, opt_metrics, lr

    def blocks_step(local: TrainState, shardings: TrainState, batch: dict):
        """The partitioned step on this rank's blocks ``local`` of a state
        placed by ``shardings`` (a tree of ``NamedSharding`` leaves, on a
        ``DeviceMesh`` or, in the dry run, an abstract mesh): (its new
        blocks, metrics)."""
        mesh = shardings.opt.step.mesh
        axes = _batch_axes(mesh)
        shard = P.RowShard(mesh, axes)
        p_shards = tree_leaves(shardings.params)
        device = local.opt.step.device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}

        def rows_grad(params, batch):
            rows = {}
            for k, v in batch.items():
                if v.shape[0] % shard.blocks:
                    raise ValueError(
                        f"{v.shape[0]} rows of {k!r} (a microbatch's) do "
                        f"not split over the {shard.blocks} blocks of "
                        f"{axes}")
                b = v.shape[0] // shard.blocks
                rows[k] = v[shard.index * b:(shard.index + 1) * b]
            # the loss is a mean over the kept positions of the whole
            # microbatch (every rank holds it): this rank's mean times its
            # share of them, so that the ranks' losses sum to that mean
            share = _kept(rows) / _kept(batch).clamp_min(1.0)

            def loss_fn(params, rows):
                # each leaf gathered where it is used; the gather's
                # backward reduces its gradient to this rank's block
                _, m = api.loss(tree_map(P.Blocked, params,
                                         shardings.params), rows)
                m = dict(m, loss=m["loss"] * share)
                return m["loss"] + m.get("aux_loss", 0.0), m
            with P.row_shard(mesh, axes):
                return value_and_grad(loss_fn, params, rows)

        loss, metrics, grads = compute_grads(local.params, batch, rows_grad)
        # every loss term is this rank's share: sum them over the rows
        names = sorted(k for k in metrics if k != "perplexity")
        total = torch.stack([loss] + [metrics[k] for k in names])
        for axis in axes:
            total = pdist.psum(total, mesh, axis)
        loss = total[0]
        metrics = dict(zip(names, total[1:]))
        if "loss" in metrics:
            metrics["perplexity"] = torch.exp(metrics["loss"].clamp_max(
                20.0))

        def reduce_amax(amaxes):
            return _over_shards(amaxes, p_shards, pdist.pmax)

        def gnorm_fn(grads):
            squares = [torch.sum(torch.square(g.float()))
                       for g in tree_leaves(grads)]
            return torch.sqrt(sum(_over_shards(squares, p_shards,
                                               pdist.psum)))

        new_params, new_opt, ef, opt_metrics, lr = update(
            local.params, grads, local.opt, local.ef, reduce_amax, gnorm_fn)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, ef), metrics

    def partitioned_step(state: TrainState, batch: dict):
        shardings = tree_map(P.sharding_of, state)
        new, metrics = blocks_step(tree_map(lambda x: x.to_local(), state),
                                   shardings, batch)
        return tree_map(P.from_local, new, shardings), metrics

    @torch.no_grad()
    def train_step(state: TrainState, batch: dict):
        if P.is_dtensor(state.opt.step):
            return partitioned_step(state, batch)
        device = tree_leaves(state.params)[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        loss, metrics, grads = compute_grads(state.params, batch)
        new_params, new_opt, ef, opt_metrics, lr = update(
            state.params, grads, state.opt, state.ef)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, ef), metrics

    train_step.on_blocks = torch.no_grad()(blocks_step)
    return train_step
