"""The port's training losses (``lm_loss`` / ``encdec_loss`` through
``ModelAPI.loss``) and their gradients against ``jax.value_and_grad`` of
the JAX package's, for every config of the registry at its smoke widths,
on one set of weights in both packages and a ``train.data`` batch.  The
weights are the port's seeded ``init`` (its tree is the JAX init's,
``test_torch_lm.py``), carried to JAX as NumPy: a JAX init costs seconds
of compilation an arch, the port's milliseconds.

Tolerances: an fp32 ``dataclasses.replace`` of each smoke config at rtol
1e-4 / atol 1e-5 (loss, metrics and every gradient element: fp32 sums in
another order); the smoke configs' own bf16 compute at 5e-2 of max|ref|,
the gate of ``test_torch_lm.py``, for the loss, each metric and each
gradient leaf (bf16 rounds at other places in the two frameworks).  A
bf16 gradient leaf that the JAX package's own bf16 rounding moves further
than that (a small leaf summed over the batch with cancellation, such as
Mamba's ``D``) is held within twice the distance of the JAX bf16 leaf
from the JAX fp32 one instead.

MoE configs: a bf16 router's top k can part between the packages at a
near-tie (``test_torch_moe.py``), and a token sent to another expert
moves every gradient upstream of it by its share.  So the port's router
takes the JAX package's top-k ids (its own logits, probabilities and
renormalised gates at those ids), after ``check_routing`` has held each
difference of its own top k to a tie; in fp32 there must be none.

The loss path must reach neither kernel op: both raise when an input
requires grad (checked here too), so a loss path that reached one would
fail every case.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import model_api as jax_model_api
from repro.train.data import DataConfig, lm_batch_at_step
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention, moe, ssm
from repro_torch.models import transformer as T
from repro_torch.models.api import model_api
from repro_torch.train.checkpoint import _flatten_with_names
from repro_torch.train.loop import value_and_grad
from test_torch_moe import check_routing, record_routers, top_k

BATCH, SEQ = 2, 16


def _moe_layers(cfg) -> int:
    return sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers)) \
        if cfg.num_experts else 0


def force_routing(monkeypatch, jax_logits, k):
    """Patch the port's router: its own logits and probabilities, the
    top-k ids of the JAX logits of the same layer (a layer known by its
    router slice, so a recomputation in the backward finds it again),
    gates its own probabilities there, renormalised.  Returns the list
    the port's logits of each layer's first call go to."""
    route, layer_of, port_logits = moe._route, {}, []

    def forced(p, cfg, xf):
        logits, probs, _, _ = route(p, cfg, xf)
        key = p["router"].data_ptr()
        if key not in layer_of:
            layer_of[key] = len(layer_of)
            port_logits.append(logits.detach().float().numpy())
        idx = torch.as_tensor(top_k(jax_logits[layer_of[key]], k))
        gates = torch.gather(probs, 1, idx)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return logits, probs, gates, idx

    monkeypatch.setattr(moe, "_route", forced)
    return port_logits


def _close(got, want, dtype, what, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=what)
    else:
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= max(5e-2 * scale, floor), \
            f"{what}: {err} of max|ref| {scale} (JAX bf16 noise {floor / 2})"


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The port's seeded init of the arch's smoke config, as NumPy."""
    params = model_api(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    return jax.tree_util.tree_map(lambda t: t.numpy(), params)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype, batch_size, seq, over=()):
    """The JAX package's (loss, metrics, grads as NumPy leaves in the
    port's order, router logits of each MoE layer's forward call) on the
    test batch."""
    cfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                              **dict(over))
    batch = lm_batch_at_step(cfg, DataConfig(batch_size, seq, seed=3), 5)
    with pytest.MonkeyPatch.context() as mp:
        jax_calls, _ = record_routers(mp)
        (loss, met), grads = jax.jit(jax.value_and_grad(
            jax_model_api(cfg).loss, has_aux=True))(_params(arch),
                                                    batch)
        jax.effects_barrier()
    names, leaves, _ = _flatten_with_names(
        jax.tree_util.tree_map(np.asarray, grads))
    # the forward's router calls come first; the backward's
    # recomputations (remat) after them
    n_moe = _moe_layers(cfg)
    return batch, loss, met, names, leaves, jax_calls[:n_moe]


def run_loss_and_grads(arch, dtype, monkeypatch, batch_size=BATCH,
                       seq=SEQ, **over):
    """The loss, metrics and grads of both packages on one batch, held
    to each other."""
    cfg_t = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)
    over = tuple(sorted(over.items()))
    batch, loss_j, met_j, names, want, jl = _jax_run(arch, dtype, batch_size,
                                                     seq, over)
    floors = [0.0] * len(want)
    if dtype != "float32":
        fp32 = _jax_run(arch, "float32", batch_size, seq, over)[4]
        floors = [2 * float(np.abs(np.asarray(w, np.float64) - r).max())
                  for w, r in zip(want, fp32)]
    n_moe = _moe_layers(cfg_t)
    if n_moe:
        port_logits = force_routing(monkeypatch, jl,
                                    cfg_t.num_experts_per_token)
    params = T.lm_params_from_numpy(_params(arch), "cpu")
    loss_t, met_t, grads_t = value_and_grad(
        model_api(cfg_t).loss, params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    if n_moe:
        assert len(port_logits) == n_moe
        flips = sum(len(check_routing(a, b, cfg_t.num_experts_per_token,
                                      dtype)) for a, b in zip(jl, port_logits))
        assert flips == 0 or dtype != "float32"
    _close(loss_t, loss_j, dtype, "loss")
    assert sorted(met_t) == sorted(met_j)
    for k in met_j:
        _close(met_t[k], met_j[k], dtype, f"metric {k}")
    got_names, got, _ = _flatten_with_names(grads_t)
    assert got_names == names
    for name, g, w, p, floor in zip(names, got, want,
                                    _flatten_with_names(params)[1], floors):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        _close(g.float().numpy(), np.asarray(w, np.float32), dtype,
               f"grad {name}", floor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch, dtype, monkeypatch):
    run_loss_and_grads(arch, dtype, monkeypatch)


@pytest.mark.parametrize("arch,batch_size,seq,over", [
    # Sq * Skv > 512^2: the chunked online softmax
    ("stablelm-1.6b", 1, 520, {"attention_impl": "chunked"}),
    ("minicpm3-4b", 1, 520, {"attention_impl": "chunked"}),
    # S > the smoke window of 16: the chunk + neighbour decomposition
    ("h2o-danube-3-4b", 2, 40, {"attention_impl": "chunked"}),
], ids=["chunked", "chunked-mla", "sliding-window"])
def test_attention_branches_match_jax(arch, batch_size, seq, over,
                                      monkeypatch):
    run_loss_and_grads(arch, "float32", monkeypatch, batch_size, seq, **over)


def test_ssd_chunk_decay_overflow_keeps_grads_finite():
    """mamba2's smoke config at its full config's chunk of 256 over 512
    tokens, bf16 compute: a chunk decays past e^88, the JAX
    ``_segsum_exp`` overflows in its masked entries, and every JAX
    gradient leaf but a few is non-finite (0 * inf in its backward).  The
    port masks before the exponential: the same loss, finite gradients,
    as the port's at a chunk of 16 (the same function, rounded in another
    order) within the bf16 gate."""
    cfg_t = dataclasses.replace(get_smoke_config("mamba2-130m"),
                                ssm_chunk=256)
    cfg_j = dataclasses.replace(jax_smoke_config("mamba2-130m"),
                                ssm_chunk=256)
    batch = lm_batch_at_step(cfg_j, DataConfig(4, 512), 0)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        jax_model_api(cfg_j).loss, has_aux=True))(_params("mamba2-130m"),
                                                   batch)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree_util.tree_leaves(grads_j))
    params = T.lm_params_from_numpy(_params("mamba2-130m"), "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _, grads = value_and_grad(model_api(cfg_t).loss, params, tb)
    _close(loss, loss_j, "bfloat16", "loss")
    short = value_and_grad(model_api(dataclasses.replace(
        cfg_t, ssm_chunk=16)).loss, params, tb)[2]
    names, got, _ = _flatten_with_names(grads)
    for name, g, w in zip(names, got, _flatten_with_names(short)[1]):
        assert bool(torch.isfinite(g).all()), name
        _close(g.float().numpy(), w.float().numpy(), "bfloat16", name)


def _counted(monkeypatch):
    """Count the calls of both kernel ops made through the models."""
    calls = {"flash": 0, "ssd": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(attention, "flash_attention", "flash")
    wrap(ssm, "ssd_scan", "ssd")
    return calls


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-medium",
                                  "minicpm3-4b"])
def test_loss_takes_the_plain_branches_and_prefill_the_kernels(
        arch, monkeypatch):
    """``api.loss`` calls neither op; ``api.prefill`` still calls them
    (the serving route keeps its kernels)."""
    cfg = get_smoke_config(arch)
    api = model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in lm_batch_at_step(
        cfg, DataConfig(1, SEQ), 0).items()}
    calls = _counted(monkeypatch)
    value_and_grad(api.loss, params, batch)
    assert calls == {"flash": 0, "ssd": 0}
    with torch.no_grad():
        api.prefill(params, batch)
    attn = cfg.pattern.count("A") + cfg.num_encoder_layers
    assert calls == {"flash": attn, "ssd": cfg.pattern.count("M")}


def _attn_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 8, 2, 16, generator=g).requires_grad_(
        requires_grad) for _ in range(3)]


def _ssd_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    u = torch.randn(1, 8, 2, 4, generator=g)
    a = -torch.rand(1, 8, 2, generator=g)
    bm, cm = torch.randn(2, 1, 8, 3, generator=g)
    return [t.requires_grad_(requires_grad) for t in (u, a, bm, cm)]


@pytest.mark.parametrize("which", range(3))
def test_flash_attention_refuses_grad_inputs(which):
    q, k, v = _attn_inputs(False)
    args = [q, k, v]
    args[which] = args[which].detach().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(*args, causal=True)
    with torch.no_grad():      # no graph: the kernel's forward is fine
        out = flash_ops.flash_attention(*args, causal=True)
    torch.testing.assert_close(out, flash_ops.flash_attention(
        q, k, v, causal=True))


@pytest.mark.parametrize("which", range(4))
def test_ssd_scan_refuses_grad_inputs(which):
    args = _ssd_inputs(False)
    plain = ssd_ops.ssd_scan(*args, chunk=4)
    args[which] = args[which].detach().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd_scan(*args, chunk=4)
    with torch.no_grad():
        y, state = ssd_ops.ssd_scan(*args, chunk=4)
    torch.testing.assert_close((y, state), plain)
