"""The port's routed MoE (``repro_torch.models.moe``) against the JAX
package's, at each MoE smoke config (qwen3-moe, moonshot, jamba), with
the JAX package's expert weights carried across.

``moe_apply`` returns (out, aux_loss); both are compared, fp32 at rtol =
atol = 1e-4, bf16 within 5e-2 of max|ref| (the LM tests' gate).  Cases:
the configs as they are, a capacity overflow (``moe_capacity_factor``
0.5: tokens dropped, first tokens winning), ``num_shared_experts=1``,
and ``moe_impl="shard_map"`` with no mesh, which both packages send down
the GSPMD path.

The router helpers here are shared with ``test_torch_lm.py``.  Router
logits are held to the JAX ones at the dtype's gate, and a top-k choice
may differ only at a tie within that noise: the JAX logits of the two
swapped experts at most twice the largest logit difference apart.  Here,
on one input, the gap must also be at most ``TIE_STEPS`` bf16 steps (the
router's logits are bf16 in the compute dtype, and each package's can
round one step the other way).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
from repro.sharding import unbox
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models import transformer as T

MOE_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b")
TIE_STEPS = 2


def bf16_step(x):
    """The spacing of bfloat16 (8 significant bits) at |x|."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def top_k(logits, k):
    """Row-wise top-k ids, ties to the lower id (``jax.lax.top_k``)."""
    return np.argsort(-np.asarray(logits), axis=-1, kind="stable")[:, :k]


def routing_flips(ref, got, k):
    """Rows of two runs' router logits [N, E] whose top-k expert sets
    differ, each with the reference's largest logit gap between a
    swapped pair: [(row, gap)]."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    out = []
    for r, (a, b) in enumerate(zip(top_k(ref, k), top_k(got, k))):
        lost, won = set(a) - set(b), set(b) - set(a)
        if lost:
            out.append((r, max(abs(ref[r, i] - ref[r, j])
                               for i in lost for j in won)))
    return out


def check_routing(ref, got, k, dtype, skip=()):
    """Two runs' router logits [N, E], rows ``skip`` aside: within the
    dtype's gate (fp32 rtol = atol = 1e-4; bf16 5e-2 of max|ref|), and
    every top-k difference a tie within that noise.  Returns the
    differing rows [(row, gap in bf16 steps of the larger logit)]."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    rows = np.setdiff1d(np.arange(ref.shape[0]), list(skip))
    diff = np.abs(got[rows] - ref[rows])
    if dtype == "float32":
        assert (diff <= 1e-4 + 1e-4 * np.abs(ref[rows])).all(), diff.max()
    else:
        assert diff.max() <= 5e-2 * np.abs(ref).max(), diff.max()
    noise = diff.max()
    out = []
    for r, gap in routing_flips(ref, got, k):
        if r in rows:
            assert gap <= 2 * noise, (r, gap, noise)
            lr = np.sort(np.abs(ref[r]))[-1]
            out.append((r, gap / bf16_step(lr)))
    return out


def record_routers(monkeypatch):
    """Record every router's fp32 logits [N, E]: the JAX package's (its
    softmax of a 2-D input, through an ordered callback, so inside jit
    too) and the port's (its ``_route``).  Returns (jax list, port list),
    one entry a MoE call in call order."""
    jax_calls, port_calls = [], []
    softmax, route = jax.nn.softmax, moe._route

    def jax_softmax(x, *args, **kw):
        if x.ndim == 2:
            jax.debug.callback(
                lambda v: jax_calls.append(np.asarray(v, np.float32)), x,
                ordered=True)
        return softmax(x, *args, **kw)

    def port_route(p, cfg, xf):
        out = route(p, cfg, xf)
        port_calls.append(out[0].detach().float().numpy())
        return out

    monkeypatch.setattr(jax.nn, "softmax", jax_softmax)
    monkeypatch.setattr(moe, "_route", port_route)
    return jax_calls, port_calls


def _params(cfg, seed=0):
    """The JAX ``init_moe`` tree (numpy) and the port's copy of it."""
    tree = jax.jit(lambda k: unbox(jax_moe.init_moe(k, cfg, jnp.float32)))(
        jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            T.lm_params_from_numpy(tree, "cpu"))


def kept_experts(logits, k, cap):
    """Each token's experts that got a slot: top-k of the router logits
    [N, E], slots handed out in token order (first tokens win)."""
    seen, out = {}, []
    for row in top_k(logits, k):
        kept = set()
        for e in row:
            if seen.get(e, 0) < cap:
                kept.add(int(e))
            seen[e] = seen.get(e, 0) + 1
        out.append(kept)
    return out


def _run(arch, dtype, monkeypatch, b=2, s=24, seed=0, **overrides):
    """moe_apply of both packages on one input.  Tokens whose kept
    experts differ are left out of the comparison; they must come from a
    routing near-tie (at most ``TIE_STEPS`` bf16 steps of the JAX
    logits)."""
    cfg_j = replace(jax_smoke_config(arch), **overrides)
    cfg_t = replace(get_smoke_config(arch), **overrides)
    pj, pt = _params(cfg_j, seed)
    x = np.random.default_rng(seed + 11).normal(
        size=(b, s, cfg_t.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    jax_calls, port_calls = record_routers(monkeypatch)
    out_j, aux_j = jax.jit(lambda p, x: jax_moe.moe_apply(p, cfg_j, x))(
        pj, xj)
    out_t, aux_t = moe.moe_apply(pt, cfg_t, xt)
    assert out_t.dtype == xt.dtype and out_t.shape == xt.shape
    assert aux_t.dtype == torch.float32 and aux_t.dim() == 0
    assert len(jax_calls) == len(port_calls) == 1
    k, n, cap = cfg_t.num_experts_per_token, b * s, moe._capacity(cfg_t,
                                                                   b * s)
    flips = check_routing(jax_calls[0], port_calls[0], k, dtype)
    assert all(steps <= TIE_STEPS for _, steps in flips), flips
    moved = [t for t, (a, c) in enumerate(zip(
        kept_experts(jax_calls[0], k, cap),
        kept_experts(port_calls[0], k, cap))) if a != c]
    assert not moved or flips, moved
    same = np.setdiff1d(np.arange(n), moved)
    got = out_t.float().numpy().reshape(n, -1)
    want = np.asarray(out_j, np.float32).reshape(n, -1)
    if dtype == "float32":
        np.testing.assert_allclose(got[same], want[same], rtol=1e-4,
                                   atol=1e-4)
    else:
        scale = float(np.abs(want).max())
        err = float(np.abs(got[same] - want[same]).max())
        assert err <= 5e-2 * scale, f"{err} of max|ref| {scale}"
    if not flips:
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-4,
                                   atol=1e-6)
    return cfg_t, pt, xt, out_t, len(moved)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, dtype, monkeypatch):
    _, _, _, _, moved = _run(arch, dtype, monkeypatch)
    if dtype == "float32":
        assert moved == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_overflow_drops_later_tokens_as_jax(arch, monkeypatch):
    """At capacity factor 0.5 some expert gets more choices than its
    slots; the first tokens keep theirs and the rest pass through."""
    cfg, pt, xt, out, _ = _run(arch, "float32", monkeypatch, s=40,
                               moe_capacity_factor=0.5)
    n = xt.shape[0] * xt.shape[1]
    _, _, _, idx = moe._route(pt, cfg, xt.reshape(n, -1))
    counts = np.bincount(idx.reshape(-1).numpy(),
                         minlength=cfg.num_experts)
    cap = moe._capacity(cfg, n)
    assert counts.max() > cap, (counts, cap)
    # a token all of whose choices overflowed contributes nothing
    flat = idx.numpy()
    seen = np.zeros(cfg.num_experts, int)
    dropped = []
    for t in range(n):
        kept = 0
        for e in flat[t]:
            kept += seen[e] < cap
            seen[e] += 1
        if not kept:
            dropped.append(t)
    rows = out.reshape(n, -1)
    assert all(float(rows[t].abs().max()) == 0.0 for t in dropped)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shared_expert_matches_jax(arch, monkeypatch):
    _, pt, _, _, _ = _run(arch, "float32", monkeypatch,
                          num_shared_experts=1)
    assert set(pt["shared"]) == {"wi_gate", "wi_up", "wo"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shard_map_impl_without_a_mesh_is_gspmd(arch, monkeypatch):
    cfg, pt, xt, out, _ = _run(arch, "float32", monkeypatch,
                               moe_impl="shard_map")
    want, aux = moe.moe_apply_gspmd(pt, cfg, xt)
    assert torch.equal(out, want)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: the lower expert ids win, as
    ``jax.lax.top_k`` breaks ties."""
    cfg = replace(get_smoke_config("qwen3-moe-30b-a3b"), dtype="float32")
    p = {"router": torch.zeros(cfg.d_model, cfg.num_experts)}
    p["router"][:, 5] = 1.0
    xf = torch.ones(3, cfg.d_model)
    _, probs, gates, idx = moe._route(p, cfg, xf)
    assert idx.tolist() == [[5, 0]] * 3
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert idx.tolist() == np.asarray(want).tolist()
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_routing_flips_measures_the_reference_gap():
    ref = np.array([[1.0, 1.0 - 2.0 ** -7, 0.0], [3.0, 2.0, 0.0]])
    got = np.array([[1.0 - 2.0 ** -6, 1.0, 0.0], [3.0, 2.0, 0.0]])
    assert routing_flips(ref, got, 1) == [(0, 2.0 ** -7)]
    assert check_routing(ref, got, 1, "bfloat16") == [(0, 1.0)]
    assert bf16_step(3.0) == 2.0 ** -6 and bf16_step(-0.75) == 2.0 ** -8
    # equal logits: no flip; logits apart past the gate are refused,
    # unless their row is skipped
    assert check_routing(ref, ref, 1, "float32") == []
    with pytest.raises(AssertionError):
        check_routing(ref, ref[:, [1, 0, 2]], 1, "bfloat16")
    assert check_routing(ref, ref[:, [1, 0, 2]], 1, "bfloat16",
                         skip=[1]) == [(0, 1.0)]
