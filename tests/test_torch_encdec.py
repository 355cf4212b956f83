"""The port's cross-attention, frontends and encoder-decoder stack
(``repro_torch.models.{attention,encdec}``) against the JAX package's, with
the JAX package's weights carried across and seeded N(0, 1) inputs; then
three behaviours of the JAX ``ServeEngine`` with a frontend that the port
keeps, each shown on both packages.

Tolerances are the LM tests' (``tests/test_torch_lm.py``): fp32 at rtol =
atol = 1e-4 (fp32 sums in another order), bf16 at 5e-2 of max|ref| (bf16
rounds at other places in the two frameworks).

The behaviours:

1. The engine sends all-zero ``frontend_embeds`` [slots, max(1,
   num_frontend_tokens), d_model] in fp32.  With no biases anywhere, a
   seamless source of zeros gives a zero encoder output and zero cross
   K/V, so serving alone never tests the encoder: the tests above do.
2. With a decoder-only frontend, decoding starts at ``pos = plen`` though
   the prefill filled ``plen + T`` cache rows: the first step writes over
   row ``plen`` and the decode mask ``kpos <= pos`` hides the rows after
   it.
3. An encoder-decoder's merged cross cache is its prefill's T_src rows
   zero-padded to ``max_seq // encoder_seq_ratio`` rows, and
   cross-attention attends over all of them, with no mask.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import encdec as JED
from repro.models.api import model_api as jax_model_api
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding import unbox
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.api import model_api
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_lm import SEQ, STEPS, _check as check
from test_torch_lm import _run as run_lm

SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-76b"
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, dtype="float32", **change):
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                                **change),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                **change))


def _check(got, want, dtype, what):
    check(got, want, "fp32" if dtype == "float32" else "bf16", what)


def _normal(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


@functools.lru_cache(maxsize=None)
def _params(arch, **change):
    """The JAX package's init of the smoke config (fp32 parameters), as
    numpy."""
    api = jax_model_api(_cfgs(arch, **change)[0])
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: unbox(api.init(k)))(
            jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# Cross-attention, encode, prefill + decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,skv,impl", [
    (12, 5, "naive"),       # the decoder's prompt over a short source
    (1, 16, "naive"),       # a decode step over a padded cross cache
    (6, 6, "naive"),        # Sq == Skv: the port's flash route, not causal
    (600, 500, "chunked"),  # past 512 x 512: the chunked branch
])
def test_cross_attention_matches_jax(sq, skv, impl, dtype):
    cfg_j, cfg_t = _cfgs(SEAMLESS, dtype, attention_impl=impl)
    p = jax.tree_util.tree_map(np.asarray, unbox(JA.init_cross_attention(
        jax.random.PRNGKey(3), cfg_j, jnp.float32)))
    pt = T.lm_params_from_numpy(p, "cpu")
    assert set(pt) == {"wq", "wk", "wv", "wo"}
    assert pt["wk"].shape == (cfg_t.d_model, cfg_t.num_heads,
                              cfg_t.head_dim)     # H heads, not K
    # the same init in the port: the tree's shapes
    mine = A.init_cross_attention(torch.Generator().manual_seed(0), cfg_t)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in p.items()}
    rng = np.random.default_rng(sq * 1000 + skv)
    xj, xt = _normal(rng, (2, sq, cfg_t.d_model), dtype)
    ej, et = _normal(rng, (2, skv, cfg_t.d_model), dtype)
    kvj = JA.cross_attention_kv(p, ej)
    kvt = A.cross_attention_kv(pt, et)
    _check(kvt.k, kvj.k, dtype, "cross k")
    _check(kvt.v, kvj.v, dtype, "cross v")
    got = A.cross_attention_apply(pt, cfg_t, xt, kvt)
    assert got.dtype == xt.dtype
    _check(got, JA.cross_attention_apply(p, cfg_j, xj, kvj), dtype,
           f"cross attention {sq} x {skv}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_src", [1, 3, 7])
def test_encode_matches_jax(t_src, dtype):
    """The encoder's non-causal self-attention at S = 1 (the serving
    engine's one-frame source) and at short ragged lengths."""
    cfg_j, cfg_t = _cfgs(SEAMLESS, dtype)
    tree = _params(SEAMLESS)
    params_t = T.lm_params_from_numpy(tree, "cpu")
    fj, ft = _normal(np.random.default_rng(t_src), (2, t_src, cfg_t.d_model),
                     "float32")
    want = jax.jit(lambda p, f: JED.encode(p, cfg_j, f))(
        jax.tree_util.tree_map(jnp.asarray, tree), fj)
    got = ED.encode(params_t, cfg_t, ft)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype, f"encode T_src {t_src}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_prefill_and_decode_match_jax(dtype, monkeypatch):
    """``encdec_prefill`` (logits, self and cross caches) and 8
    ``encdec_decode_step`` calls against a source that fills the cross
    cache: T_src = (S + 8) // 4, no padding (``tests/test_torch_lm.py``
    runs a padded one)."""
    run_lm(SEAMLESS, dtype, monkeypatch, t_src=(SEQ + STEPS) // 4)


def test_init_cache_defaults_the_source_length():
    cfg = get_smoke_config(SEAMLESS)
    api, api_j = model_api(cfg), jax_model_api(jax_smoke_config(SEAMLESS))
    for s, src in ((64, None), (3, None), (64, 7)):
        mine = api.init_cache(2, s, src_len=src)
        ref = unbox(api_j.init_cache(2, s, src_len=src))
        for key in ("self", "cross"):
            for z, r in zip(mine[key], ref[key]):
                assert tuple(z.shape) == r.shape
                assert str(z.dtype) == "torch." + r.dtype.name
                assert not z.any()


# ---------------------------------------------------------------------------
# The reference's serving behaviours, kept
# ---------------------------------------------------------------------------

def _engines(arch, slots=2, max_seq=64, n_front=None, prompts=(5, 9, 3),
             max_new=4):
    """Both engines on the fp32 smoke config (``n_front`` replaces
    ``num_frontend_tokens``) with the JAX weights and the same requests.
    Each records its prefill batches and, per decode step, (wave, pos,
    the cache going in, the cache coming out) as numpy."""
    change = {} if n_front is None else {"num_frontend_tokens": n_front}
    cfg_j, cfg_t = _cfgs(arch, **change)
    tree = _params(arch, **change)
    kw = dict(slots=slots, max_seq=max_seq)
    eng_j = JaxServeEngine(jax_model_api(cfg_j),
                           jax.tree_util.tree_map(jnp.asarray, tree), **kw)
    eng_t = ServeEngine(model_api(cfg_t), T.lm_params_from_numpy(tree, "cpu"),
                        device="cpu", **kw)
    rng = np.random.default_rng(5)
    for uid, plen in enumerate(prompts):
        prompt = rng.integers(1, cfg_t.vocab_size, plen).astype(np.int32)
        eng_j.submit(JaxRequest(uid=uid, prompt=prompt,
                                max_new_tokens=max_new))
        eng_t.submit(Request(uid=uid, prompt=prompt.copy(),
                             max_new_tokens=max_new))
    rec = {"jax": ([], []), "port": ([], [])}

    def as_np(cache):
        return jax.tree_util.tree_map(
            lambda x: np.array(x.float() if isinstance(x, torch.Tensor)
                               else x, np.float32), cache)

    prefill_j, decode_j = eng_j._prefill, eng_j._decode
    prefill_t, step_t = eng_t._prefill, eng_t._step

    def rec_prefill_j(p, batch):
        rec["jax"][0].append(as_np(batch))
        return prefill_j(p, batch)

    def rec_decode_j(p, c, tok, pos):
        before = as_np(c)      # the cache is donated
        out = decode_j(p, c, tok, pos)
        rec["jax"][1].append((len(rec["jax"][0]) - 1, int(pos), before,
                              as_np(out[1])))
        return out

    def rec_prefill_t(p, batch):
        rec["port"][0].append({k: v.numpy().astype(np.float32)
                               for k, v in batch.items()})
        return prefill_t(p, batch)

    def rec_step_t(p, c, tok, pos, *gen):
        before = as_np(c)      # written in place
        out = step_t(p, c, tok, pos, *gen)
        rec["port"][1].append((len(rec["port"][0]) - 1, int(pos), before,
                               as_np(out[2])))
        return out

    eng_j._prefill, eng_j._decode = rec_prefill_j, rec_decode_j
    eng_t._prefill, eng_t._step = rec_prefill_t, rec_step_t
    eng_j.run_until_done()
    eng_t.run_until_done()
    assert eng_t.wave_log == eng_j.wave_log
    assert {r.uid: r.generated for r in eng_t.finished} == \
        {r.uid: r.generated for r in eng_j.finished}
    return eng_j, eng_t, rec


@pytest.mark.parametrize("arch", [INTERNVL, SEAMLESS])
def test_engine_sends_zero_frontends(arch):
    cfg = get_smoke_config(arch)
    eng_j, eng_t, rec = _engines(arch)
    assert len(rec["jax"][0]) == len(rec["port"][0]) == len(eng_j.wave_log)
    for bj, bt in zip(rec["jax"][0], rec["port"][0]):
        assert sorted(bj) == sorted(bt) == ["frontend_embeds", "tokens"]
        fe = bt["frontend_embeds"]
        assert fe.shape == bj["frontend_embeds"].shape == (
            eng_t.slots, max(1, cfg.num_frontend_tokens), cfg.d_model)
        assert not fe.any() and not bj["frontend_embeds"].any()
        np.testing.assert_array_equal(bt["tokens"], bj["tokens"])
    if cfg.is_encoder_decoder:
        # a zero source: zero encoder output, so zero cross K/V
        for _, _, before, _ in rec["jax"][1] + rec["port"][1]:
            assert not before["cross"].k.any() and \
                not before["cross"].v.any()


def test_decode_starts_at_plen_after_a_256_patch_frontend():
    n_front, max_seq = 256, 288
    eng_j, eng_t, rec = _engines(INTERNVL, max_seq=max_seq, n_front=n_front,
                                 prompts=(5, 9, 3))
    starts = []
    for run in ("jax", "port"):
        steps = rec[run][1]
        first = [s for i, s in enumerate(steps)
                 if i == 0 or s[0] != steps[i - 1][0]]
        starts.append([pos for _, pos, _, _ in first])
        for _, plen, before, after in first:
            for b, a in zip(before["pos0"], after["pos0"]):
                # the prefill filled rows 0 .. plen + 255
                assert np.abs(b[:, :, plen + n_front - 1]).max() > 0
                assert not b[:, :, plen + n_front:].any()
                # the first step writes over row plen, and only there
                assert not np.array_equal(a[:, :, plen], b[:, :, plen])
                np.testing.assert_array_equal(
                    np.delete(a, plen, axis=2), np.delete(b, plen, axis=2))
    assert starts[0] == starts[1] == [
        max(len(r.prompt) for r in eng_j.finished if r.uid in uids)
        for uids in eng_j.wave_log]
    assert len(rec["jax"][1]) == len(rec["port"][1])
    for (wj, pj, _, aj), (wt, pt, _, at) in zip(rec["jax"][1],
                                                rec["port"][1]):
        assert (wj, pj) == (wt, pt)
        for x, y in zip(jax.tree_util.tree_leaves(at),
                        jax.tree_util.tree_leaves(aj)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)


def test_cross_cache_is_zero_padded_and_attended_unmasked():
    cfg = get_smoke_config(SEAMLESS)
    max_seq = 64
    _, _, rec = _engines(SEAMLESS, max_seq=max_seq)
    rows = max_seq // cfg.encoder_seq_ratio
    for run in ("jax", "port"):
        for _, _, before, _ in rec[run][1]:
            for leaf in before["cross"]:
                assert leaf.shape == (cfg.num_layers, 2, rows,
                                      cfg.num_heads, cfg.head_dim)
    # on a seeded non-zero source: T_src = 3 rows padded to 16, every row
    # attended (zero keys score 0 and take their share of the softmax), so
    # the step differs from one against the unpadded 3 rows, in both
    # packages alike
    cfg_j, cfg_t = _cfgs(SEAMLESS)
    tree = _params(SEAMLESS)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params_t = T.lm_params_from_numpy(tree, "cpu")
    api_j, api_t = jax_model_api(cfg_j), model_api(cfg_t)
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    tok = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
    fj, ft = _normal(rng, (2, 3, cfg.d_model), "float32")
    _, cj = jax.jit(api_j.prefill)(params_j, {
        "tokens": jnp.asarray(tokens), "frontend_embeds": fj})
    _, ct = api_t.prefill(params_t, {
        "tokens": torch.as_tensor(tokens), "frontend_embeds": ft})
    logits = {}
    for src in (rows, 3):
        zj = unbox(api_j.init_cache(2, max_seq, src_len=src))
        cache_j = jax.tree_util.tree_map(
            lambda z, p: jax.lax.dynamic_update_slice(
                z, p.astype(z.dtype), (0,) * z.ndim), zj, cj)
        cache_t = api_t.init_cache(2, max_seq, src_len=src)
        for key in ("self", "cross"):
            for z, c in zip(cache_t[key], ct[key]):
                z[:, :, : c.shape[2]] = c
        lj, _ = jax.jit(api_j.decode_step)(params_j, cache_j,
                                           jnp.asarray(tok), jnp.int32(6))
        lt, _ = api_t.decode_step(params_t, cache_t, torch.as_tensor(tok), 6)
        _check(lt, lj, "float32", f"decode over {src} cross rows")
        logits[src] = np.asarray(lj)
    assert np.abs(logits[rows] - logits[3]).max() > 1e-3
