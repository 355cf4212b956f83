"""The port's MLA (multi-head latent attention) against the JAX
package's, at the minicpm3 smoke widths (8 heads, latent 32, rope 8,
nope 16, V 16), with the JAX package's weights carried across.

``init_mla_attention``'s tree, shapes and dtypes with and without
``q_lora_rank``; ``mla_apply`` (output and the latent cache entry: the
normed latent [B,S,R] and the roped key [B,S,P]), whose attention runs
the flash route with V zero-padded to the q/k head dim (on the CPU the
kernel's plain version); ``mla_decode`` (weight-absorbed, over the
latent cache) at positions inside a full cache and past it, where the
write clamps to the last slot as JAX's ``dynamic_update_slice`` does.
fp32 at rtol = atol = 1e-4, bf16 within 5e-2 of max|ref|.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attn
from repro.sharding import unbox
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T

ARCH = "minicpm3-4b"


def _cfgs(dtype="float32", **kw):
    return (replace(jax_smoke_config(ARCH), dtype=dtype, **kw),
            replace(get_smoke_config(ARCH), dtype=dtype, **kw))


def _params(cfg_j, seed=0):
    tree = jax.jit(lambda k: unbox(jax_attn.init_attention(
        k, cfg_j, jnp.float32)))(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            T.lm_params_from_numpy(tree, "cpu"))


def _close(got, want, dtype, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got - want).max())
        assert err <= 5e-2 * scale, f"{what}: {err} of max|ref| {scale}"


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora_rank", [64, 0])
def test_init_mla_attention_tree_matches_jax(q_lora_rank, param_dtype):
    cfg_j, cfg_t = _cfgs(q_lora_rank=q_lora_rank)
    want = jax.eval_shape(lambda k: unbox(jax_attn.init_attention(
        k, cfg_j, jnp.dtype(param_dtype))), jax.random.PRNGKey(0))
    got = attn.init_attention(torch.Generator().manual_seed(0), cfg_t,
                              n=None, dtype=getattr(torch, param_dtype))
    assert sorted(got) == sorted(want)
    assert ("wq_a" in got) == bool(q_lora_rank)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert str(got[key].dtype).split(".")[-1] == leaf.dtype.name, key
    stacked = attn.init_attention(torch.Generator().manual_seed(0), cfg_t,
                                  n=3)
    assert all(stacked[k].shape == (3, *want[k].shape) for k in want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora_rank", [64, 0])
def test_mla_apply_matches_jax(q_lora_rank, dtype, monkeypatch):
    cfg_j, cfg_t = _cfgs(dtype, q_lora_rank=q_lora_rank)
    pj, pt = _params(cfg_j)
    b, s = 2, 40
    x = np.random.default_rng(3).normal(size=(b, s, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    yj, cj = jax.jit(lambda p, x, pos: jax_attn.mla_apply(
        p, cfg_j, x, pos, return_cache=True))(
            pj, jnp.asarray(x).astype(dtype), jnp.asarray(pos))
    calls = []
    flash = flash_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape, v.shape))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention", counted)
    yt, ct = attn.mla_apply(pt, cfg_t, torch.tensor(x).to(getattr(
        torch, dtype)), torch.tensor(pos), return_cache=True)
    # one flash call, V padded from v_head_dim to nope + rope
    assert calls == [((b, s, 8, 24), (b, s, 8, 24))]
    assert yt.dtype == getattr(torch, dtype)
    _close(yt, yj, dtype, "output")
    assert tuple(ct.k.shape) == (b, s, cfg_t.kv_lora_rank)
    assert tuple(ct.v.shape) == (b, s, cfg_t.qk_rope_dim)
    _close(ct.k, cj.k, dtype, "latent")
    _close(ct.v, cj.v, dtype, "rope key")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax_and_clamps_past_the_cache(dtype):
    """Decode at positions inside a 20-slot cache and past it (20, 25:
    both write slot 19), each step's output and the caches compared."""
    cfg_j, cfg_t = _cfgs(dtype)
    pj, pt = _params(cfg_j, seed=1)
    rng = np.random.default_rng(6)
    c0 = rng.normal(size=(2, 20, cfg_t.kv_lora_rank)).astype(np.float32)
    r0 = rng.normal(size=(2, 20, cfg_t.qk_rope_dim)).astype(np.float32)
    dt_j, dt_t = getattr(jnp, dtype), getattr(torch, dtype)
    cache_j = jax_attn.KVCacheEntry(k=jnp.asarray(c0).astype(dt_j),
                                    v=jnp.asarray(r0).astype(dt_j))
    cache_t = attn.KVCacheEntry(k=torch.tensor(c0).to(dt_t),
                                v=torch.tensor(r0).to(dt_t))
    decode = jax.jit(lambda p, x, c, pos: jax_attn.mla_decode(
        p, cfg_j, x, c, pos))
    for pos in (7, 8, 19, 20, 25):
        x = rng.normal(size=(2, 1, 128)).astype(np.float32)
        yj, cache_j = decode(pj, jnp.asarray(x).astype(dt_j), cache_j,
                             jnp.int32(pos))
        yt, new = attn.mla_decode(pt, cfg_t, torch.tensor(x).to(dt_t),
                                  cache_t, pos)
        assert new.k.data_ptr() == cache_t.k.data_ptr()   # in place
        _close(yt, yj, dtype, f"pos {pos}")
        _close(cache_t.k, cache_j.k, dtype, f"latent after pos {pos}")
        _close(cache_t.v, cache_j.v, dtype, f"rope key after pos {pos}")


def test_mla_lm_cache_layout():
    """``init_cache`` gives MLA layers the latent and rope-key entries,
    [n, B, S, R] and [n, B, S, P], in the compute dtype."""
    cfg = get_smoke_config(ARCH)
    cache = T.init_cache(cfg, 3, 10)
    entry = cache["pos0"]
    assert tuple(entry.k.shape) == (2, 3, 10, cfg.kv_lora_rank)
    assert tuple(entry.v.shape) == (2, 3, 10, cfg.qk_rope_dim)
    assert entry.k.dtype == torch.bfloat16
