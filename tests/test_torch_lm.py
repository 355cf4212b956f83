"""The port's decoder-only LM (``repro_torch.models``) against the JAX
package's, for the two ported configs at their smoke widths, with the
JAX package's weights carried across (``lm_params_from_numpy``).

``lm_prefill`` (last-position logits and every cache leaf) and 8
``lm_decode_step`` calls on fixed tokens against a cache of S + 8 are
compared.  fp32 configs at rtol = atol = 1e-4 (fp32 sums in another
order); the configs' own bf16 at 5e-2 of max|logit| (bf16 rounds at other
places in the two frameworks, and the JAX smoke config's naive attention
rounds its probabilities to bf16 where the flash path keeps fp32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import model_api as jax_model_api
from repro.sharding import unbox
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.api import model_api

SEQ, STEPS, BATCH = 12, 8, 2


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The JAX package's init of the arch's smoke config (fp32 parameters
    whatever the compute dtype), as numpy."""
    api = jax_model_api(jax_smoke_config(arch))
    params = jax.jit(lambda k: unbox(api.init(k)))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _merge_jax(zero, pre):
    def merge(z, p):
        if z.shape == p.shape:
            return p.astype(z.dtype)
        return jax.lax.dynamic_update_slice(z, p.astype(z.dtype),
                                            (0,) * z.ndim)
    return jax.tree_util.tree_map(merge, zero, pre)


def _merge_port(zero, pre):
    out = {}
    for k, z in zero.items():
        leaves = []
        for zl, pl in zip(z, pre[k]):
            if zl.shape == pl.shape:
                leaves.append(pl.to(zl.dtype))
            else:
                zl[:, :, : pl.shape[2]] = pl.to(zl.dtype)
                leaves.append(zl)
        out[k] = type(z)(*leaves)
    return out


def _check(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if tol == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got - want).max())
        assert err <= 5e-2 * scale, f"{what}: {err} of max|ref| {scale}"


def _run(arch, dtype):
    cfg_j = jax_smoke_config(arch)
    cfg_t = get_smoke_config(arch)
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype="float32")
        cfg_t = dataclasses.replace(cfg_t, dtype="float32")
    tol = "fp32" if dtype == "float32" else "bf16"
    tree = _jax_params(arch)
    api_j, api_t = jax_model_api(cfg_j), model_api(cfg_t)
    params_t = T.lm_params_from_numpy(tree, "cpu")
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg_t.vocab_size, (BATCH, SEQ)).astype(np.int32)
    steps = rng.integers(1, cfg_t.vocab_size, (STEPS, BATCH, 1)) \
        .astype(np.int32)

    lj, cj = jax.jit(api_j.prefill)(params_j, {"tokens": jnp.asarray(tokens)})
    lt, ct = api_t.prefill(params_t, {"tokens": torch.as_tensor(tokens)})
    _check(lt, lj, tol, "prefill logits")
    for key in cj:
        for name, a, b in zip(cj[key]._fields, ct[key], cj[key]):
            _check(a, b, tol, f"prefill cache {key}.{name}")

    cache_j = _merge_jax(unbox(api_j.init_cache(BATCH, SEQ + STEPS)), cj)
    cache_t = _merge_port(api_t.init_cache(BATCH, SEQ + STEPS), ct)
    decode_j = jax.jit(api_j.decode_step)
    for t in range(STEPS):
        lj, cache_j = decode_j(params_j, cache_j, jnp.asarray(steps[t]),
                               jnp.int32(SEQ + t))
        lt, cache_t = api_t.decode_step(params_t, cache_t,
                                        torch.as_tensor(steps[t]), SEQ + t)
        _check(lt, lj, tol, f"decode step {t} logits")
    for key in cache_j:
        for name, a, b in zip(cache_j[key]._fields, cache_t[key],
                              cache_j[key]):
            _check(a, b, tol, f"decode cache {key}.{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_prefill_and_decode_match_jax(arch, dtype):
    _run(arch, dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_jax_packages(arch):
    from repro.configs import get_config as jax_config
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.pattern == ref.pattern


def test_unported_arch_names_the_roadmap():
    with pytest.raises(KeyError, match="ROADMAP item 14"):
        get_config("jamba-v0.1-52b")


def test_seeded_init_has_the_jax_tree_and_shapes():
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        mine = T.init_lm(torch.Generator().manual_seed(0), cfg)
        ref = _jax_params(arch)
        flat_m = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]}
        flat_r = {jax.tree_util.keystr(k): v.shape for k, v in
                  jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert flat_m == flat_r
