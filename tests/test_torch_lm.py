"""The port's LMs (``repro_torch.models``) against the JAX package's, for
every config of the registry at its smoke widths, with the JAX package's
weights carried across (``lm_params_from_numpy``).

The prefill (last-position logits and every cache leaf) and 8 decode
steps on fixed tokens against a cache of S + 8 are compared.  A frontend
config's batch carries seeded N(0, 1) ``frontend_embeds``: internvl2's
patches are prepended, so its cache holds them too and decoding starts
after them; seamless's frames are the encoder's source (3 frames, in a
cross cache of (S + 8) // 4 = 5 rows, zero-padded as the serving engine
merges it).  fp32 configs at rtol = atol = 1e-4 (fp32 sums in another
order); the configs' own bf16 at 5e-2 of max|logit| (bf16 rounds at other
places in the two frameworks, and the JAX smoke config's naive attention
rounds its probabilities to bf16 where the flash path keeps fp32).

MoE configs: every router call of both packages is recorded and held by
``test_torch_moe.check_routing`` (logits at the gate, a top-k difference
only at a tie within their difference).  A prefill or decode step whose
logits miss the gate must come after such a difference, and the cache
rows of the layers after it at the token it moved are not compared.
Parameters in bf16 (``param_dtype``): the port's init has the JAX tree's
dtypes, and a bf16 JAX tree carried across prefills to the JAX logits.
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
from repro_torch.models import moe
from repro_torch.models.api import model_api
from test_torch_moe import check_routing, kept_experts, record_routers

SEQ, STEPS, BATCH = 12, 8, 2
T_SRC = 3    # an encoder-decoder's source frames


def frontend_rows(cfg, t_src=T_SRC) -> int:
    """The rows of a prefill batch's ``frontend_embeds``: a VLM's patches
    or an encoder-decoder's ``t_src`` frames (0: no frontend)."""
    if cfg.frontend is None:
        return 0
    return t_src if cfg.is_encoder_decoder else cfg.num_frontend_tokens


@functools.lru_cache(maxsize=None)
def _jax_params(arch, param_dtype="float32"):
    """The JAX package's init of the arch's smoke config (parameters in
    ``param_dtype`` whatever the compute dtype), as numpy."""
    api = jax_model_api(dataclasses.replace(jax_smoke_config(arch),
                                            param_dtype=param_dtype))
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


def _check(got, want, tol, what, skip=()):
    """``skip``: (layer index, batch, position) cache rows left out."""
    got = got.detach().float().numpy().copy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    for row in skip:
        got[row] = want[row]
    if tol == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got - want).max())
        assert err <= 5e-2 * scale, f"{what}: {err} of max|ref| {scale}"


class _Routers:
    """The MoE calls of both packages, taken a prefill or decode step at
    a time and held by ``check_routing``.  A token whose kept experts
    differ in a layer (another top k, or a slot lost to capacity after
    an earlier token's change) feeds every later layer another input:
    its rows there are left out of the router and cache checks."""

    def __init__(self, cfg, dtype, monkeypatch):
        self.cfg = cfg
        self.layers = [l for l in range(cfg.num_layers)
                       if cfg.is_moe_layer(l)]
        self.k = cfg.num_experts_per_token
        self.dtype = dtype
        self.period = len(T.block_specs(cfg))
        self.n_super = cfg.num_layers // self.period
        self.calls = record_routers(monkeypatch) if self.layers else None
        self.done = 0
        self.moved = []      # (layer, batch, position)

    def step(self, position_of_row) -> int:
        """Held the calls since the last step; returns how many tokens'
        kept experts have differed so far."""
        if self.calls is None:
            return 0
        jc, pc = self.calls
        assert len(jc) == len(pc) == self.done + len(self.layers)
        n_rows = jc[self.done].shape[0]
        rows = {position_of_row(r): r for r in range(n_rows)}
        cap = moe._capacity(self.cfg, n_rows)
        for c, layer in enumerate(self.layers):
            a, b = jc[self.done + c], pc[self.done + c]
            skip = [rows[(bt, p)] for l, bt, p in self.moved
                    if l < layer and (bt, p) in rows]
            check_routing(a, b, self.k, self.dtype, skip)
            self.moved += [
                (layer, *position_of_row(r)) for r, (x, y) in enumerate(zip(
                    kept_experts(a, self.k, cap), kept_experts(b, self.k,
                                                               cap)))
                if x != y]
        self.done = len(jc)
        return len(self.moved)

    def skip(self, key, entry):
        """Rows of cache entry ``pos{i}`` after a moved token's layer: a
        KV leaf [n_super, B, S, ...] at the token, an SSM state leaf
        [n_super, B, ...] whole (it folds in every token)."""
        if not self.moved:
            return []
        i = int(key[3:])
        kv = entry._fields == ("k", "v")
        return [(j, b, p) if kv else (j, b) for layer, b, p in self.moved
                for j in range(self.n_super)
                if j * self.period + i > layer]


def _check_logits(got, want, tol, what, flips):
    try:
        _check(got, want, tol, what)
    except AssertionError:
        if not flips:
            raise


def _run(arch, dtype, monkeypatch, param_dtype="float32", steps=STEPS,
         t_src=T_SRC):
    cfg_j = jax_smoke_config(arch)
    cfg_t = get_smoke_config(arch)
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype="float32")
        cfg_t = dataclasses.replace(cfg_t, dtype="float32")
    tol = "fp32" if dtype == "float32" else "bf16"
    tree = _jax_params(arch, param_dtype)
    api_j, api_t = jax_model_api(cfg_j), model_api(cfg_t)
    params_t = T.lm_params_from_numpy(tree, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params_t)):
        assert b.dtype == getattr(torch, param_dtype)
        assert a.tobytes() == b.view(torch.int16 if param_dtype ==
                                     "bfloat16" else b.dtype).numpy() \
            .tobytes()
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg_t.vocab_size, (BATCH, SEQ)).astype(np.int32)
    tokens_at = rng.integers(1, cfg_t.vocab_size, (STEPS, BATCH, 1)) \
        .astype(np.int32)
    batch = {"tokens": tokens}
    n_front = frontend_rows(cfg_t, t_src)
    if n_front:
        batch["frontend_embeds"] = rng.standard_normal(
            (BATCH, n_front, cfg_t.d_model)).astype(np.float32)
    # decode positions start after the prefilled rows (the prompt and a
    # decoder-only frontend's patches)
    rows = SEQ + (0 if cfg_t.is_encoder_decoder else n_front)
    routers = _Routers(cfg_t, dtype, monkeypatch)

    lj, cj = jax.jit(api_j.prefill)(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, ct = api_t.prefill(
        params_t, {k: torch.as_tensor(v) for k, v in batch.items()})
    flips = routers.step(lambda r: divmod(r, SEQ))
    _check_logits(lt, lj, tol, "prefill logits", flips)
    for key in cj:
        for name, a, b in zip(cj[key]._fields, ct[key], cj[key]):
            _check(a, b, tol, f"prefill cache {key}.{name}",
                   routers.skip(key, cj[key]))

    cache_j = _merge_jax(unbox(api_j.init_cache(BATCH, rows + STEPS)), cj)
    cache_t = _merge_port(api_t.init_cache(BATCH, rows + STEPS), ct)
    decode_j = jax.jit(api_j.decode_step)
    for t in range(steps):
        lj, cache_j = decode_j(params_j, cache_j, jnp.asarray(tokens_at[t]),
                               jnp.int32(rows + t))
        lt, cache_t = api_t.decode_step(params_t, cache_t,
                                        torch.as_tensor(tokens_at[t]),
                                        rows + t)
        flips = routers.step(lambda r, t=t: (r, rows + t))
        _check_logits(lt, lj, tol, f"decode step {t} logits", flips)
    for key in cache_j:
        for name, a, b in zip(cache_j[key]._fields, cache_t[key],
                              cache_j[key]):
            _check(a, b, tol, f"decode cache {key}.{name}",
                   routers.skip(key, cache_j[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    _run(arch, dtype, monkeypatch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_jax_packages(arch):
    from repro.configs import get_config as jax_config
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.pattern == ref.pattern


def test_unported_arch_names_the_roadmap():
    """Every id of the JAX registry is ported, in its order; an unknown id
    raises the KeyError that names the known ones."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    for lookup in (get_config, get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch 'gpt-0'.*"
                                           "seamless-m4t-medium"):
            lookup("gpt-0")


def test_seeded_init_has_the_jax_tree_and_shapes():
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        mine = model_api(cfg).init(torch.Generator().manual_seed(0))
        ref = _jax_params(arch, "float32")
        flat_m = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]}
        flat_r = {jax.tree_util.keystr(k): v.shape for k, v in
                  jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert flat_m == flat_r


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_params_init_as_jax_and_carry_across(arch, monkeypatch):
    """``param_dtype="bfloat16"``: the port's init has the JAX init's
    leaves, shapes and dtypes, and a bf16 JAX tree carried across
    prefills (and decodes twice) to the JAX logits (bf16 compute, bf16
    gate)."""
    cfg_t = dataclasses.replace(get_smoke_config(arch),
                                param_dtype="bfloat16")
    cfg_j = dataclasses.replace(jax_smoke_config(arch),
                                param_dtype="bfloat16")
    mine = model_api(cfg_t).init(torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda k: unbox(jax_model_api(cfg_j).init(k)),
                         jax.random.PRNGKey(0))
    flat_m = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
              for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    flat_r = {jax.tree_util.keystr(k): (v.shape, "torch." + v.dtype.name)
              for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert flat_m == flat_r
    _run(arch, "bfloat16", monkeypatch, param_dtype="bfloat16", steps=2)
