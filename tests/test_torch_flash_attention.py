"""The port's attention against the JAX package's.

``ops.flash_attention`` (on the CPU: its plain version) against the JAX
``flash_attention`` run in Pallas interpret mode, at the JAX kernel
tests' ``ATTN_SHAPES`` plus ragged lengths; then ``attention_core``,
``gqa_apply`` and ``gqa_decode`` against the JAX ones at the h2o-danube
smoke widths (8 heads over 2 KV heads, head dim 16, window 16): the flash
route (S <= window), SWA with S > window, masked naive attention, and 24
decode steps around the 16-slot ring buffer; MLA's flash route, V
zero-padded to the q/k head dim.  An emulation of the CUDA
kernel's bf16 tensor-core rounding is held to the plain version at the
card's bf16 gate (rtol 1e-2, atol 1e-3).  Tolerances as in
``tests/test_kernels.py``: rtol = atol = 1e-4 in float32 (fp32 sums in
another order), 5e-2 in bfloat16.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jax_attn
from repro.models.config import ModelConfig as JaxModelConfig
from repro.sharding import unbox
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}

ATTN_SHAPES = [
    (1, 64, 4, 4, 32, True),
    (2, 128, 4, 2, 16, True),
    (1, 64, 2, 1, 32, False),   # MQA
    (2, 96, 8, 8, 64, True),
]

# h2o-danube-3-4b's smoke widths (its SMOKE_CONFIG), window 16
DANUBE = dict(name="danube-smoke", family="dense", num_layers=2,
              d_model=128, num_heads=8, num_kv_heads=2, d_ff=256,
              vocab_size=512, sliding_window=16, attention_impl="naive",
              dtype="float32")


def _qkv(b, s, h, kh, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kh, d)).astype(np.float32),
            rng.normal(size=(b, sk, kh, d)).astype(np.float32))


def _t(x, dtype="float32"):
    return torch.tensor(x).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _close(got, want, dtype="float32", what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype],
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(1, 77, 4, 2, 32, True),
                                                 (2, 50, 2, 1, 16, False)])
def test_flash_attention_matches_jax(shape, dtype):
    b, s, h, kh, d, causal = shape
    q, k, v = _qkv(b, s, h, kh, d)
    got = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          causal=causal)
    # the Pallas kernel asserts that its blocks divide S: ragged lengths
    # go to the JAX oracle (attention_ref through XLA) instead
    blk = 32 if s % 32 == 0 else s
    want = jax_flash(_j(q, dtype), _j(k, dtype), _j(v, dtype), causal=causal,
                     block_q=blk, block_k=blk, interpret=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _close(got, want, dtype)


def test_attention_ref_matches_jax():
    from repro.kernels.flash_attention import attention_ref as jax_ref
    q, k, v = _qkv(3, 20, 1, 1, 8, sk=33)
    for causal in (True, False):
        got = attention_ref(_t(q[:, :, 0]), _t(k[:, :, 0]), _t(v[:, :, 0]),
                            causal=causal, scale=0.3)
        want = jax_ref(_j(q[:, :, 0]), _j(k[:, :, 0]), _j(v[:, :, 0]),
                       causal=causal, scale=0.3)
        _close(got, want)


@pytest.mark.parametrize("s,impl", [(12, "naive"), (16, "chunked"),
                                    (40, "naive"), (40, "chunked"),
                                    (700, "chunked")])
@pytest.mark.parametrize("window", [16, None])
def test_attention_core_matches_jax(s, impl, window):
    kw = dict(DANUBE, attention_impl=impl, sliding_window=window)
    q, k, v = _qkv(2, s, 8, 2, 16, seed=s)
    got = attn.attention_core(_t(q), _t(k), _t(v), ModelConfig(**kw),
                              causal=True, window=window)
    want = jax_attn.attention_core(_j(q), _j(k), _j(v), JaxModelConfig(**kw),
                                   causal=True, window=window)
    _close(got, want)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_naive_and_chunked_attention_with_offset_match_jax(q_offset):
    q, k, v = _qkv(2, 9, 4, 2, 16, seed=3, sk=30)
    for window in (None, 8):
        got = attn.naive_attention(_t(q), _t(k), _t(v), causal=True,
                                   scale=0.25, window=window,
                                   q_offset=q_offset)
        want = jax_attn.naive_attention(_j(q), _j(k), _j(v), causal=True,
                                        scale=0.25, window=window,
                                        q_offset=q_offset)
        _close(got, want)
        got = attn.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                     scale=0.25, chunk_kv=7, window=window,
                                     q_offset=q_offset)
        want = jax_attn.chunked_attention(_j(q), _j(k), _j(v), causal=True,
                                          scale=0.25, chunk_kv=7,
                                          window=window, q_offset=q_offset)
        _close(got, want)


def _gqa_params(cfg, seed=0):
    p = jax.jit(lambda k: unbox(jax_attn.init_attention(k, cfg,
                                                        jnp.float32)))(
        jax.random.PRNGKey(seed))
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("s,impl", [(12, "naive"), (40, "naive"),
                                    (40, "chunked")])
def test_gqa_apply_matches_jax(s, impl):
    kw = dict(DANUBE, attention_impl=impl)
    cfg_j, cfg_t = JaxModelConfig(**kw), ModelConfig(**kw)
    pj, pt = _gqa_params(cfg_j)
    x = np.random.default_rng(s).normal(size=(2, s, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    yj, cj = jax.jit(lambda p, x, pos: jax_attn.gqa_apply(
        p, cfg_j, x, pos, window=16, return_cache=True))(
            pj, _j(x), jnp.asarray(pos))
    yt, ct = attn.gqa_apply(pt, cfg_t, _t(x), torch.tensor(pos), window=16,
                            return_cache=True)
    _close(yt, yj)
    _close(ct.k, cj.k)
    _close(ct.v, cj.v)


def test_gqa_decode_ring_buffer_matches_jax():
    """24 decode steps against a 16-slot cache with window 16: the writes
    wrap at step 16 and the cache holds the last 16 positions."""
    cfg_j, cfg_t = JaxModelConfig(**DANUBE), ModelConfig(**DANUBE)
    pj, pt = _gqa_params(cfg_j, seed=1)
    rng = np.random.default_rng(5)
    zeros = np.zeros((2, 16, 2, 16), np.float32)
    cache_j = jax_attn.KVCacheEntry(k=_j(zeros), v=_j(zeros))
    cache_t = attn.KVCacheEntry(k=_t(zeros), v=_t(zeros))
    decode = jax.jit(lambda p, x, c, pos: jax_attn.gqa_decode(
        p, cfg_j, x, c, pos, window=16))
    for pos in range(24):
        x = rng.normal(size=(2, 1, 128)).astype(np.float32)
        yj, cache_j = decode(pj, _j(x), cache_j, jnp.int32(pos))
        yt, cache_t = attn.gqa_decode(pt, cfg_t, _t(x), cache_t, pos,
                                      window=16)
        _close(yt, yj, what=f"step {pos}")
    _close(cache_t.k, cache_j.k)
    _close(cache_t.v, cache_j.v)


def test_gqa_decode_full_cache_matches_jax():
    kw = dict(DANUBE, sliding_window=None)
    cfg_j, cfg_t = JaxModelConfig(**kw), ModelConfig(**kw)
    pj, pt = _gqa_params(cfg_j, seed=2)
    rng = np.random.default_rng(6)
    k0 = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    v0 = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    cache_j = jax_attn.KVCacheEntry(k=_j(k0), v=_j(v0))
    cache_t = attn.KVCacheEntry(k=_t(k0), v=_t(v0))
    decode = jax.jit(lambda p, x, c, pos: jax_attn.gqa_decode(p, cfg_j, x,
                                                              c, pos))
    for pos in (7, 8, 19):
        x = rng.normal(size=(2, 1, 128)).astype(np.float32)
        yj, cache_j = decode(pj, _j(x), cache_j, jnp.int32(pos))
        yt, cache_t = attn.gqa_decode(pt, cfg_t, _t(x), cache_t, pos)
        _close(yt, yj, what=f"pos {pos}")
    _close(cache_t.k, cache_j.k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,impl", [(12, "naive"), (700, "chunked")])
def test_mla_padded_v_flash_route_matches_jax(s, impl, dtype, monkeypatch):
    """MLA's q/k head dim (nope 16 + rope 8) past its V dim (16):
    ``attention_core`` sends it to flash with V zero-padded to 24 and
    keeps the first 16 output columns, at the JAX scale 1/sqrt(24)."""
    kw = dict(DANUBE, attention_impl=impl, sliding_window=None,
              attention_kind="mla", q_lora_rank=8, kv_lora_rank=8,
              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=24,
              num_kv_heads=8)
    rng = np.random.default_rng(s)
    q, k = (rng.normal(size=(2, s, 8, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(2, s, 8, 16)).astype(np.float32)
    calls = []
    flash = attn.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(v.shape))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention", counted)
    got = attn.attention_core(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              ModelConfig(**kw), causal=True)
    want = jax_attn.attention_core(_j(q, dtype), _j(k, dtype),
                                   _j(v, dtype), JaxModelConfig(**kw),
                                   causal=True)
    assert calls == [(2, s, 8, 24)]
    assert tuple(got.shape) == (2, s, 8, 16)
    if dtype == "float32":
        _close(got, want)
    else:
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= 5e-2 * float(np.abs(want).max())


def _emulate_tc_kernel(q, k, v, causal, split=True):
    """The bf16 tensor-core kernel's rounding, step by step in fp32 on the
    CPU: scores from the bf16 q.k products summed in fp32, per 64-key tile
    the running max (log2 domain, log2(e) folded into the scale, masked
    scores -1e30), P = exp2(s - m) fed to P.V as bf16 (as hi + lo, the
    bf16 rounding of P and of its rest, when ``split``), fp32 sums, one
    final division by the fp32 row sum and one rounding to bf16."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    sl2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, 64):
        s = qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
        cols = torch.arange(k0, min(k0 + 64, skv))[None]
        if causal:
            s = torch.where(rows >= cols, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        p = torch.exp2(s * sl2 - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + 64]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + 64]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype)


def _bf16_gate_misses(got, want):
    """Elements past the card's bf16 gate: atol 1e-3 + rtol 1e-2 |want|."""
    err = (got.double() - want.double()).abs()
    return int((err > 1e-3 + 1e-2 * want.double().abs()).sum())


def _bf16_qkv(b, s, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=(b, s, n, d)),
                              dtype=torch.float32).bfloat16()
                 for n in (h, kh, kh))


@pytest.mark.parametrize("shape", [(2, 1491, 4, 4, 64, True),
                                   (1, 77, 4, 2, 64, True),
                                   (2, 128, 4, 2, 16, True)])
def test_tc_kernel_rounding_within_the_bf16_gate(shape):
    """P carried to the tensor cores as a bf16 pair stays within the card's
    bf16 gate of the plain version (``chip_smoke.py`` KERNEL_TOL)."""
    b, s, h, kh, d, causal = shape
    q, k, v = _bf16_qkv(b, s, h, kh, d)
    got = _emulate_tc_kernel(q, k, v, causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_gate_misses(got, want) == 0


def test_single_bf16_p_would_miss_the_bf16_gate():
    """Why the kernel splits P: rounded once to bf16, P moves outputs of
    rows that see few keys past the gate."""
    q, k, v = _bf16_qkv(2, 1491, 4, 4, 64)
    got = _emulate_tc_kernel(q, k, v, True, split=False)
    want = flash_attention_ref(q, k, v, causal=True)
    assert _bf16_gate_misses(got, want) > 0


class OtherDevice(torch.Tensor):
    """A tensor on a device the kernel ops have no route for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_flash_attention_refuses_other_devices():
    q = torch.zeros(1, 4, 2, 8).as_subclass(OtherDevice)
    with pytest.raises(ValueError,
                       match="no flash_attention route for device 'xpu'"):
        flash_attention(q, q, q)
    # meta tensors (the dry run's shapes, no data) take the plain version
    m = torch.zeros(1, 4, 2, 8, device="meta")
    out = flash_attention(m, m, m)
    assert out.device.type == "meta" and out.shape == m.shape
