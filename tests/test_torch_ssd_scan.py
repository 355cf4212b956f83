"""The port's SSD scan and Mamba-2 block against the JAX package's.

``ops.ssd_scan`` (on the CPU: the plain chunked scan) against the JAX
``ssd_scan`` in Pallas interpret mode at the JAX kernel tests'
``SSD_SHAPES``; a ragged S against the JAX model's ``ssd_chunked`` (the
Pallas kernel asserts that chunks divide S); the token recurrence
``ssd_ref``; then ``mamba_apply`` (output and the [B,H,P,N] state it
hands to decode) and ``mamba_decode`` at the mamba2 smoke widths.
Tolerances as in ``tests/test_kernels.py``: rtol = atol = 1e-4 in
float32 (fp32 sums in another order), 5e-2 in bfloat16.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import ssm as jax_ssm
from repro.sharding import unbox
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
from repro_torch.models import ssm

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}

SSD_SHAPES = [
    (1, 32, 2, 8, 4, 8),
    (2, 64, 3, 16, 8, 16),
    (1, 48, 1, 8, 16, 16),
]


def _inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, s, h, p)) * 0.3).astype(np.float32),
            (-np.abs(rng.normal(size=(b, s, h))) * 0.2).astype(np.float32),
            (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32))


def _t(x, dtype="float32"):
    return torch.tensor(x).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _close(got, want, dtype="float32", what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype],
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_matches_jax(shape, dtype):
    b, s, h, p, n, chunk = shape
    u, a, Bm, Cm = _inputs(b, s, h, p, n)
    y, state = ssd_scan(_t(u, dtype), _t(a), _t(Bm, dtype), _t(Cm, dtype),
                        chunk=chunk)
    yj, sj = jax_ssd_scan(_j(u, dtype), _j(a), _j(Bm, dtype), _j(Cm, dtype),
                          chunk=chunk, interpret=True)
    assert y.dtype == getattr(torch, dtype) and state.dtype == torch.float32
    assert state.shape == (b, h, n, p)
    _close(y, yj, dtype, "y")
    _close(state, sj, dtype, "state")


@pytest.mark.parametrize("s,chunk", [(45, 16), (333, 100), (7, 16)])
def test_ssd_scan_ragged_matches_jax_ssd_chunked(s, chunk):
    u, a, Bm, Cm = _inputs(2, s, 3, 16, 8, seed=s)
    y, state = ssd_scan(_t(u), _t(a), _t(Bm), _t(Cm), chunk=chunk)
    yj, sj = jax.jit(jax_ssm.ssd_chunked, static_argnums=4)(
        _j(u), _j(a), _j(Bm), _j(Cm), chunk)
    _close(y, yj, what="y")
    # ssd_scan's state is [B,H,N,P]; ssd_chunked's [B,H,P,N]
    _close(state.transpose(-1, -2), sj, what="state")


# shapes the CUDA scan's plan treats apart: H not a multiple of its head
# group, and a chunk far past S (one chunk of S rows, more key tiles than
# its score cache holds)
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 150, 5, 16, 8, 64),
                                             (1, 300, 3, 16, 8, 4096)])
def test_ssd_scan_plan_shapes_match_jax_ssd_chunked(b, s, h, p, n, chunk):
    u, a, Bm, Cm = _inputs(b, s, h, p, n, seed=h)
    y, state = ssd_scan(_t(u), _t(a), _t(Bm), _t(Cm), chunk=chunk)
    yj, sj = jax.jit(jax_ssm.ssd_chunked, static_argnums=4)(
        _j(u), _j(a), _j(Bm), _j(Cm), min(chunk, s))
    _close(y, yj, what="y")
    _close(state.transpose(-1, -2), sj, what="state")


def test_ssd_chunked_with_init_state_matches_jax():
    u, a, Bm, Cm = _inputs(2, 37, 2, 8, 4, seed=1)
    s0 = np.random.default_rng(2).normal(size=(2, 2, 8, 4)).astype(np.float32)
    y, state = ssm.ssd_chunked(_t(u), _t(a), _t(Bm), _t(Cm), 16,
                               init_state=_t(s0))
    yj, sj = jax.jit(jax_ssm.ssd_chunked, static_argnums=4)(
        _j(u), _j(a), _j(Bm), _j(Cm), 16, init_state=_j(s0))
    _close(y, yj)
    _close(state, sj)


def test_ssd_ref_matches_jax():
    u, a, Bm, Cm = _inputs(1, 20, 3, 8, 4, seed=3)
    g = lambda x: x.transpose(0, 2, 1, 3).reshape(3, 20, -1)  # noqa: E731
    ug, ag = g(u), a.transpose(0, 2, 1).reshape(3, 20)
    Bg, Cg = np.repeat(Bm, 3, 0), np.repeat(Cm, 3, 0)
    y, state = ssd_ref(_t(ug), _t(ag), _t(Bg), _t(Cg))
    yj, sj = jax_ssd_ref(_j(ug), _j(ag), _j(Bg), _j(Cg))
    _close(y, yj)
    _close(state, sj)


def _mamba(seed=0):
    cfg_j = replace(jax_smoke_config("mamba2-130m"), dtype="float32")
    cfg_t = replace(get_smoke_config("mamba2-130m"), dtype="float32")
    pj = jax.jit(lambda k: unbox(jax_ssm.init_mamba(k, cfg_j, jnp.float32)))(
        jax.random.PRNGKey(seed))
    pt = {k: torch.tensor(np.asarray(v)) for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


def _jax_apply(cfg):
    return jax.jit(lambda p, x: jax_ssm.mamba_apply(p, cfg, x,
                                                    return_state=True))


@pytest.mark.parametrize("s", [2, 21])
def test_mamba_apply_state_layout_matches_jax(s):
    """mamba_apply(return_state=True): output, the conv history and the SSD
    state in SSMState's [B, H, P, N] layout (the scan returns [B,H,N,P])."""
    cfg_j, cfg_t, pj, pt = _mamba()
    x = np.random.default_rng(s).normal(size=(2, s, 96)).astype(np.float32)
    yj, stj = _jax_apply(cfg_j)(pj, _j(x))
    yt, stt = ssm.mamba_apply(pt, cfg_t, _t(x), return_state=True)
    h, p, n = cfg_t.ssm_heads, cfg_t.ssm_head_dim, cfg_t.ssm_state_dim
    assert stt.ssd.shape == (2, h, p, n)
    _close(yt, yj, what="y")
    _close(stt.conv, stj.conv, what="conv history")
    _close(stt.ssd, stj.ssd, what="ssd state")


def test_mamba_decode_matches_jax():
    cfg_j, cfg_t, pj, pt = _mamba(seed=1)
    x = np.random.default_rng(9).normal(size=(2, 13, 96)).astype(np.float32)
    _, stj = _jax_apply(cfg_j)(pj, _j(x))
    _, stt = ssm.mamba_apply(pt, cfg_t, _t(x), return_state=True)
    decode = jax.jit(lambda p, x, st: jax_ssm.mamba_decode(p, cfg_j, x, st))
    rng = np.random.default_rng(10)
    for step in range(5):
        xt = rng.normal(size=(2, 1, 96)).astype(np.float32)
        yj, stj = decode(pj, _j(xt), stj)
        yt, stt = ssm.mamba_decode(pt, cfg_t, _t(xt), stt)
        _close(yt, yj, what=f"step {step}")
    _close(stt.conv, stj.conv)
    _close(stt.ssd, stj.ssd)


def test_ssd_scan_refuses_other_devices():
    from test_torch_flash_attention import OtherDevice
    u = torch.zeros(1, 4, 2, 8).as_subclass(OtherDevice)
    with pytest.raises(ValueError, match="no ssd_scan route for device 'xpu'"):
        ssd_scan(u, u[..., 0], u[:, :, 0], u[:, :, 0])
    # meta tensors (the dry run's shapes, no data) take the plain scan
    m = torch.zeros(1, 4, 2, 8, device="meta")
    y, state = ssd_scan(m, m[..., 0], m[:, :, 0], m[:, :, 0])
    assert y.device.type == "meta" and y.shape == m.shape
    assert state.shape == (1, 2, 8, 8)
