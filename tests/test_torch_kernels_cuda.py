"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Skips with a reason where no CUDA device is visible (a CUDA kernel
has no CPU mode; the CPU tests hold the plain versions to the JAX
package).  This file imports neither JAX nor the JAX package, so it also
runs on a GPU host without them:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

Tolerances as in ``test_torch_dqn_update.py``: gradients rtol 1e-5 /
atol 1e-6; new params atol 1e-6 (Adam's m_hat / sqrt(v_hat) amplifies
rounding where |g| is near eps).  Conv kernels as in
``tests/test_kernels.py``: rtol = atol = 1e-4 in float32, 5e-2 in
bfloat16 (one rounding to bf16 of fp32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.flexai import dqn
from repro_torch.kernels.conv_dataflow import DATAFLOWS, conv2d, conv2d_ref
from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
from repro_torch.kernels.dqn_update import (dqn_td_grads_fused,
                                            dqn_td_update_fused, kernel)
from repro_torch.models.perception.cnn import same_pads

D, A = 58, 11
SHAPES = [(D, 256), (256,), (256, 64), (64,), (64, A), (A,)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what} p{i}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,gamma", [(1, 0.95), (64, 0.95), (100, 0.0),
                                     (128, 0.95)])
def test_td_kernel_matches_plain_on_card(dev, b, gamma):
    rng = np.random.default_rng(b)

    def params(lo=-0.15, hi=0.15):
        return dqn.params_from_numpy(
            [rng.uniform(lo, hi, s) for s in SHAPES], dev)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    batch = {"s": t(rng.normal(size=(b, D))),
             "a": t(rng.integers(0, A, b), torch.int32),
             "r": t(rng.normal(size=b) * 3.0),
             "s_next": t(rng.normal(size=(b, D))),
             "done": t(rng.random(b) < 0.2)}
    ep, tp = params(), params()
    before = kernel.launches
    loss, grads = dqn_td_grads_fused(ep, tp, batch, gamma=gamma)
    loss_ref, grads_ref = dqn.dqn_td_grads(ep, tp, batch, gamma=gamma)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    _close(grads, grads_ref, 1e-5, 1e-6, "grads")
    opt = dqn.AdamState(t(6, torch.int32), params(-1e-3, 1e-3),
                        params(0.0, 1e-6))
    new_p, new_opt, loss = dqn_td_update_fused(ep, tp, opt, batch,
                                               gamma=gamma, lr=1e-3)
    ref_p, ref_opt, loss_ref = dqn.dqn_td_update(ep, tp, opt, batch,
                                                 gamma=gamma, lr=1e-3)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    _close(new_p, ref_p, 0, 1e-6, "params")
    _close(new_opt.mu, ref_opt.mu, 1e-5, 1e-7, "mu")
    _close(new_opt.nu, ref_opt.nu, 1e-5, 1e-12, "nu")
    assert int(new_opt.step) == 7


@pytest.mark.cuda
def test_td_kernel_rejects_what_it_cannot_take(dev):
    rng = np.random.default_rng(0)
    p = dqn.params_from_numpy([rng.uniform(-1, 1, s) for s in SHAPES], dev)
    s = torch.zeros(4, D, device=dev)
    a = torch.zeros(4, dtype=torch.int32, device=dev)
    z = torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        kernel.dqn_td_cuda(s.double(), a, z, s, z, p, p, gamma=0.9)
    with pytest.raises(ValueError, match="expected cuda"):
        kernel.dqn_td_cuda(s, a, z, s, z, p,
                           dqn.DQNParams(*[w.cpu() for w in p]), gamma=0.9)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.dqn_td_cuda(s.t().contiguous().t(), a, z, s, z, p, p,
                           gamma=0.9)


CONV_CASES = [   # (n, h, w, cin, cout, k, stride)
    (1, 8, 8, 4, 8, 3, 1),        # tests/test_kernels.py CONV_SHAPES
    (2, 12, 10, 8, 16, 5, 1),
    (1, 6, 6, 3, 5, 1, 1),
    (2, 16, 16, 16, 32, 3, 1),
    (2, 15, 11, 11, 4, 3, 1),     # Cin = 11: a partial 8-channel tile
    (1, 515, 8, 2, 4, 3, 1),      # Ho = 513 = 64 x 8 + 1: a 1-row tail band
    (1, 227, 227, 3, 201, 11, 4),  # GOTURN's first layer at full width
    (1, 17, 17, 25, 51, 3, 2),    # odd widths, stride 2
    (1, 29, 29, 67, 130, 5, 1),   # more than one channel chunk and tile
]
CONV_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


def _conv_inputs(case, dtype, dev, seed=0):
    n, h, w_, ci, co, k, _ = case
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(n, h, w_, ci)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(k, k, ci, co)) * 0.2,
                     dtype=torch.float32)
    return x.to(dev, dtype), w.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_conv_kernel_matches_plain_on_card(dev, dataflow, case, dtype):
    x, w = _conv_inputs(case, dtype, dev)
    stride = case[-1]
    before = conv_kernel.launches[dataflow]
    got = conv2d(x, w, dataflow=dataflow, stride=stride)
    want = conv2d_ref(x, w, stride)
    torch.cuda.synchronize()
    assert conv_kernel.launches[dataflow] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **CONV_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_conv_kernel_padding_at_even_h_on_card(dev, dataflow):
    """The wrapper's SAME (JAX ``conv2d`` semantics) and the CNN's XLA-SAME
    pad + VALID stride 2, at even H."""
    x, w = _conv_inputs((2, 32, 32, 5, 9, 3, 2), torch.float32, dev, 1)
    for kw in (dict(padding="SAME"),
               dict(padding="VALID")):
        xin = x
        if kw["padding"] == "VALID":
            lo, hi = same_pads(32, 3, 2)
            xin = torch.nn.functional.pad(x, (0, 0, lo, hi, lo, hi))
        got = conv2d(xin, w, dataflow=dataflow, stride=2, **kw)
        want = conv2d(xin, w, dataflow="ref", stride=2, **kw)
        torch.cuda.synchronize()
        assert got.shape == (2, 16, 16, 9)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_conv_kernels_reject_what_they_cannot_take(dev):
    x, w = _conv_inputs((1, 8, 8, 4, 8, 3, 1), torch.float32, dev)
    with pytest.raises(ValueError, match="dtype"):
        conv_kernel.conv2d_cuda(x.double(), w.double(), dataflow="MconvMC")
    with pytest.raises(ValueError, match="expected cuda"):
        conv_kernel.conv2d_cuda(x, w.cpu(), dataflow="SconvOD")
    with pytest.raises(ValueError, match="contiguous"):
        conv_kernel.conv2d_cuda(x.transpose(1, 2), w, dataflow="SconvIC")
    with pytest.raises(ValueError, match="channels"):
        conv_kernel.conv2d_cuda(x, w[:, :, :3].contiguous(),
                                dataflow="MconvMC")
    with pytest.raises(ValueError, match="unknown dataflow"):
        conv_kernel.conv2d_cuda(x, w, dataflow="ref")
