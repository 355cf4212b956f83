"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Skips with a reason where no CUDA device is visible (a CUDA kernel
has no CPU mode; the CPU tests hold the plain versions to the JAX
package).  This file imports neither JAX nor the JAX package, so it also
runs on a GPU host without them:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

Tolerances as in ``test_torch_dqn_update.py``: gradients rtol 1e-5 /
atol 1e-6; new params atol 1e-6 (Adam's m_hat / sqrt(v_hat) amplifies
rounding where |g| is near eps).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.flexai import dqn
from repro_torch.kernels.dqn_update import (dqn_td_grads_fused,
                                            dqn_td_update_fused, kernel)

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
