"""The port's TD update against the JAX package's.

Inputs are made with numpy from a seed and go through both:
``repro.core.flexai.dqn`` (autodiff) and ``repro.kernels.dqn_update``'s
Pallas kernel in interpret mode on one side, the port's plain version and
its fused entry points (CPU tensors take the plain route) on the other.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by ``test_torch_kernels_cuda.py``.

Tolerances: loss and gradients rtol 1e-5 / atol 1e-6 (fp32 sums taken in
another order).  New params atol 1e-6, about lr x 1e-3: Adam's
m_hat / sqrt(v_hat) divides by |g| where |g| is near eps, so a rounding
difference in a tiny gradient moves its parameter by up to lr times a
small factor.  The Adam moments inherit the gradients' tolerance scaled
by (1 - beta).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flexai import dqn as dqn_jax
from repro.kernels.dqn_update import (dqn_td_grads_fused as grads_pallas,
                                      dqn_td_update_fused as update_pallas)
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.kernels.dqn_update import (dqn_td_grads_fused,
                                            dqn_td_update_fused)

D, A = 58, 11          # state_dim / n_actions of the 11-core HMAI platform
LR = 1e-3
td_grads_jax = jax.jit(dqn_jax.dqn_td_grads, static_argnames=("gamma",))
td_update_jax = jax.jit(dqn_jax.dqn_td_update, static_argnames=("gamma", "lr"))
SHAPES = [(D, 256), (256,), (256, 64), (64,), (64, A), (A,)]


def _params(rng):
    out = []
    for shape in SHAPES:
        lim = np.sqrt(6.0 / (shape[0] + (shape[1] if len(shape) > 1 else 1)))
        out.append(rng.uniform(-lim, lim, shape).astype(np.float32))
    return out


def _batch(rng, b, all_done=False):
    return {
        "s": rng.normal(size=(b, D)).astype(np.float32),
        "a": rng.integers(0, A, b).astype(np.int32),
        "r": (rng.normal(size=b) * 3.0).astype(np.float32),
        "s_next": rng.normal(size=(b, D)).astype(np.float32),
        "done": (np.ones(b) if all_done
                 else (rng.random(b) < 0.2)).astype(np.float32),
    }


def _adam(rng, step):
    """A mid-run Adam state: moments of the size a few updates leave."""
    mu = [(rng.normal(size=s) * 1e-3).astype(np.float32) for s in SHAPES]
    nu = [(rng.random(s) * 1e-6).astype(np.float32) for s in SHAPES]
    return step, mu, nu


def _inputs(seed, b, all_done):
    rng = np.random.default_rng(seed)
    return _params(rng), _params(rng), _batch(rng, b, all_done), \
        _adam(rng, 6)


def _jax_params(arrays):
    return dqn_jax.DQNParams(*[jnp.asarray(a) for a in arrays])


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} p{i}")


CASES = [(b, gamma, False) for b in (1, 64, 100, 128) for gamma in (0.0, 0.95)]
CASES.append((64, 0.95, True))   # all done: the TargNet term vanishes


@pytest.mark.parametrize("b,gamma,all_done", CASES)
def test_td_grads_match_jax(b, gamma, all_done):
    ep, tp, batch, _ = _inputs(b, b, all_done)
    jb = _jax_batch(batch)
    loss_ref, g_ref = td_grads_jax(_jax_params(ep), _jax_params(tp), jb,
                                   gamma=gamma)
    loss_pl, g_pl = grads_pallas(_jax_params(ep), _jax_params(tp), jb,
                                 gamma=gamma, interpret=True)
    tb = _torch_batch(batch)
    pe, pt = dqn_t.params_from_numpy(ep), dqn_t.params_from_numpy(tp)
    for fn in (dqn_t.dqn_td_grads, dqn_td_grads_fused):
        loss, grads = fn(pe, pt, tb, gamma=gamma)
        for want_loss, want in ((loss_ref, g_ref), (loss_pl, g_pl)):
            np.testing.assert_allclose(float(loss), float(want_loss),
                                       rtol=1e-5, atol=1e-6)
            _close(grads, want, 1e-5, 1e-6, fn.__name__)


@pytest.mark.parametrize("b,gamma,all_done", CASES)
def test_td_update_matches_jax(b, gamma, all_done):
    ep, tp, batch, (step, mu, nu) = _inputs(b + 1000, b, all_done)
    jb = _jax_batch(batch)
    opt_j = dqn_jax.AdamState(jnp.int32(step), _jax_params(mu),
                              _jax_params(nu))
    refs = [td_update_jax(_jax_params(ep), _jax_params(tp), opt_j, jb,
                          gamma=gamma, lr=LR),
            update_pallas(_jax_params(ep), _jax_params(tp), opt_j, jb,
                          gamma=gamma, lr=LR, interpret=True)]
    tb = _torch_batch(batch)
    pe, pt = dqn_t.params_from_numpy(ep), dqn_t.params_from_numpy(tp)
    opt_t = dqn_t.AdamState(torch.tensor(step, dtype=torch.int32),
                            dqn_t.params_from_numpy(mu),
                            dqn_t.params_from_numpy(nu))
    for fn in (dqn_t.dqn_td_update, dqn_td_update_fused):
        new_p, new_opt, loss = fn(pe, pt, opt_t, tb, gamma=gamma, lr=LR)
        assert int(new_opt.step) == step + 1
        for want_p, want_opt, want_loss in refs:
            np.testing.assert_allclose(float(loss), float(want_loss),
                                       rtol=1e-5, atol=1e-6)
            _close(new_p, want_p, 0, 1e-6, "params")
            # mu moves by (1 - beta1) x the gradient's own difference
            _close(new_opt.mu, want_opt.mu, 1e-5, 1e-7, "mu")
            _close(new_opt.nu, want_opt.nu, 1e-5, 1e-12, "nu")


def test_fresh_adam_update_matches_jax():
    """The first update of a run (step 0, zero moments)."""
    ep, tp, batch, _ = _inputs(7, 64, False)
    opt_j = dqn_jax._adam_init(_jax_params(ep))
    want_p, _, want_loss = td_update_jax(
        _jax_params(ep), _jax_params(tp), opt_j, _jax_batch(batch), lr=LR)
    pe = dqn_t.params_from_numpy(ep)
    new_p, new_opt, loss = dqn_td_update_fused(
        pe, dqn_t.params_from_numpy(tp), dqn_t.adam_init(pe),
        _torch_batch(batch), lr=LR)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _close(new_p, want_p, 0, 1e-6, "params")
    assert int(new_opt.step) == 1


def test_params_round_trip_through_shared_npz(tmp_path):
    rng = np.random.default_rng(3)
    arrays = _params(rng)
    dqn_jax.save_dqn_npz(str(tmp_path / "jax.npz"), _jax_params(arrays))
    got = dqn_t.load_dqn_npz(str(tmp_path / "jax.npz"))
    _close(got, arrays, 0, 0, "jax->torch")
    dqn_t.save_dqn_npz(str(tmp_path / "torch.npz"), got)
    back = dqn_jax.load_dqn_npz(str(tmp_path / "torch.npz"))
    _close(back, arrays, 0, 0, "torch->jax")
    direct = dqn_t.params_from_numpy(_jax_params(arrays))
    _close(direct, arrays, 0, 0, "params_from_numpy")
    assert all(p.dtype == torch.float32 for p in direct)
    with pytest.raises(ValueError):
        dqn_t.params_from_numpy(arrays[:5])


def test_qnet_apply_matches_jax():
    rng = np.random.default_rng(5)
    arrays = _params(rng)
    x = rng.normal(size=(9, D)).astype(np.float32)
    want = dqn_jax.qnet_apply(_jax_params(arrays), jnp.asarray(x))
    got = dqn_t.qnet_apply(dqn_t.params_from_numpy(arrays),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.dqn_update.kernel import dqn_td_cuda
    ep, tp, batch, _ = _inputs(1, 4, False)
    tb = _torch_batch(batch)
    with pytest.raises(ValueError, match="CUDA"):
        dqn_td_cuda(tb["s"], tb["a"], tb["r"], tb["s_next"], tb["done"],
                    dqn_t.params_from_numpy(ep), dqn_t.params_from_numpy(tp),
                    gamma=0.95)


@pytest.mark.parametrize("d,a_n", [(58, 11), (28, 5)])   # HMAI n = 11, n = 5
def test_td_update_trajectory_matches_jax(d, a_n):
    """64 chained updates (the fused entry point's CPU route against the
    JAX package's ``dqn_td_update``), fresh batches each step and the
    TargNet synced every 8: params within 1e-5 after the 64th, the
    reference tolerance over a 64-update trajectory that the CUDA kernel
    is held to on the card."""
    rng = np.random.default_rng(d)
    shapes = [(d, 256), (256,), (256, 64), (64,), (64, a_n), (a_n,)]
    init = [rng.uniform(-0.15, 0.15, s).astype(np.float32) for s in shapes]
    pj = targ_j = _jax_params(init)
    opt_j = dqn_jax._adam_init(pj)
    pt = targ_t = dqn_t.params_from_numpy(init)
    opt_t = dqn_t.adam_init(pt)
    for step in range(64):
        batch = {"s": rng.normal(size=(64, d)).astype(np.float32),
                 "a": rng.integers(0, a_n, 64).astype(np.int32),
                 "r": (rng.normal(size=64) * 3.0).astype(np.float32),
                 "s_next": rng.normal(size=(64, d)).astype(np.float32),
                 "done": (rng.random(64) < 0.2).astype(np.float32)}
        pj, opt_j, loss_j = td_update_jax(pj, targ_j, opt_j,
                                          _jax_batch(batch), lr=LR)
        pt, opt_t, loss_t = dqn_td_update_fused(pt, targ_t, opt_t,
                                                _torch_batch(batch), lr=LR)
        if step % 8 == 7:
            targ_j, targ_t = pj, pt
    assert int(opt_t.step) == 64
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5,
                               atol=1e-6)
    _close(pt, pj, 0, 1e-5, "params after 64 updates")
