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
bfloat16.  Flash-attention and SSD-scan kernels: rtol = atol = 1e-4 in
float32; in bfloat16 rtol 1e-2, atol 1e-3: the plain versions sum in fp32
and round once to bf16, the SSD kernel does the same, and the flash
kernel carries P to the tensor cores as a bf16 pair hi + lo (2^-17 of a
weight), so both sides stay about one bf16 step (2^-7 of the value)
apart, while a dropped or doubled KV tile or chunk moves an output far
more.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.flexai import dqn
from repro_torch.kernels.conv_dataflow import DATAFLOWS, conv2d, conv2d_ref
from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
from repro_torch.kernels.dqn_update import (dqn_td_grads_fused,
                                            dqn_td_grads_lanes,
                                            dqn_td_grads_lanes_ref,
                                            dqn_td_update_fused,
                                            dqn_td_update_lanes,
                                            dqn_td_update_lanes_ref, kernel)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models.perception.cnn import same_pads

D, A = 58, 11
D_STAGE = 70   # the stage agent's observation (core.pipeline): 4 + 6n
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


def _td_case(seed, b, d, a_n, dev):
    """Seeded nets, batch and a mid-run Adam state at widths (d, a_n)."""
    rng = np.random.default_rng(seed)
    shapes = [(d, 256), (256,), (256, 64), (64,), (64, a_n), (a_n,)]

    def params(lo=-0.15, hi=0.15):
        return dqn.params_from_numpy(
            [rng.uniform(lo, hi, s) for s in shapes], dev)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    batch = {"s": t(rng.normal(size=(b, d))),
             "a": t(rng.integers(0, a_n, b), torch.int32),
             "r": t(rng.normal(size=b) * 3.0),
             "s_next": t(rng.normal(size=(b, d))),
             "done": t(rng.random(b) < 0.2)}
    ep, tp = params(), params()
    opt = dqn.AdamState(t(6, torch.int32), params(-1e-3, 1e-3),
                        params(0.0, 1e-6))
    return ep, tp, batch, opt


# (b, gamma, state_dim, n_actions): the main path's batches, then batches
# around the cluster kernel's 64-row pass (one short of it, one past it,
# several passes) at HMAI n = 11 and n = 5, then the stage agent's width
# (D = 70, not 3 + 5n) at its batch
TD_CASES = ([(1, 0.95, D, A), (64, 0.95, D, A), (100, 0.0, D, A),
             (128, 0.95, D, A)]
            + [(b, 0.95, d, a_n) for b in (63, 65, 257)
               for d, a_n in ((D, A), (28, 5))] + [(1, 0.95, 28, 5),
                                                    (64, 0.95, D_STAGE, A)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,gamma,d,a_n", TD_CASES)
def test_td_kernel_matches_plain_on_card(dev, b, gamma, d, a_n):
    ep, tp, batch, opt = _td_case(b + d, b, d, a_n, dev)
    before = kernel.launches
    loss, grads = dqn_td_grads_fused(ep, tp, batch, gamma=gamma)
    loss_ref, grads_ref = dqn.dqn_td_grads(ep, tp, batch, gamma=gamma)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    _close(grads, grads_ref, 1e-5, 1e-6, "grads")
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
def test_td_kernel_with_unaligned_weights_on_card(dev):
    """Weights 4 bytes past a 16-byte boundary take the kernel's 4-byte
    copies; the result is the plain version's."""
    ep, tp, batch, opt = _td_case(3, 64, D, A, dev)

    def shifted(params):
        out = []
        for w in params:
            buf = torch.empty(w.numel() + 1, device=dev)
            view = buf[1:].view(w.shape)
            view.copy_(w)
            out.append(view)
        return dqn.DQNParams(*out)

    ep_u, tp_u = shifted(ep), shifted(tp)
    assert ep_u.w1.data_ptr() % 16 != 0
    loss, grads = dqn_td_grads_fused(ep_u, tp_u, batch)
    loss_ref, grads_ref = dqn.dqn_td_grads(ep, tp, batch)
    new_p, _, _ = dqn_td_update_fused(ep_u, tp_u, opt, batch, lr=1e-3)
    ref_p, _, _ = dqn.dqn_td_update(ep, tp, opt, batch, lr=1e-3)
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    _close(grads, grads_ref, 1e-5, 1e-6, "grads")
    _close(new_p, ref_p, 0, 1e-6, "params")


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


@pytest.mark.cuda
def test_td_kernel_width_envelope_on_card(dev):
    """The cluster's shared-memory layout holds HMAI widths up to n = 16
    (D = 83, A = 16); n = 17 (D = 88, A = 17) is refused before any
    launch."""
    lib = kernel._lib()
    assert (lib.dqn_td_smem_bytes(83, 16) <= kernel.SMEM_LIMIT
            < lib.dqn_td_smem_bytes(88, 17))
    ep, tp, batch, _ = _td_case(16, 64, 83, 16, dev)
    loss, grads = dqn_td_grads_fused(ep, tp, batch)
    loss_ref, grads_ref = dqn.dqn_td_grads(ep, tp, batch)
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    _close(grads, grads_ref, 1e-5, 1e-6, "grads at n = 16")
    ep, tp, batch, _ = _td_case(17, 4, 88, 17, dev)
    before = kernel.launches
    with pytest.raises(ValueError, match="shared memory"):
        dqn_td_grads_fused(ep, tp, batch)
    assert kernel.launches == before


def _td_lanes_case(seed, lanes, b, dev, shared, d=D):
    """L lanes of seeded batches and Adam states at state width ``d``;
    nets shared by every lane (the data-parallel trainer's layout) or one
    set a lane (the population trainer's)."""
    cases = [_td_case(seed + i, b, d, A, dev) for i in range(lanes)]

    def stack(trees):
        return type(trees[0])(*[torch.stack(x) for x in zip(*trees)])

    ep = cases[0][0] if shared else stack([c[0] for c in cases])
    tp = cases[0][1] if shared else stack([c[1] for c in cases])
    batch = {k: torch.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    opt = dqn.AdamState(torch.arange(lanes, dtype=torch.int32, device=dev)
                        + 3, stack([c[3].mu for c in cases]),
                        stack([c[3].nu for c in cases]))
    return ep, tp, batch, opt


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-lane"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 16])
def test_td_lanes_kernel_matches_plain_on_card(dev, lanes, shared):
    """One launch a call for all lanes, each lane within the single-lane
    tolerances of the lane-batched plain version, both variants."""
    ep, tp, batch, opt = _td_lanes_case(lanes, lanes, 64, dev, shared)
    before = kernel.launches
    loss, grads = dqn_td_grads_lanes(ep, tp, batch)
    new_p, new_opt, loss_u = dqn_td_update_lanes(ep, tp, opt, batch,
                                                 lr=1e-3)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    loss_r, grads_r = dqn_td_grads_lanes_ref(ep, tp, batch)
    ref_p, ref_opt, loss_ur = dqn_td_update_lanes_ref(ep, tp, opt, batch,
                                                      lr=1e-3)
    assert loss.shape == (lanes,) and grads.w1.shape == (lanes, D, 256)
    np.testing.assert_allclose(loss.cpu().numpy(), loss_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    _close(grads, grads_r, 1e-5, 1e-6, "grads")
    np.testing.assert_allclose(loss_u.cpu().numpy(), loss_ur.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    _close(new_p, ref_p, 0, 1e-6, "params")
    _close(new_opt.mu, ref_opt.mu, 1e-5, 1e-7, "mu")
    _close(new_opt.nu, ref_opt.nu, 1e-5, 1e-12, "nu")
    assert torch.equal(new_opt.step, opt.step + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-lane"])
def test_td_lanes_kernel_at_the_stage_width_on_card(dev, shared):
    """The lane launch at the stage agent's width (D = 70, A = 11, B 64,
    L = 4), both variants, as the stage trainers call it: the DP
    trainer's grads with the nets shared, the population's Adam with a
    net a lane."""
    ep, tp, batch, opt = _td_lanes_case(70, 4, 64, dev, shared, D_STAGE)
    before = kernel.launches
    loss, grads = dqn_td_grads_lanes(ep, tp, batch)
    new_p, new_opt, loss_u = dqn_td_update_lanes(ep, tp, opt, batch,
                                                 lr=1e-3)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert grads.w1.shape == (4, D_STAGE, 256)
    loss_r, grads_r = dqn_td_grads_lanes_ref(ep, tp, batch)
    ref_p, ref_opt, loss_ur = dqn_td_update_lanes_ref(ep, tp, opt, batch,
                                                      lr=1e-3)
    np.testing.assert_allclose(loss.cpu().numpy(), loss_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    _close(grads, grads_r, 1e-5, 1e-6, "grads")
    np.testing.assert_allclose(loss_u.cpu().numpy(), loss_ur.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    _close(new_p, ref_p, 0, 1e-6, "params")
    _close(new_opt.mu, ref_opt.mu, 1e-5, 1e-7, "mu")
    _close(new_opt.nu, ref_opt.nu, 1e-5, 1e-12, "nu")


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-lane"])
def test_td_lanes_kernel_one_lane_is_the_single_launch_on_card(dev, shared):
    """L = 1 gives the bits of the unbatched launch, and every lane of an
    L = 4 launch the bits of that lane launched alone; two calls give the
    same bits."""
    ep, tp, batch, opt = _td_lanes_case(7, 4, 64, dev, shared)

    def lane(i):
        nets = [n if shared else dqn.DQNParams(*[w[i] for w in n])
                for n in (ep, tp)]
        o = dqn.AdamState(opt.step[i], dqn.DQNParams(*[m[i] for m in opt.mu]),
                          dqn.DQNParams(*[v[i] for v in opt.nu]))
        return nets, {k: v[i] for k, v in batch.items()}, o

    loss4, grads4 = dqn_td_grads_lanes(ep, tp, batch)
    again = dqn_td_grads_lanes(ep, tp, batch)[1]
    new4, opt4, _ = dqn_td_update_lanes(ep, tp, opt, batch, lr=1e-3)
    for i in range(4):
        (e, t), b, o = lane(i)
        loss1, grads1 = dqn_td_grads_fused(e, t, b)
        one = {k: v[None] for k, v in b.items()}
        nets1 = [n if shared else dqn.DQNParams(*[w[None] for w in n])
                 for n in (e, t)]
        loss_l1, grads_l1 = dqn_td_grads_lanes(*nets1, one)
        new1, opt1, _ = dqn_td_update_fused(e, t, o, b, lr=1e-3)
        assert torch.equal(loss_l1[0], loss1) and torch.equal(loss4[i], loss1)
        for g4, g1, gl, g2 in zip(grads4, grads1, grads_l1, again):
            assert torch.equal(g4[i], g1) and torch.equal(gl[0], g1)
            assert torch.equal(g2[i], g4[i])
        for n4, n1 in zip((*new4, *opt4.mu, *opt4.nu),
                          (*new1, *opt1.mu, *opt1.nu)):
            assert torch.equal(n4[i], n1)


@pytest.mark.cuda
def test_td_lanes_kernel_rejects_what_it_cannot_take(dev):
    ep, tp, batch, opt = _td_lanes_case(5, 2, 16, dev, shared=False)
    before = kernel.launches
    flat = {k: v[0] for k, v in batch.items()}
    with pytest.raises(ValueError, match=r"\[L, B, D\]"):
        kernel.dqn_td_lanes_cuda(flat["s"], flat["a"], flat["r"],
                                 flat["s_next"], flat["done"], ep, tp,
                                 gamma=0.9)
    short = dqn.DQNParams(*[w[:1] for w in ep])      # 1 lane of nets for 2
    with pytest.raises(ValueError, match="shape"):
        dqn_td_grads_lanes(short, tp, batch)
    with pytest.raises(ValueError, match="step"):
        dqn_td_update_lanes(ep, tp, opt._replace(step=opt.step[0]), batch)
    with pytest.raises(ValueError, match="expected cuda"):
        dqn_td_grads_lanes(ep, dqn.DQNParams(*[w.cpu() for w in tp]), batch)
    assert kernel.launches == before


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


# Where every dataflow's plan splits its reduction (G > 1): YOLO's and
# SSD's largest layers at full width, and a Cin whose last split and last
# channel tile are ragged.  (SconvIC also stages x's channel-padded copy
# there: Cin 409, 435 and 403 are not multiples of 4.)
SPLIT_CASES = [(1, 27, 27, 409, 819, 3, 2), (1, 65, 65, 435, 870, 3, 2),
               (1, 27, 27, 403, 819, 3, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_conv_split_matches_plain_on_card(dev, dataflow, case, dtype):
    x, w = _conv_inputs(case, dtype, dev)
    stride = case[-1]
    assert conv_kernel.conv_splits(dataflow, x.shape, w.shape, stride) > 1
    before = conv_kernel.launches[dataflow]
    got = conv2d(x, w, dataflow=dataflow, stride=stride)
    want = conv2d_ref(x, w, stride)
    torch.cuda.synchronize()
    assert conv_kernel.launches[dataflow] == before + 1   # one per conv
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **CONV_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES[:2])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_conv_kernel_is_deterministic_on_card(dev, dataflow, case, dtype):
    """The splits are summed in a fixed order: two calls, the same bits."""
    x, w = _conv_inputs(case, dtype, dev)
    assert conv_kernel.conv_splits(dataflow, x.shape, w.shape, 2) > 1
    first = conv2d(x, w, dataflow=dataflow, stride=2)
    second = conv2d(x, w, dataflow=dataflow, stride=2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# The edges of MconvMC's implicit GEMM: M not a multiple of the row tile
# (64 or 128) and Cout not a multiple of the column tile (128), with a K
# step of 16 that spans taps (Cin 3: 5 taps and a part; Cin 11); a K walk
# of 7 steps split 5 ways or so (splits of one or two steps); K shorter than
# one step (1x1, Cin 2)
MCONV_EDGE_CASES = [(1, 30, 30, 3, 70, 3, 1), (1, 21, 23, 11, 130, 3, 1),
                    (1, 15, 15, 12, 2048, 3, 1), (1, 9, 9, 2, 40, 1, 1)]
# The edges of SconvIC's bands: Ho = 513, a one-row tail band; Wo 13, a
# 13-wide band dealt to 13 of 16 slots (stride 2, Cin 40 with G = 1, and
# YOLO's layer with its split and padded x); 11x11 taps at stride 4
# (GOTURN's first layer: taps staged in two chunks); stride 3 with 5x5 taps
# and two images
SCONV_IC_EDGE_CASES = [(1, 515, 8, 2, 4, 3, 1), (1, 27, 27, 40, 70, 3, 2),
                       (1, 27, 27, 409, 819, 3, 2),
                       (1, 227, 227, 3, 201, 11, 4),
                       (2, 40, 37, 20, 100, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dataflow,case",
                         [("MconvMC", c) for c in MCONV_EDGE_CASES]
                         + [("SconvIC", c) for c in SCONV_IC_EDGE_CASES])
def test_conv_kernel_edge_cases_on_card(dev, dataflow, case, dtype):
    x, w = _conv_inputs(case, dtype, dev)
    stride = case[-1]
    if case == (1, 15, 15, 12, 2048, 3, 1):
        assert conv_kernel.conv_splits(dataflow, x.shape, w.shape, 1) > 1
    got = conv2d(x, w, dataflow=dataflow, stride=stride)
    want = conv2d_ref(x, w, stride)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **CONV_TOL[dtype])


# A conv of the width-0.1 pools (YOLO, batch 4, 2 x 2 outputs, 51 -> 102):
# under the split threshold MconvMC and SconvIC take their small tiles
# (4 x 4 outputs a thread; 2 pixels a thread) and one launch
POOL_CASE = (4, 4, 4, 51, 102, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dataflow,tile", [("MconvMC", "4 x 4 a thread"),
                                           ("SconvIC", "2 px x 8 Cout")])
def test_conv_small_tile_at_a_pool_conv_on_card(dev, dataflow, tile, dtype):
    x, w = _conv_inputs(POOL_CASE, dtype, dev)
    assert conv_kernel.conv_splits(dataflow, x.shape, w.shape, 1) == 1
    assert tile in conv_kernel.conv_plan(dataflow, x.shape, w.shape, 1)
    got = conv2d(x, w, dataflow=dataflow)
    want = conv2d_ref(x, w, 1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **CONV_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_conv_launch_refuses_a_short_workspace_on_card(dev, dataflow):
    """The C launch holds the workspace it is given to its own plan: one
    float short is refused before any kernel runs."""
    case = SPLIT_CASES[0]
    x, w = _conv_inputs(case, torch.float32, dev)
    n, h, wd, cin, cout, k, stride = case
    shape = (n, h, wd, cin, k, k, cout, stride)
    lib, name = conv_kernel._lib(dataflow), conv_kernel.SOURCES[dataflow]
    need = getattr(lib, f"{name}_workspace")(*shape)
    assert need > 0
    ws = torch.zeros(need, device=dev)
    want = conv2d_ref(x, w, stride)
    out = torch.full_like(want, float("nan"))
    stream = torch.cuda.current_stream().cuda_stream
    launch = getattr(lib, f"{name}_launch")
    assert launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  need - 1, *shape, 0, stream) != 0
    torch.cuda.synchronize()
    assert torch.isnan(out).all()
    assert launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  need, *shape, 0, stream) == 0
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               **CONV_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["SconvIC", "SconvOD"])
def test_conv_plan_refusal_raises_before_launch(dev, dataflow):
    """A window too large for shared memory even at one tap a step: the
    plan gives 0 splits and the binding raises before any launch."""
    x = torch.zeros(1, 320, 320, 4, device=dev)
    w = torch.zeros(300, 300, 4, 4, device=dev)
    assert conv_kernel.conv_splits(dataflow, x.shape, w.shape, 1) == 0
    before = conv_kernel.launches[dataflow]
    with pytest.raises(ValueError, match="plan does not take"):
        conv_kernel.conv2d_cuda(x, w, dataflow=dataflow)
    assert conv_kernel.launches[dataflow] == before


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


SEQ_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}

# (b, s, h, kh, d, causal): tests/test_kernels.py ATTN_SHAPES, then ragged
# lengths, head dim 128 and the stablelm layer's widths
ATTN_CASES = [
    (1, 64, 4, 4, 32, True), (2, 128, 4, 2, 16, True),
    (1, 64, 2, 1, 32, False), (2, 96, 8, 8, 64, True),
    (1, 77, 4, 2, 64, True),       # ragged, GQA
    (2, 1000, 4, 1, 64, False),    # ragged, MQA, not causal
    (1, 150, 8, 2, 128, True),     # head dim 128
    (1, 300, 32, 32, 64, True),    # stablelm's heads, a ragged prompt
    (1, 300, 32, 8, 120, True),    # h2o-danube: head dim 120, zero-padded
    (1, 300, 96, 8, 128, True),    # mistral-large: 96 heads over 8
    (4, 1, 16, 16, 64, False),     # seamless's encoder in the engine: S 1
    (4, 372, 16, 16, 64, False),   # seamless's encoder at 1,491 // 4
    (1, 556, 64, 8, 128, True),    # internvl2: 300 tokens + 256 patches
]


def _attn_inputs(case, dtype, dev, seed=0):
    b, s, h, kh, d, _ = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, n, d)),
                            dtype=torch.float32).to(dev, dtype)
               for n in (h, kh, kh))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_kernel_matches_plain_on_card(dev, case, dtype):
    q, k, v = _attn_inputs(case, dtype, dev)
    causal = case[-1]
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SEQ_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (4, 1491, 32, 32, 64, True),   # stablelm's longest serving wave
    (2, 590, 32, 32, 64, True),    # and a shorter one
    (1, 700, 8, 2, 128, True),     # GQA at head dim 128
    (4, 1491, 32, 8, 120, True),   # h2o-danube's longest wave, D 120
    (2, 590, 96, 8, 128, True),    # mistral-large's heads
])
def test_flash_tensor_core_path_at_serving_shapes_on_card(dev, case):
    q, k, v = _attn_inputs(case, torch.bfloat16, dev)
    got = flash_attention(q, k, v, causal=case[-1])
    want = flash_attention_ref(q, k, v, causal=case[-1])
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **SEQ_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 300), (4, 1491)])
def test_flash_mla_route_matches_plain_on_card(dev, b, s, dtype):
    """minicpm3's MLA prefill: 40 heads, q/k dim 96, V dim 64 zero-padded
    to 96 by ``attention_core``, against the plain attention of the
    unpadded V at scale 1/sqrt(96)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.attention import attention_core
    rng = np.random.default_rng(9)
    q, k = (torch.tensor(rng.normal(size=(b, s, 40, 96)),
                         dtype=torch.float32).to(dev, dtype)
            for _ in range(2))
    v = torch.tensor(rng.normal(size=(b, s, 40, 64)),
                     dtype=torch.float32).to(dev, dtype)
    before = flash_kernel.launches
    got = attention_core(q, k, v, get_config("minicpm3-4b"), causal=True)
    g = lambda x: x.transpose(1, 2).reshape(b * 40, s, -1)  # noqa: E731
    want = attention_ref(g(q), g(k), g(v), causal=True,
                         scale=1.0 / 96 ** 0.5)
    want = want.reshape(b, 40, s, 64).transpose(1, 2)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, s, 40, 64)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SEQ_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_cannot_take(dev):
    q, k, v = _attn_inputs((1, 16, 4, 2, 32, True), torch.float32, dev)
    with pytest.raises(ValueError, match="dtype"):
        flash_kernel.flash_attention_cuda(q, k.bfloat16(), v, causal=True)
    with pytest.raises(ValueError, match="expected cuda"):
        flash_kernel.flash_attention_cuda(q, k.cpu(), v, causal=True)
    with pytest.raises(ValueError, match="do not divide"):
        flash_kernel.flash_attention_cuda(
            q[:, :, :3].contiguous(), k, v, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 16, 2, 136, device=dev)
        flash_kernel.flash_attention_cuda(big, big, big, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_attention_cuda(q.transpose(1, 2), k, v,
                                          causal=True)


# (b, s, h, p, n, chunk): tests/test_kernels.py SSD_SHAPES, then a ragged
# tail, a chunk that is not a multiple of 64, and mamba2's widths
SSD_CASES = [
    (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 1, 8, 16, 16),
    (2, 45, 3, 16, 8, 16),         # ragged tail
    (1, 333, 2, 24, 16, 100),      # chunk 100: partial 64-row tiles
    (1, 600, 24, 64, 128, 256),    # mamba2's widths, a ragged prompt
    (4, 1491, 24, 64, 128, 256),   # mamba2's serving wave: 6 chunks
    (2, 300, 5, 64, 128, 256),     # H not a multiple of the head group
    (1, 1000, 3, 64, 128, 4096),   # S < chunk: 16 key tiles, past the
                                   # scan's score cache
    (1, 100, 3, 7, 12, 32),        # odd P, N = 12: element-wise staging
    (1, 300, 128, 64, 16, 256),    # jamba's widths: 128 heads, N = 16
    (4, 1491, 128, 64, 16, 256),   # jamba's serving wave
]


def _ssd_inputs(case, dtype, dev, seed=0):
    b, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    u = t(rng.normal(size=(b, s, h, p)) * 0.3).to(dtype)
    a = -t(np.abs(rng.normal(size=(b, s, h))) * 0.2)
    Bm = t(rng.normal(size=(b, s, n)) * 0.5).to(dtype)
    Cm = t(rng.normal(size=(b, s, n)) * 0.5).to(dtype)
    return u, a, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_on_card(dev, case, dtype):
    u, a, Bm, Cm = _ssd_inputs(case, dtype, dev)
    b, s, h, p, n, chunk = case
    assert ssd_kernel.ssd_plan(b, s, h, p, n, chunk).startswith("3 kernels")
    before = ssd_kernel.launches
    y, state = ssd_scan(u, a, Bm, Cm, chunk=chunk)
    yr, sr = ssd_scan_ref(u, a, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1   # one a call, 3 kernels
    assert y.dtype == dtype and y.shape == u.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, n, p)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), **SEQ_TOL[dtype])
    np.testing.assert_allclose(state.cpu().numpy(), sr.cpu().numpy(),
                               **SEQ_TOL[dtype])


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_cannot_take(dev):
    u, a, Bm, Cm = _ssd_inputs((1, 32, 2, 8, 4, 8), torch.float32, dev)
    with pytest.raises(ValueError, match="dtype"):
        ssd_kernel.ssd_scan_cuda(u, a, Bm.bfloat16(), Cm, chunk=8)
    with pytest.raises(ValueError, match="expected cuda"):
        ssd_kernel.ssd_scan_cuda(u, a.cpu(), Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="P = 72"):
        big = torch.zeros(1, 32, 2, 72, device=dev)
        ssd_kernel.ssd_scan_cuda(big, a, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.ssd_scan_cuda(u.transpose(1, 2).contiguous()
                                 .transpose(1, 2), a, Bm, Cm, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("fold_adam", [False, True])
def test_td_cluster_kernel_is_deterministic_on_card(dev, fold_adam):
    """Every sum runs in a fixed order (rank order across the cluster), so
    two calls give the same bits; the launch is one cluster of 8 blocks."""
    plan = kernel.td_plan(100, D, A)
    assert plan.startswith("cluster of 8 blocks"), plan
    ep, tp, batch, opt = _td_case(5, 100, D, A, dev)

    def call():
        if fold_adam:
            p, o, loss = dqn_td_update_fused(ep, tp, opt, batch, lr=1e-3)
            return [loss, *p, *o.mu, *o.nu]
        loss, g = dqn_td_grads_fused(ep, tp, batch)
        return [loss, *g]

    first, second = call(), call()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_td_cluster_kernel_64_update_trajectory_on_card(dev):
    """64 chained Adam-folded updates against the plain dqn_td_update on
    the same batches, TargNet synced every 8: within 1e-5 (the reference
    tolerance over a 64-update TD trajectory)."""
    ep = _td_case(64, 64, D, A, dev)[0]
    kp, rp = ep, ep
    k_opt = r_opt = dqn.adam_init(ep)
    k_targ = r_targ = ep
    before = kernel.launches
    for step in range(64):
        batch = _td_case(1000 + step, 64, D, A, dev)[2]
        kp, k_opt, k_loss = dqn_td_update_fused(kp, k_targ, k_opt, batch,
                                                lr=1e-3)
        rp, r_opt, r_loss = dqn.dqn_td_update(rp, r_targ, r_opt, batch,
                                              lr=1e-3)
        if step % 8 == 7:
            k_targ, r_targ = kp, rp
    torch.cuda.synchronize()
    assert kernel.launches == before + 64 and int(k_opt.step) == 64
    np.testing.assert_allclose(float(k_loss), float(r_loss), rtol=1e-5,
                               atol=1e-6)
    _close(kp, rp, 0, 1e-5, "params after 64 updates")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_parallel_scan_is_deterministic_on_card(dev, dtype):
    case = SSD_CASES[6]
    assert case == (4, 1491, 24, 64, 128, 256)   # mamba2's serving wave
    u, a, Bm, Cm = _ssd_inputs(case, dtype, dev, seed=2)
    y1, s1 = ssd_kernel.ssd_scan_cuda(u, a, Bm, Cm, chunk=case[-1])
    y2, s2 = ssd_kernel.ssd_scan_cuda(u, a, Bm, Cm, chunk=case[-1])
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 300, 5, 64, 128, 256),
                                  (1, 1024, 24, 64, 128, 256),
                                  (4, 1491, 24, 64, 128, 256),
                                  (3, 7, 8, 24, 16, 4)], ids=str)
def test_ssd_workspace_arithmetic_equals_the_library(dev, case):
    """The dry run's tracker counts the scan's workspace from
    ``ops.workspace_floats`` (no library on a CPU host): the built
    library's own figure."""
    from repro_torch.kernels.ssd_scan.ops import workspace_floats
    assert workspace_floats(*case) == ssd_kernel.workspace_floats(*case)


@pytest.mark.cuda
def test_ssd_launch_refuses_a_short_workspace_on_card(dev):
    """The C launch holds the workspace it is given to its own plan: one
    float short is refused before any of the three kernels runs."""
    b, s, h, p, n, chunk = case = (2, 300, 5, 64, 128, 256)
    u, a, Bm, Cm = _ssd_inputs(case, torch.bfloat16, dev)
    lib = ssd_kernel._lib()
    need = ssd_kernel.workspace_floats(b, s, h, p, n, chunk)
    assert need > 0
    ws = torch.zeros(need, device=dev)
    y = torch.full_like(u, float("nan"))
    st = torch.full((b, h, n, p), float("nan"), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (u.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), st.data_ptr(), ws.data_ptr())
    assert lib.ssd_scan_launch(*args, need - 1, b, s, h, p, n, chunk, 1,
                               stream) != 0
    torch.cuda.synchronize()
    assert torch.isnan(y.float()).all() and torch.isnan(st).all()
    assert lib.ssd_scan_launch(*args, need, b, s, h, p, n, chunk, 1,
                               stream) == 0
    yr, sr = ssd_scan_ref(u, a, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(),
                               **SEQ_TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# the baseline schedulers and the degradation trainer on the card
# ---------------------------------------------------------------------------

def _baseline_setup():
    from repro_torch.core import environment as env
    from repro_torch.core.faults import build_health_trace, \
        random_fault_events
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
    small = dict(route_km=0.01, rate_scale=0.012, max_times_turn=2,
                 max_times_reverse=1, max_duration_turn=4.0,
                 max_duration_reverse=5.0)
    queues = [env.build_task_queue(env.EnvironmentParams(seed=s, **small))
              for s in (3, 4)]
    batch = stack_task_arrays([tasks_to_arrays(q) for q in queues])
    t = batch.arrival.shape[1]
    trace = np.stack([build_health_trace(t, A, random_fault_events(
        s, t, A, n_faults=3)) for s in (1, 2)])
    return HMAIPlatform(capacity_scale=0.012), batch, torch.tensor(trace)


def _baseline_run(name, spec, batch, trace, draws=None):
    from repro_torch.core.schedulers import (SCAN_SCHEDULERS, GAConfig,
                                             SAConfig, make_metaheuristic_fn)
    if name in SCAN_SCHEDULERS:
        return SCAN_SCHEDULERS[name](spec, batch, health=trace)
    cfg = GAConfig() if name == "ga" else SAConfig(tempering=True)
    return make_metaheuristic_fn(spec, name, cfg, batched=True)(
        0, batch, health=trace, draws=draws)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["worst", "ata", "minmin", "ga", "sa"])
def test_baseline_on_card_equals_the_cpu(dev, name):
    """Same routes, traces and (GA/SA) injected draws: the scans' records
    equal on both devices; GA/SA placements equal, or at a first
    difference the CPU fitness margin of the two window assignments is
    below 1e-5 relative (an energy sum in another order)."""
    from repro_torch.core.faults import replay_actions, window_health
    from repro_torch.core.platform import (platform_init, spec_from_platform,
                                           with_health)
    from repro_torch.core.schedulers import GAConfig, SAConfig
    from repro_torch.core.schedulers import metaheuristic as mh
    from repro_torch.core.tasks import TaskArrays
    plat, batch, trace = _baseline_setup()
    draws = None
    if name in ("ga", "sa"):
        cfg = GAConfig() if name == "ga" else SAConfig(tempering=True)
        fn = mh.ga_draws if name == "ga" else mh.sa_draws
        draws = fn(cfg, torch.Generator().manual_seed(7), 2,
                   -(-batch.arrival.shape[1] // cfg.window), A, "cpu")
    cpu_spec = spec_from_platform(plat, "cpu")
    _, want = _baseline_run(name, cpu_spec, batch, trace, draws)
    # the inputs go to the card first: the dispatch itself may not sync
    args = (spec_from_platform(plat, dev), batch.to(dev), trace.to(dev),
            None if draws is None else type(draws)(
                *[None if d is None else d.to(dev) for d in draws]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, got = _baseline_run(name, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if name not in ("ga", "sa"):
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        return
    w = cfg.window
    rows = window_health(trace, w).repeat_interleave(w, dim=1)
    for r in range(2):
        g, x = got.action[r].cpu().numpy(), want.action[r].numpy()
        diff = np.nonzero(g != x)[0]
        if not len(diff):
            continue
        lo = int(diff[0]) // w * w
        task = TaskArrays(*[torch.nn.functional.pad(
            f[r:r + 1], (0, rows.shape[1] - f.shape[1])) for f in batch])
        state = replay_actions(cpu_spec, TaskArrays(
            *[f[:, :lo] for f in task]), want.action[r:r + 1, :lo],
            rows[r:r + 1, :lo])[0] if lo else platform_init(A)
        state = with_health(state, rows[r:r + 1, lo])
        fit = mh.window_fitness(
            cpu_spec, state, TaskArrays(*[f[:, lo:lo + w] for f in task]),
            torch.stack([want.action[r, lo:lo + w],
                         got.action[r, lo:lo + w].cpu()])[None])[0]
        assert float((fit[0] - fit[1]) / fit[0].abs()) < 1e-5, (r, lo)


@pytest.mark.cuda
def test_flexai_health_dispatch_has_no_host_sync_on_card(dev):
    from repro_torch.core.flexai import engine
    from repro_torch.core.platform import spec_from_platform
    plat, batch, trace = _baseline_setup()
    params = engine.train_init(D, A, 8, device=dev).eval_p
    fn = engine.make_schedule_fn(spec_from_platform(plat, dev), batched=True)
    batch, trace = batch.to(dev), trace.to(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, recs = fn(params, batch, health=trace)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    acts = recs.action.cpu()
    alive = trace.cpu().gather(2, acts[..., None])[..., 0] > 0
    assert alive[recs.valid.cpu()].all()


@pytest.mark.cuda
def test_degradation_episode_counts_its_td_launches_on_card(dev):
    """One episode of the degradation trainer through the TD kernel: one
    launch per update, and no greedy pick on a dead core."""
    from repro_torch.core import environment as env
    from repro_torch.core.faults import FaultEvent, build_health_trace
    from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
    from repro_torch.core.flexai.engine import Draws
    from repro_torch.core.hmai import HMAIPlatform
    plat = HMAIPlatform(capacity_scale=0.012)
    queue = env.build_task_queue(env.EnvironmentParams(
        seed=2, route_km=0.01, rate_scale=0.012, max_times_turn=2,
        max_times_reverse=1, max_duration_turn=4.0,
        max_duration_reverse=5.0))
    t = len(queue)
    trace = build_health_trace(t, A, [FaultEvent(5, 3, 0.0),
                                      FaultEvent(9, 8, 0.5),
                                      FaultEvent(40, 0, 0.0)])
    cfg = FlexAIConfig(min_replay=16, batch_size=16, eps_start=0.1,
                       eps_end=0.1)
    rng = np.random.default_rng(3)
    size = np.minimum(np.arange(1, t + 1), cfg.replay_capacity)
    draws = Draws(torch.tensor(rng.random(t), dtype=torch.float32),
                  torch.tensor(rng.integers(0, A, t)),
                  torch.tensor(np.stack([rng.integers(0, s, 16)
                                         for s in size])))
    trainer = ScanFlexAI(plat, cfg, td_kernel=True, device=dev)
    before = kernel.launches
    trainer.train_episode(queue, draws=draws, health=trace)
    assert kernel.launches - before == trainer.ts.updates > 50
    acts = trainer.ts.replay.a[:t].cpu().numpy()
    greedy = draws.explore_u.numpy() >= np.float32(0.1)
    assert (trace[np.arange(t), acts][greedy] > 0).all()


# ---------------------------------------------------------------------------
# LM training: the loss path on the plain branches, the ops refusing grad
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_ops_refuse_grad_inputs_on_card(dev):
    """Neither kernel has a backward: each op refuses a CUDA input that
    requires grad, before any launch; under no_grad it launches."""
    q = torch.randn(1, 64, 2, 64, device=dev)
    u = torch.randn(1, 64, 2, 16, device=dev)
    a = -torch.rand(1, 64, 2, device=dev)
    bm = torch.randn(1, 64, 8, device=dev)
    for fn, args, mod in (
            (lambda *x: flash_attention(*x, causal=True), [q, q, q],
             flash_kernel),
            (lambda *x: ssd_scan(*x, chunk=32), [u, a, bm, bm], ssd_kernel)):
        for i in range(len(args)):
            bad = list(args)
            bad[i] = bad[i].clone().requires_grad_()
            before = mod.launches
            with pytest.raises(RuntimeError, match="no backward"):
                fn(*bad)
            assert mod.launches == before
            with torch.no_grad():
                fn(*bad)
            assert mod.launches == before + 1


def _lm_grads(cfg, params, batch, device):
    from repro_torch.models.api import model_api
    from repro_torch.train.checkpoint import _flatten_with_names
    from repro_torch.train.loop import value_and_grad
    loss, _, grads = value_and_grad(
        model_api(cfg).loss, _to(params, device),
        {k: torch.as_tensor(v).to(device) for k, v in batch.items()})
    names, leaves, _ = _flatten_with_names(grads)
    return float(loss), {n: g.float().cpu() for n, g in zip(names, leaves)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [
    ("mamba2-130m", "float32"), ("mamba2-130m", "bfloat16"),
    ("qwen3-moe-30b-a3b", "float32")])
def test_lm_loss_and_grads_on_card_match_cpu(dev, arch, dtype):
    """An arch at full width cut to 2 layers, CPU-drawn weights, one
    ``lm_batch_at_step`` batch: loss and every gradient leaf on the card
    against the CPU, no SSD or flash launch (``chip_smoke.py`` phase
    16a's gate: fp32 1e-3 of the CPU leaf's max|g|; bf16 5e-2 of it, or
    twice the CPU bf16 leaf's distance from the CPU fp32 one).  The MoE
    arch in fp32 only: its bf16 router's top k can part at a tie, and a
    token sent to another expert moves every gradient upstream of it
    (``tests/test_torch_lm_loss.py`` routes one package on the other's
    ids for that)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.api import model_api
    from repro_torch.train.data import DataConfig, lm_batch_at_step
    base = replace(get_config(arch), num_layers=2)
    params = model_api(base).init(torch.Generator().manual_seed(1))
    batch = lm_batch_at_step(base, DataConfig(batch_size=2, seq_len=64), 0)
    cfg = replace(base, dtype=dtype)
    lc, gc = _lm_grads(cfg, params, batch, "cpu")
    ref32 = (_lm_grads(replace(base, dtype="float32"), params, batch,
                       "cpu")[1] if dtype == "bfloat16" else None)
    before = (flash_kernel.launches, ssd_kernel.launches)
    lg, gg = _lm_grads(cfg, params, batch, dev)
    assert (flash_kernel.launches, ssd_kernel.launches) == before
    tol = 1e-3 if dtype == "float32" else 5e-2
    assert abs(lg - lc) <= (1e-4 if dtype == "float32" else 5e-2) * abs(lc)
    for name, c in gc.items():
        bound = tol * float(c.abs().max())
        if ref32 is not None:
            bound = max(bound, 2 * float((c - ref32[name]).abs().max()))
        assert float((gg[name] - c).abs().max()) <= bound, name


EP_CFG = dict(name="ep-card", family="moe", num_layers=1, d_model=128,
              num_heads=2, num_kv_heads=2, d_ff=96, vocab_size=64,
              num_experts=16, num_experts_per_token=4, dtype="float32",
              moe_capacity_factor=8.0, moe_impl="shard_map")


def _ep_loss_grads(cfg, p, x, device, mesh=None):
    """sum(out^2) + aux of the MoE on ``device`` (on ``mesh`` if given):
    (out, grads of every leaf and x), on the host."""
    from repro_torch.models import moe
    from repro_torch.sharding import activate
    leaves = {k: v.to(device).requires_grad_() for k, v in p.items()}
    xx = x.to(device).requires_grad_()
    if mesh is None:
        out, aux = moe.moe_apply_gspmd(leaves, cfg, xx)
    else:
        with activate(mesh):
            out, aux = moe.moe_apply(leaves, cfg, xx)
    (out.square().sum() + aux).backward()
    return (out.detach().cpu(), {k: v.grad.cpu() for k, v in leaves.items()},
            xx.grad.cpu())


def _ep_card_worker(rank, port, out_dir):
    """One of two processes sharing the card: a gloo (1, 2) ``("data",
    "model")`` mesh, the MoE computed on the card."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ModelConfig
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        inp = torch.load(os.path.join(out_dir, "in.pt"))
        res = _ep_loss_grads(ModelConfig(**EP_CFG), inp["p"], inp["x"],
                             "cuda", make_test_mesh((1, 2),
                                                    ("data", "model")))
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.mark.cuda
def test_expert_parallel_moe_on_two_processes_sharing_the_card(dev,
                                                               tmp_path):
    """``moe_apply_shard_map`` on two processes sharing the card (a gloo
    mesh carrying the card's rows through host memory) against the
    one-process GSPMD path on the card, at capacity factor 8.0 (no
    drops): the output within 1e-5 and every gradient within 1e-3 on
    both ranks."""
    import socket

    import torch.multiprocessing as mp

    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**EP_CFG)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(1))
    torch.save({"p": p, "x": x}, tmp_path / "in.pt")
    out, g, gx = _ep_loss_grads(cfg, p, x, dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_ep_card_worker, args=(port, str(tmp_path)), nprocs=2,
             join=True)
    for r in range(2):
        got_out, got_g, got_gx = torch.load(tmp_path / f"rank{r}.pt")
        torch.testing.assert_close(got_out, out, rtol=0, atol=1e-5)
        for k in g:
            torch.testing.assert_close(got_g[k], g[k], rtol=0, atol=1e-3)
        torch.testing.assert_close(got_gx, gx, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_remat_recomputes_in_the_context_of_its_first_call_on_the_card(dev):
    """The autograd engine runs the backward of CUDA tensors on a thread
    of its own, which does not see the caller's context variables (the
    row shard a partitioned MoE layer routes by): ``transformer.remat``'s
    recompute must see what its first call saw.  The CPU twin, with a
    backward started on a new thread, is in
    ``tests/test_torch_partitioned.py``."""
    import contextvars

    from repro_torch.models.transformer import remat
    scale = contextvars.ContextVar("scale", default=1.0)
    body = remat(type("Cfg", (), {"remat": "full"})(),
                 lambda x: torch.sin(x * scale.get()))
    x = torch.linspace(-1.0, 1.0, 7, device=dev, requires_grad=True)
    token = scale.set(2.0)
    try:
        y = body(x).sum()
    finally:
        scale.reset(token)
    y.backward()
    want = 2.0 * torch.cos(2.0 * x.detach())
    torch.testing.assert_close(x.grad, want, rtol=0, atol=1e-6)
