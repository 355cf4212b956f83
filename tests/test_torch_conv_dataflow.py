"""The port's conv-dataflow ``conv2d`` against the JAX package's.

On the CPU every dataflow of the port takes the plain version
(``ref.conv2d_ref``); the JAX side runs each dataflow's Pallas kernel in
interpret mode.  Same seeded numpy inputs on both sides; tolerances are
the JAX kernel tests' (``tests/test_kernels.py``): rtol = atol = 1e-4 in
float32, 5e-2 in bfloat16 (the two frameworks round bf16 at other
places).  The CUDA kernels are held to the same plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_dataflow import conv2d as conv2d_jax
from repro_torch.kernels.conv_dataflow import DATAFLOWS, conv2d, conv2d_ref

CONV_SHAPES = [          # tests/test_kernels.py:27 (n, h, w, cin, cout, k)
    (1, 8, 8, 4, 8, 3),
    (2, 12, 10, 8, 16, 5),
    (1, 6, 6, 3, 5, 1),
    (2, 16, 16, 16, 32, 3),
]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _inputs(shape, seed=0):
    n, h, w_, ci, co, k = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w_, ci)).astype(np.float32),
            (rng.normal(size=(k, k, ci, co)) * 0.2).astype(np.float32))


def _both(x, w, dtype, **kw):
    """(port on the CPU, JAX in interpret mode) as float32 numpy."""
    got = conv2d(torch.from_numpy(x).to(getattr(torch, dtype)),
                 torch.from_numpy(w).to(getattr(torch, dtype)), **kw)
    want = conv2d_jax(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                      interpret=True, **kw)
    assert str(got.dtype) == f"torch.{dtype}"
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_matches_jax_dataflow(dataflow, shape, dtype):
    x, w = _inputs(shape)
    got, want = _both(x, w, dtype, dataflow=dataflow)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[dtype])


# chip_smoke.CONV_CASES shapes that CONV_SHAPES does not cover, held to
# each JAX dataflow with the stride (n, h, w, cin, cout, k, stride).  The
# JAX wrapper convolves at stride 1 and subsamples; the port computes only
# the kept outputs.
CARD_CASES = [
    (2, 15, 11, 11, 4, 3, 1),     # Cin 11: a partial channel tile
    (1, 515, 8, 2, 4, 3, 1),      # Ho 513 = 64 x 8 + 1: a one-row tail band
    # GOTURN's first layer (11x11 taps, stride 4; 227^2 x 3 -> 201 on the
    # card) shrunk to a 19^2 input and one channel: interpret mode unrolls
    # every tap x channel, ~18 s a case at Cin 3
    (1, 19, 19, 1, 8, 11, 4),
    (1, 17, 17, 25, 51, 3, 2),    # odd widths, stride 2
]

# The edge cases each CUDA kernel is held to on the card
# (tests/test_torch_kernels_cuda.py), against the JAX kernel of its own
# dataflow.  SconvIC's are shrunk where interpret mode is slow (Cin 40 ->
# 12, 40 x 37 x 20 -> 22 x 19 x 5), keeping what makes each an edge.
EDGE_CASES = [
    # MconvMC: M and Cout ragged against the 64/128-row and 128-column
    # tiles with a K step across taps (Cin 3, Cin 11); a K walk of 7 steps
    # the card splits; K shorter than one step
    ("MconvMC", (1, 30, 30, 3, 70, 3, 1)),
    ("MconvMC", (1, 21, 23, 11, 130, 3, 1)),
    ("MconvMC", (1, 15, 15, 12, 2048, 3, 1)),
    ("MconvMC", (1, 9, 9, 2, 40, 1, 1)),
    # SconvIC: a 13-wide band at stride 2; stride 3, 5x5 taps, two images
    ("SconvIC", (1, 27, 27, 12, 70, 3, 2)),
    ("SconvIC", (2, 22, 19, 5, 12, 5, 3)),
]


def _case_inputs(case, seed=0):
    n, h, w_, ci, co, k, _ = case
    return _inputs((n, h, w_, ci, co, k), seed)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("case", CARD_CASES)
def test_conv2d_matches_jax_at_card_shapes(dataflow, case):
    x, w = _case_inputs(case)
    got, want = _both(x, w, "float32", dataflow=dataflow, stride=case[-1])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("dataflow,case", EDGE_CASES)
def test_conv2d_matches_jax_at_kernel_edge_cases(dataflow, case):
    x, w = _case_inputs(case, seed=1)
    got, want = _both(x, w, "float32", dataflow=dataflow, stride=case[-1])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("h", [8, 9])
def test_same_stride2_is_the_jax_wrappers_not_xlas(h):
    """``padding="SAME"`` with stride 2 pads (k-1)//2 before and
    k-1-(k-1)//2 after, convolves at stride 1 and subsamples: the JAX
    wrapper's semantics.  At even H that is not XLA's SAME (which the
    CNNs use); at odd H the two agree."""
    x, w = _inputs((1, h, h, 4, 8, 3), seed=h)
    got, want = _both(x, w, "float32", dataflow="MconvMC", padding="SAME",
                      stride=2)
    assert got.shape == want.shape == (1, 5 if h == 9 else 4,
                                       5 if h == 9 else 4, 8)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    xla = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    gap = float(np.abs(got - xla).max())
    assert gap > 0.1 if h % 2 == 0 else gap < 1e-4


def test_ref_dataflow_and_stride_subsampling():
    x, w = _inputs((2, 11, 9, 5, 6, 3), seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got, want = _both(x, w, "float32", dataflow="ref", stride=3)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    # the strided plain version is the stride-1 output subsampled
    full = conv2d_ref(xt, wt)
    np.testing.assert_allclose(conv2d_ref(xt, wt, stride=3).numpy(),
                               full[:, ::3, ::3].numpy(), rtol=0, atol=0)


def test_unknown_dataflow_and_padding_raise():
    x, w = _inputs((1, 6, 6, 3, 5, 1))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="unknown dataflow"):
        conv2d(xt, wt, dataflow="Systolic")
    with pytest.raises(ValueError, match="unknown padding"):
        conv2d(xt, wt, padding="FULL")


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_no_route_for_other_devices(dataflow):
    x = torch.empty(1, 6, 6, 3, device="meta")
    w = torch.empty(1, 1, 3, 5, device="meta")
    with pytest.raises(ValueError, match="no conv2d route for device"):
        conv2d(x, w, dataflow=dataflow)
