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
