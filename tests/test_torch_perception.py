"""The port's perception CNNs against the JAX package's, with the JAX
package's weights carried across (``convnet_params_from_numpy``,
``goturn_params_from_numpy``).

The JAX side convolves with ``lax.conv_general_dilated(..., "SAME")``; the
port pads XLA's SAME amounts itself and runs every conv through
``conv2d`` (on the CPU: the plain version, for every dataflow).  Every
layer's feature map is compared at rtol 1e-4 and atol 1e-4 * max|ref|
(fp32 sums taken in another order, carried through up to 58 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.perception import cnn as cnn_jax
from repro.models.perception import nets as nets_jax
from repro.sharding import unbox
from repro_torch.models.perception import cnn, nets, stats


def _jax_params(init, seed):
    """The JAX package's unboxed parameter tree for ``init(key)``, with
    the shapes and structure of its ``init_*`` (``jax.eval_shape``, no
    compile) and seeded numpy values: normal / sqrt(fan_in) kernels
    (fan_in = the product of all but the last dim), small normal biases
    so that the bias add is exercised too."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: unbox(init(k)), jax.random.PRNGKey(0))

    def draw(sd):
        v = rng.normal(size=sd.shape)
        if len(sd.shape) > 1:
            v = v / np.sqrt(np.prod(sd.shape[:-1]))
        else:
            v = v * 0.05
        return v.astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _close(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


def _image(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name,dataflow", [("yolo", "MconvMC"),
                                           ("ssd", "SconvOD")])
def test_detector_features_match_jax(name, dataflow):
    spec_j, _ = nets_jax.PERCEPTION_SPECS[name]
    spec_t, _ = nets.PERCEPTION_SPECS[name]
    assert spec_t == stats.ConvNetSpec(spec_j.name, spec_j.layers,
                                       spec_j.in_channels, spec_j.input_hw)
    params = _jax_params(lambda k: cnn_jax.init_convnet(k, spec_j, 0.1), 1)
    x = _image((2, 64, 64, 3), seed=2)
    out_j, feats_j = jax.jit(lambda p, v: cnn_jax.convnet_apply(
        p, spec_j, v, return_features=True))(params, jnp.asarray(x))
    out_t, feats_t = cnn.convnet_apply(
        cnn.convnet_params_from_numpy(params), spec_t, torch.from_numpy(x),
        return_features=True, dataflow=dataflow)
    assert len(feats_t) == len(feats_j) == len(spec_t.layers)
    for i, (ft, fj) in enumerate(zip(feats_t, feats_j)):
        _close(ft, fj, f"{name} layer {i} {spec_t.layers[i]}")
    _close(out_t, out_j, f"{name} output")


def test_goturn_towers_and_head_match_jax():
    def init(k):
        p = dict(nets_jax.init_goturn(k, 0.2))
        p.pop("head_spec")
        return p

    p_j = _jax_params(init, 4)
    head_spec = cnn_jax.ConvNetSpec(
        name="goturn_head", in_channels=2 * max(4, int(256 * 0.2)),
        input_hw=1, layers=nets_jax.GOTURN_HEAD.layers)
    p_t = nets.goturn_params_from_numpy({**p_j, "head_spec": head_spec})
    assert p_t["head_spec"].in_channels == head_spec.in_channels
    assert p_t["head_spec"].layers == head_spec.layers
    prev, curr = _image((2, 32, 32, 3), 5), _image((2, 32, 32, 3), 6)
    want = jax.jit(lambda p, a, b: nets_jax.goturn_apply(
        {**p, "head_spec": head_spec}, a, b))(p_j, jnp.asarray(prev),
                                              jnp.asarray(curr))
    got = nets.goturn_apply(p_t, torch.from_numpy(prev),
                            torch.from_numpy(curr), dataflow="SconvIC")
    assert got.shape == (2, 4)
    _close(got, want, "goturn head output")


def test_even_h_stride2_conv_and_pool_pad_like_xla():
    """An even-H stride-2 conv and a 3/2 max-pool: XLA's SAME pads
    (0, 1) there, not (1, 1); symmetric padding would shift every
    window."""
    layers = (("conv", 8, 3, 2), ("maxpool", 3, 2), ("conv", 8, 3, 1),
              ("residual", 1), ("conv", 6, 2, 2), ("maxpool", 2, 2),
              ("globalpool",), ("fc", 5))
    spec_j = cnn_jax.ConvNetSpec("pin", layers, in_channels=3, input_hw=16)
    spec_t = stats.ConvNetSpec("pin", layers, in_channels=3, input_hw=16)
    params = _jax_params(lambda k: cnn_jax.init_convnet(k, spec_j), 7)
    x = _image((2, 16, 16, 3), seed=8)
    out_j, feats_j = jax.jit(lambda p, v: cnn_jax.convnet_apply(
        p, spec_j, v, return_features=True))(params, jnp.asarray(x))
    p_t = cnn.convnet_params_from_numpy(params)
    out_t, feats_t = cnn.convnet_apply(p_t, spec_t, torch.from_numpy(x),
                                       return_features=True)
    for i, (ft, fj) in enumerate(zip(feats_t, feats_j)):
        _close(ft, fj, f"layer {i} {layers[i]}")
    assert cnn.same_pads(16, 3, 2) == (0, 1)
    # torch's symmetric pool padding is not the same function here
    sym = torch.nn.functional.max_pool2d(
        feats_t[0].permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
    assert sym.shape == feats_t[1].shape
    assert not torch.equal(sym, feats_t[1])


def test_init_convnet_shapes_follow_the_jax_package():
    spec = stats.YOLO_SPEC
    p_t = cnn.init_convnet(torch.Generator().manual_seed(0), spec, 0.1,
                           device="cpu")
    p_j = jax.eval_shape(lambda k: unbox(cnn_jax.init_convnet(k, spec, 0.1)),
                         jax.random.PRNGKey(0))
    assert len(p_t) == len(p_j)
    for a, b in zip(p_t, p_j):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a["w"].shape) == b["w"].shape
            assert tuple(a["b"].shape) == b["b"].shape
            assert not bool(a["b"].any())
