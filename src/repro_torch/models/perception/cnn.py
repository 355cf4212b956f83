"""Runnable CNNs of the paper's perception workloads, in PyTorch.

The port of the JAX package's ``models/perception/cnn.py``
(``init_convnet``, ``convnet_apply``).  The layer specs and
``convnet_stats`` are in :mod:`repro_torch.models.perception.stats`.
Activations are NHWC and conv weights ``w`` [KH, KW, Cin, Cout], fc
weights [d_in, n_out], as in the JAX package, so weights move between the
two unchanged (:func:`convnet_params_from_numpy`).

Each conv layer runs through the port's ``conv2d`` with the ``dataflow``
the caller names: on a CUDA tensor that is one of the three hand-written
dataflow kernels, on a CPU tensor their plain version.  The function is
the JAX package's ``lax.conv_general_dilated(..., "SAME")``: the layer
pads XLA's SAME amounts explicitly (asymmetric for stride > 1 at even
H) and calls ``conv2d(..., padding="VALID", stride=s)``.  Max-pooling
pads with -inf the same way, then pools without padding.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.conv_dataflow import conv2d
from repro_torch.kernels.protocol import resolve_device
from repro_torch.models.perception.stats import ConvNetSpec


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial dim: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    (ht, hb), (wl, wr) = (same_pads(x.shape[1], k, stride),
                          same_pads(x.shape[2], k, stride))
    return F.pad(x, (0, 0, wl, wr, ht, hb), value=value)


def init_convnet(generator: torch.Generator, spec: ConvNetSpec,
                 width_mult: float = 1.0, dtype=torch.float32,
                 device=None) -> list:
    """Per-layer param dicts (None for param-free layers), drawn from
    ``generator`` (a CPU generator) as the JAX package draws them:
    normal / sqrt(fan_in) kernels, zero biases."""
    device = resolve_device(device)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator) / math.sqrt(max(fan_in,
                                                                    1))
        return w.to(device, dtype)

    params = []
    c_in, hw, flat_dim = spec.in_channels, spec.input_hw, None
    for layer in spec.layers:
        kind = layer[0]
        if kind == "conv":
            _, c_out, k, stride = layer
            c_out = max(4, int(c_out * width_mult))
            params.append({"w": dense((k, k, c_in, c_out), k * k * c_in),
                           "b": torch.zeros(c_out, dtype=dtype,
                                            device=device)})
            c_in, hw = c_out, -(-hw // stride)
        elif kind == "maxpool":
            hw = -(-hw // layer[2])
            params.append(None)
        elif kind == "residual":
            params.append(None)
        elif kind == "globalpool":
            flat_dim, hw = c_in, 1
            params.append(None)
        elif kind == "fc":
            n_out = max(4, int(layer[1] * width_mult))
            d_in = flat_dim if flat_dim is not None else c_in * hw * hw
            params.append({"w": dense((d_in, n_out), d_in),
                           "b": torch.zeros(n_out, dtype=dtype,
                                            device=device)})
            flat_dim = c_in = n_out
        else:
            raise ValueError(kind)
    return params


def convnet_apply(params: list, spec: ConvNetSpec, x: torch.Tensor,
                  return_features: bool = False, *,
                  dataflow: str = "MconvMC"):
    """x: [B, H, W, C].  Returns the final output (and the per-layer
    features).  Every conv goes through ``conv2d(dataflow=dataflow)``."""
    feats = []
    flat = None
    for layer, p in zip(spec.layers, params):
        kind = layer[0]
        if kind == "conv":
            _, _, k, stride = layer
            x = conv2d(_pad_same(x, k, stride), p["w"].to(x.dtype),
                       dataflow=dataflow, stride=stride, padding="VALID")
            x = _leaky(x + p["b"].to(x.dtype))
        elif kind == "maxpool":
            _, k, stride = layer
            x = _pad_same(x, k, stride, float("-inf"))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(
                0, 2, 3, 1)
        elif kind == "residual":
            x = x + feats[len(feats) - layer[1]]
        elif kind == "globalpool":
            x = x.mean(dim=(1, 2))
            flat = x
        elif kind == "fc":
            inp = flat if flat is not None else x.reshape(x.shape[0], -1)
            x = _leaky(inp @ p["w"].to(x.dtype) + p["b"].to(x.dtype))
            flat = x
        feats.append(x)
    if return_features:
        return x, feats
    return x


def convnet_params_from_numpy(arrays: list, device="cpu") -> list:
    """The JAX package's unboxed ``init_convnet`` list (numpy arrays, or
    anything ``np.asarray`` takes) -> the port's: ``None`` stays ``None``,
    ``{"w", "b"}`` become float32 tensors on ``device`` in the same
    layout (conv w [KH, KW, Cin, Cout], fc w [d_in, n_out])."""
    return [None if p is None else
            {k: torch.tensor(np.asarray(p[k], np.float32), device=device)
             for k in ("w", "b")} for p in arrays]
