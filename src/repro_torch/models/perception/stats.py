"""Analytic statistics of the paper's three perception workloads.

The port's own copy of the layer-spec half of the JAX package's
``models/perception/cnn.py`` (``ConvNetSpec``, ``convnet_stats``) and
``models/perception/nets.py`` (the YOLO/SSD/GOTURN specs,
``goturn_stats``, ``perception_stats``): the analytic side, from which
the task features (Amount, LayerNum) come.  The runnable CNNs are in
``cnn.py`` and ``nets.py`` beside it.

Full-scale specs are calibrated so the analytic MACs approximate Table 1
(YOLO 16 GMACs, SSD 26 GMACs, GOTURN 11 GMACs).

Layer kinds:
    ("conv", c_out, k, stride)       conv + bias + leaky-relu
    ("maxpool", k, stride)
    ("residual", n_back)             add output of layer i-n_back
    ("globalpool",)                  spatial mean
    ("fc", n_out)                    dense + leaky-relu (flattens if needed)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvNetSpec:
    name: str
    layers: tuple  # tuple of layer-kind tuples
    in_channels: int = 3
    input_hw: int = 416  # nominal full-scale input resolution


def convnet_stats(spec: ConvNetSpec, width_mult: float = 1.0) -> dict:
    """Analytic MACs / params / per-layer workload (full-scale input)."""
    c_in = spec.in_channels
    hw = spec.input_hw
    macs = 0
    n_params = 0
    n_neurons = 0
    per_layer = []
    flat_dim = None
    for layer in spec.layers:
        kind = layer[0]
        if kind == "conv":
            _, c_out, k, stride = layer
            c_out = max(4, int(c_out * width_mult))
            hw_out = -(-hw // stride)
            m = hw_out * hw_out * k * k * c_in * c_out
            macs += m
            n_params += k * k * c_in * c_out + c_out
            n_neurons += hw_out * hw_out * c_out
            per_layer.append({
                "kind": "conv", "macs": m, "k": k,
                "c_in": c_in, "c_out": c_out, "hw": hw_out, "stride": stride,
            })
            c_in, hw = c_out, hw_out
        elif kind == "maxpool":
            _, k, stride = layer
            hw = -(-hw // stride)
            per_layer.append({"kind": "maxpool", "macs": 0})
        elif kind == "residual":
            per_layer.append({"kind": "residual", "macs": 0})
        elif kind == "globalpool":
            flat_dim = c_in
            hw = 1
            per_layer.append({"kind": "globalpool", "macs": 0})
        elif kind == "fc":
            _, n_out = layer
            n_out = max(4, int(n_out * width_mult))
            d_in = flat_dim if flat_dim is not None else c_in * hw * hw
            m = d_in * n_out
            macs += m
            n_params += d_in * n_out + n_out
            n_neurons += n_out
            per_layer.append({"kind": "fc", "macs": m,
                              "c_in": d_in, "c_out": n_out})
            flat_dim = n_out
            c_in = n_out
        else:
            raise ValueError(kind)
    n_layers = sum(1 for l in spec.layers if l[0] in ("conv", "fc", "residual"))
    return {
        "name": spec.name,
        "macs": macs,
        "params": n_params,
        "neurons": n_neurons,
        "weights_and_neurons": n_params + n_neurons,
        "layers": n_layers,
        "per_layer": per_layer,
    }


def _darknet_stage(c: int, n_blocks: int):
    layers = [("conv", c, 3, 2)]
    for _ in range(n_blocks):
        layers += [("conv", c // 2, 1, 1), ("conv", c, 3, 1), ("residual", 3)]
    return layers


# YOLO-class detector: DarkNet-53-style backbone + detection head.
YOLO_WIDTH = 0.80
YOLO_SPEC = ConvNetSpec(
    name="yolo",
    in_channels=3,
    input_hw=416,
    layers=tuple(
        [("conv", 32, 3, 1)]
        + _darknet_stage(64, 1)
        + _darknet_stage(128, 2)
        + _darknet_stage(256, 8)
        + _darknet_stage(512, 8)
        + _darknet_stage(1024, 4)
        + [("conv", 512, 1, 1), ("conv", 1024, 3, 1), ("conv", 125, 1, 1)]
    ),
)


def _resnet_stage(c: int, n_blocks: int, stride: int):
    layers = [("conv", c, 3, stride)]  # stage entry (projection + downsample)
    for _ in range(n_blocks):
        layers += [("conv", c // 4, 1, 1), ("conv", c // 4, 3, 1),
                   ("conv", c, 1, 1), ("residual", 4)]
    return layers


# SSD-class detector: ResNet-50-style backbone at 512x512 + multiscale heads.
SSD_WIDTH = 0.85
SSD_SPEC = ConvNetSpec(
    name="ssd",
    in_channels=3,
    input_hw=512,
    layers=tuple(
        [("conv", 64, 7, 2), ("maxpool", 3, 2)]
        + _resnet_stage(256, 3, 1)
        + _resnet_stage(512, 4, 2)
        + _resnet_stage(1024, 6, 2)
        + _resnet_stage(2048, 3, 2)
        # extra SSD feature layers + class/box head convs
        + [("conv", 512, 1, 1), ("conv", 512, 3, 2),
           ("conv", 256, 1, 1), ("conv", 256, 3, 2),
           ("conv", 486, 3, 1)]
    ),
)


# GOTURN-class tracker: AlexNet-style twin towers + FC regression head.
GOTURN_WIDTH = 2.1
GOTURN_TOWER = ConvNetSpec(
    name="goturn_tower",
    in_channels=3,
    input_hw=227,
    layers=(
        ("conv", 96, 11, 4), ("maxpool", 3, 2),
        ("conv", 256, 5, 1), ("maxpool", 3, 2),
        ("conv", 384, 3, 1),
        ("conv", 384, 3, 1),
        ("conv", 256, 3, 1), ("maxpool", 3, 2),
        ("globalpool",),
    ),
)
GOTURN_HEAD = ConvNetSpec(
    name="goturn_head",
    in_channels=512,  # concat of two tower outputs (pre width_mult)
    input_hw=1,
    layers=(("fc", 4096), ("fc", 4096), ("fc", 4)),
)


def goturn_stats(width_mult: float = GOTURN_WIDTH) -> dict:
    tower = convnet_stats(GOTURN_TOWER, width_mult)
    c = 2 * max(4, int(256 * width_mult))
    head_spec = ConvNetSpec(name="goturn_head", in_channels=c, input_hw=1,
                            layers=GOTURN_HEAD.layers)
    head = convnet_stats(head_spec, 1.0)
    return {
        "name": "goturn",
        "macs": 2 * tower["macs"] + head["macs"],
        "params": tower["params"] + head["params"],
        "weights_and_neurons": (tower["weights_and_neurons"] * 2
                                + head["weights_and_neurons"]),
        "layers": tower["layers"] + head["layers"],
        "per_layer": tower["per_layer"] + head["per_layer"],
    }


def perception_stats() -> dict:
    return {
        "yolo": convnet_stats(YOLO_SPEC, YOLO_WIDTH),
        "ssd": convnet_stats(SSD_SPEC, SSD_WIDTH),
        "goturn": goturn_stats(),
    }
