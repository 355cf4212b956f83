"""The paper's three perception workloads, runnable: YOLO-class, SSD-class,
GOTURN-class (the port of the JAX package's ``models/perception/nets.py``).

The specs and full widths live in :mod:`repro_torch.models.perception.stats`
(YOLO 0.80 at 416², SSD 0.85 at 512², GOTURN 2.1 at 227²).  Every apply
function takes ``dataflow``, the conv kernel its convolutions run
through (:func:`repro_torch.kernels.conv_dataflow.conv2d`).
"""
from __future__ import annotations

import torch

from repro_torch.models.perception.cnn import (convnet_apply,
                                               convnet_params_from_numpy,
                                               init_convnet)
from repro_torch.models.perception.stats import (GOTURN_HEAD, GOTURN_TOWER,
                                                 GOTURN_WIDTH, SSD_SPEC,
                                                 SSD_WIDTH, YOLO_SPEC,
                                                 YOLO_WIDTH, ConvNetSpec)

PERCEPTION_SPECS = {
    "yolo": (YOLO_SPEC, YOLO_WIDTH),
    "ssd": (SSD_SPEC, SSD_WIDTH),
    "goturn": (GOTURN_TOWER, GOTURN_WIDTH),
}


def init_yolo(generator: torch.Generator, width_mult: float = YOLO_WIDTH,
              dtype=torch.float32, device=None):
    return init_convnet(generator, YOLO_SPEC, width_mult, dtype, device)


def yolo_apply(params, x, width_mult: float = YOLO_WIDTH, *,
               dataflow: str = "MconvMC"):
    del width_mult
    return convnet_apply(params, YOLO_SPEC, x, dataflow=dataflow)


def init_ssd(generator: torch.Generator, width_mult: float = SSD_WIDTH,
             dtype=torch.float32, device=None):
    return init_convnet(generator, SSD_SPEC, width_mult, dtype, device)


def ssd_apply(params, x, width_mult: float = SSD_WIDTH, *,
              dataflow: str = "MconvMC"):
    del width_mult
    return convnet_apply(params, SSD_SPEC, x, dataflow=dataflow)


def goturn_head_spec(in_channels: int) -> ConvNetSpec:
    """The FC head over the concat of the two towers' outputs."""
    return ConvNetSpec(name="goturn_head", in_channels=in_channels,
                       input_hw=1, layers=GOTURN_HEAD.layers)


def init_goturn(generator: torch.Generator,
                width_mult: float = GOTURN_WIDTH, dtype=torch.float32,
                device=None):
    tower = init_convnet(generator, GOTURN_TOWER, width_mult, dtype, device)
    # head input = 2 towers of (256 * width) channels
    head_spec = goturn_head_spec(2 * max(4, int(256 * width_mult)))
    head = init_convnet(generator, head_spec, 1.0, dtype, device)
    return {"tower": tower, "head": head, "head_spec": head_spec}


def goturn_apply(params, prev_crop, curr_crop, *, dataflow: str = "MconvMC"):
    f1 = convnet_apply(params["tower"], GOTURN_TOWER, prev_crop,
                       dataflow=dataflow)
    f2 = convnet_apply(params["tower"], GOTURN_TOWER, curr_crop,
                       dataflow=dataflow)
    feats = torch.cat([f1, f2], dim=-1)
    return convnet_apply(params["head"], params["head_spec"], feats,
                         dataflow=dataflow)


def goturn_params_from_numpy(params: dict, device="cpu") -> dict:
    """The JAX package's unboxed ``init_goturn`` dict -> the port's: the
    tower and head lists as in :func:`convnet_params_from_numpy`, and the
    head spec rebuilt from the head's input width."""
    head = convnet_params_from_numpy(params["head"], device)
    return {"tower": convnet_params_from_numpy(params["tower"], device),
            "head": head, "head_spec": goturn_head_spec(head[0]["w"].shape[0])}
