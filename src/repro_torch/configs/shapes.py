"""Assigned input-shape cells and their boxed input specs, the port of
``repro.configs.shapes``.

Four cells per architecture (40 total):

    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill_step
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524,288 global_batch 1     -> serve_step

``long_500k`` requires sub-quadratic attention / bounded cache: it runs for
SSM (mamba2), hybrid (jamba), and SWA (h2o-danube) archs, and is marked
skipped for pure full-attention archs.  The specs are ``Param`` boxes of
empty meta tensors (shape, dtype and logical axes; no allocation).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import Param


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def long_context_capable(cfg: ModelConfig) -> bool:
    """True when the arch has sub-quadratic attention / bounded decode state."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.sliding_window is not None


def cell_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not long_context_capable(cfg):
        return False, "pure full-attention arch: unbounded 500k decode cache"
    return True, ""


def _spec(shape, dtype, axes) -> Param:
    return Param(torch.empty(shape, dtype=dtype, device="meta"), axes)


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Boxed meta stand-ins for a training (or prefill) batch."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.is_encoder_decoder:
        src = s // cfg.encoder_seq_ratio
        s_text, front = s, ((b, src, cfg.d_model), ("batch", "seq", None))
    elif cfg.frontend is not None:
        t = cfg.num_frontend_tokens
        s_text, front = s - t, ((b, t, cfg.d_model), ("batch", None, None))
    else:
        s_text, front = s, None
    out = {
        "tokens": _spec((b, s_text), torch.int32, ("batch", None)),
        "labels": _spec((b, s_text), torch.int32, ("batch", None)),
        "loss_mask": _spec((b, s_text), torch.float32, ("batch", None)),
    }
    if front is not None:
        out["frontend_embeds"] = _spec(front[0], torch.float32, front[1])
    return out


def decode_token_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    return {"token": _spec((cell.global_batch, 1), torch.int32,
                           ("batch", None))}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """All model inputs for a cell as boxed meta tensors."""
    cell = SHAPES[shape_name]
    if cell.step in ("train", "prefill"):
        return train_batch_specs(cfg, cell)
    return decode_token_specs(cfg, cell)
