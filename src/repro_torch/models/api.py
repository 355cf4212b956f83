"""Family-dispatched model API, the port of ``repro.models.api``::

    api = model_api(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = api.loss(params, batch)
    logits, cache = api.prefill(params, {"tokens": tokens})
    logits, cache = api.decode_step(params, cache, token, pos)

Decoder-only configs run ``models.transformer`` (a frontend's
``frontend_embeds`` ride in the batch), encoder-decoder configs
``models.encdec`` (the batch carries ``frontend_embeds``, the source).
``loss`` is ``lm_loss`` / ``encdec_loss``, the training route
(``train.loop.make_train_step`` differentiates it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable          # (generator) -> params on its device
    loss: Callable          # (params, batch) -> (loss, metrics)
    prefill: Callable       # (params, batch) -> (last_logits, cache)
    decode_step: Callable   # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable    # (batch_size, seq_len, ..., device=None) -> cache


def model_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encoder_decoder:
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: ED.init_encdec(gen, cfg),
            loss=lambda p, b: ED.encdec_loss(p, cfg, b),
            prefill=lambda p, b: ED.encdec_prefill(p, cfg, b),
            decode_step=lambda p, c, t, pos: ED.encdec_decode_step(
                p, cfg, c, t, pos),
            init_cache=lambda bs, s, src_len=None, device=None:
                ED.init_encdec_cache(
                    cfg, bs, s, src_len or max(1, s // cfg.encoder_seq_ratio),
                    device),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: T.init_lm(gen, cfg),
        loss=lambda p, b: T.lm_loss(p, cfg, b),
        prefill=lambda p, b: T.lm_prefill(p, cfg, b),
        decode_step=lambda p, c, t, pos: T.lm_decode_step(p, cfg, c, t, pos),
        init_cache=lambda bs, s, device=None: T.init_cache(cfg, bs, s,
                                                           device),
    )
