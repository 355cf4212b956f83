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
(``train.loop.make_train_step`` differentiates it).  Parameters (and a
decode cache) of ``DTensor`` leaves placed by their specs send
``prefill`` and ``decode_step`` to ``models.partitioned`` (the prefill
under ``DEFAULT_RULES``, the decode under ``DECODE_RULES``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import encdec as ED
from repro_torch.models import partitioned as PT
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.partition import is_dtensor


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable          # (generator) -> params on its device
    loss: Callable          # (params, batch) -> (loss, metrics)
    prefill: Callable       # (params, batch) -> (last_logits, cache)
    decode_step: Callable   # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable    # (batch_size, seq_len, ..., device=None) -> cache


def _routed(cfg: ModelConfig, prefill, decode_step):
    """(prefill, decode_step) that take ``models.partitioned``'s route
    when the parameters are ``DTensor`` leaves."""
    def pre(p, b):
        if is_dtensor(p["embed"]):
            return PT.prefill(cfg, p, b)
        return prefill(p, cfg, b)

    def dec(p, c, t, pos):
        if is_dtensor(p["embed"]):
            return PT.decode_step(cfg, p, c, t, pos)
        return decode_step(p, cfg, c, t, pos)
    return pre, dec


def model_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encoder_decoder:
        pre, dec = _routed(cfg, ED.encdec_prefill, ED.encdec_decode_step)
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: ED.init_encdec(gen, cfg),
            loss=lambda p, b: ED.encdec_loss(p, cfg, b),
            prefill=pre,
            decode_step=dec,
            init_cache=lambda bs, s, src_len=None, device=None:
                ED.init_encdec_cache(
                    cfg, bs, s, src_len or max(1, s // cfg.encoder_seq_ratio),
                    device),
        )
    pre, dec = _routed(cfg, T.lm_prefill, T.lm_decode_step)
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: T.init_lm(gen, cfg),
        loss=lambda p, b: T.lm_loss(p, cfg, b),
        prefill=pre,
        decode_step=dec,
        init_cache=lambda bs, s, device=None: T.init_cache(cfg, bs, s,
                                                           device),
    )
