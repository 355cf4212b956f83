"""Deterministic, step-indexed synthetic data: the port's copy of
``repro.train.data`` (NumPy only, the same draws byte for byte).

Every batch is a pure function of (seed, step), which is what makes
checkpoint-restart exact: a job restarted at step k consumes the same batch
stream it would have seen, with no persisted iterator state (the skip-ahead
the fault-tolerance runner relies on).

For language modelling the stream is a mixture of (a) a repeating-ngram
synthetic language, which has learnable structure so loss decreases, and
(b) uniform noise tokens.  Batches are NumPy arrays; the train step moves
them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int
    seed: int = 0
    structure: float = 0.9  # fraction of learnable (ngram) tokens


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_batch_at_step(cfg: ModelConfig, data: DataConfig, step: int) -> dict:
    """Markov-chain tokens: next token = (3*tok + 7) % V with noise."""
    rng = _rng(data.seed, step)
    b, s, v = data.batch_size, data.seq_len, cfg.vocab_size
    start = rng.integers(0, v, size=(b, 1))
    toks = [start]
    for _ in range(s):
        nxt = (3 * toks[-1] + 7) % v
        noise = rng.integers(0, v, size=(b, 1))
        use_noise = rng.random((b, 1)) > data.structure
        toks.append(np.where(use_noise, noise, nxt))
    seq = np.concatenate(toks, axis=1).astype(np.int32)  # [B, S+1]
    batch = {
        "tokens": seq[:, :-1],
        "labels": seq[:, 1:],
        "loss_mask": np.ones((b, s), dtype=np.float32),
    }
    if cfg.frontend is not None:
        t = max(1, cfg.num_frontend_tokens)
        batch["frontend_embeds"] = rng.standard_normal(
            (b, t, cfg.d_model)).astype(np.float32)
    return batch


def batch_fn(cfg: ModelConfig, data: DataConfig):
    return lambda step: lm_batch_at_step(cfg, data, step)
