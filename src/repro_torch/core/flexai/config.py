"""FlexAI training configuration (the JAX package's ``agent.FlexAIConfig``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlexAIConfig:
    gamma: float = 0.95
    lr: float = 1e-3           # paper §8.3 uses 0.01; 1e-3 is stable with Adam
    batch_size: int = 64
    replay_capacity: int = 50_000
    min_replay: int = 256
    target_sync_every: int = 200
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 20_000
    update_every: int = 1
    backlog_scale: float = 1.0  # seconds; HW-Info backlog -> log1p(b/scale)
    seed: int = 0
