"""Unscheduled baselines (paper §8.3's "worse case"; the port's copy of
the JAX package's ``core/schedulers/worst.py``)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.schedulers.base import Scheduler, register


@register
class WorstCaseScheduler(Scheduler):
    """Everything piles onto one accelerator — the unscheduled worst case
    (maximal queueing, minimal resource balance)."""
    name = "worst"

    def assign(self, platform: HMAIPlatform, task) -> int:
        return 0


@register
class RandomScheduler(Scheduler):
    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def assign(self, platform: HMAIPlatform, task) -> int:
        return int(self.rng.integers(0, platform.n))
