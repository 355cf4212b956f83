"""Simulated annealing scheduler (Kirkpatrick lineage, paper baseline).

Windowed like GA; neighbour move = reassign one task.  Cost = makespan +
energy (Table 11: no R_Balance / MS terms).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedulers.base import register
from repro_torch.core.schedulers.ga import _WindowedSearch, _evaluate


@register
class SAScheduler(_WindowedSearch):
    name = "sa"

    def __init__(self, window: int = 30, iters: int = 120,
                 t_start: float = 1.0, t_end: float = 0.01):
        self.window = window
        self.iters = iters
        self.t_start = t_start
        self.t_end = t_end

    def optimize_window(self, platform, tasks, rng) -> np.ndarray:
        n, m = len(tasks), platform.n
        cur = rng.integers(0, m, size=n)
        cur_fit = _evaluate(platform, tasks, cur)
        best, best_fit = cur.copy(), cur_fit
        for it in range(self.iters):
            temp = self.t_start * (self.t_end / self.t_start) ** (
                it / max(self.iters - 1, 1))
            cand = cur.copy()
            cand[rng.integers(0, n)] = rng.integers(0, m)
            fit = _evaluate(platform, tasks, cand)
            if fit > cur_fit or rng.random() < np.exp(
                    (fit - cur_fit) / max(temp, 1e-9)):
                cur, cur_fit = cand, fit
                if fit > best_fit:
                    best, best_fit = cand.copy(), fit
        return best
