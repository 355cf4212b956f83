"""Genetic algorithm scheduler (Hou et al. lineage, paper baseline).

Windowed: each window of tasks is assigned by evolving a population of
assignment vectors.  The fitness follows the paper's Table-11
characterization of guided random search — time + energy only (no resource
balance, no MS), which is exactly why GA trails FlexAI on those metrics.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.schedulers.base import Scheduler, register


def _evaluate(platform: HMAIPlatform, tasks, assignment) -> float:
    """Fitness = -(makespan + energy) simulated on a scratch copy."""
    avail = platform.avail.copy()
    energy = 0.0
    makespan = platform.T.max() if platform.n else 0.0
    for task, i in zip(tasks, assignment):
        et = platform.exec_time(task, i)
        start = max(task.arrival_time, avail[i])
        avail[i] = start + et
        energy += platform.specs[i].energy(task.kind)
        makespan = max(makespan, avail[i])
    return -(makespan + 0.1 * energy)


class _WindowedSearch(Scheduler):
    window = 30

    def optimize_window(self, platform, tasks, rng) -> np.ndarray:
        raise NotImplementedError

    def schedule(self, platform: HMAIPlatform, tasks: list) -> dict:
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        for w0 in range(0, len(tasks), self.window):
            batch = tasks[w0: w0 + self.window]
            assignment = self.optimize_window(platform, batch, rng)
            for task, i in zip(batch, assignment):
                platform.execute(task, int(i))
        dt = time.perf_counter() - t0
        summ = platform.summary()
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(len(tasks), 1)
        return summ


@register
class GAScheduler(_WindowedSearch):
    name = "ga"

    def __init__(self, window: int = 30, population: int = 16,
                 generations: int = 10, mutation: float = 0.1):
        self.window = window
        self.population = population
        self.generations = generations
        self.mutation = mutation

    def optimize_window(self, platform, tasks, rng) -> np.ndarray:
        n, m = len(tasks), platform.n
        pop = rng.integers(0, m, size=(self.population, n))
        for _ in range(self.generations):
            fit = np.array([_evaluate(platform, tasks, ind) for ind in pop])
            order = np.argsort(-fit)
            elite = pop[order[: self.population // 2]]
            children = []
            while len(children) < self.population - len(elite):
                a, b = elite[rng.integers(0, len(elite), 2)]
                cx = rng.integers(1, n) if n > 1 else 0
                child = np.concatenate([a[:cx], b[cx:]])
                mut = rng.random(n) < self.mutation
                child = np.where(mut, rng.integers(0, m, n), child)
                children.append(child)
            pop = np.vstack([elite] + children)
        fit = np.array([_evaluate(platform, tasks, ind) for ind in pop])
        return pop[int(np.argmax(fit))]
