"""Open-loop load generation for the serving layer (the port of
``repro.serve.loadgen``).

Seeded arrival processes (Poisson for memoryless traffic, Gamma renewal
for bursty traffic with a tunable squared coefficient of variation) over
request bodies drawn from the scenario families of ``core.scenarios``, so
the QoS engine faces the same variability mix the fleet trainers see.

Open loop: arrivals do not wait for completions.  The whole arrival
schedule is fixed up front from ``offered_load`` (arrival rate as a
multiple of the service rate), and the engine keeps up, falls behind or
sheds on its own.

Arrival times and the row order come from numpy ``default_rng`` seeded
as in the JAX package, so they equal its trace.  The route bodies come
from the port's ``scenario_batch``, whose draws are a ``torch.Generator``'s
(CPU and CUDA generators give different streams); ``draws=`` injects
each family's draws instead, so a test can feed the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.scenarios import FAMILIES, scenario_batch
from repro_torch.core.tasks import TaskArrays

# the serving families: "fault" rows equal "clean" task for task (their
# payload is the health trace, which serving does not take)
SERVE_FAMILIES = ("clean", "sensor_dropout", "weather", "burst")


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """Knobs of one open-loop trace."""
    process: str = "poisson"       # "poisson" | "gamma"
    n_requests: int = 32
    offered_load: float = 1.0      # mean arrival rate / service rate
    burstiness: float = 4.0        # gamma: squared CV of the arrival gaps
    families: tuple = SERVE_FAMILIES
    seed: int = 0

    def __post_init__(self):
        if self.process not in ("poisson", "gamma"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.offered_load <= 0.0:
            raise ValueError("offered_load must be > 0")
        if self.burstiness <= 0.0:
            raise ValueError("burstiness must be > 0")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        unknown = set(self.families) - set(FAMILIES)
        if unknown:
            raise ValueError(f"unknown scenario families {sorted(unknown)}")


class LoadRequest(NamedTuple):
    """One generated request: the route body [T], its absolute arrival
    time, and the scenario family it was drawn from."""
    tasks: TaskArrays
    arrival: float
    family: str


def arrival_times(cfg: LoadGenConfig, mean_gap: float) -> np.ndarray:
    """[n_requests] absolute arrival instants, deterministic in
    ``cfg.seed``.  The mean gap is ``mean_gap`` for both processes; the
    gamma process has gap CV^2 = ``burstiness`` (shape 1/burstiness)."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.process == "poisson":
        gaps = rng.exponential(mean_gap, cfg.n_requests)
    else:
        k = 1.0 / cfg.burstiness
        gaps = rng.gamma(k, mean_gap * cfg.burstiness, cfg.n_requests)
    return np.cumsum(gaps)


def generate(base: TaskArrays, n_cores: int, cfg: LoadGenConfig,
             mean_service: float, draws: dict | None = None
             ) -> list[LoadRequest]:
    """``n_requests`` scenario-family routes of ``base`` [T] (on its
    device) with arrival instants at ``offered_load`` times the service
    rate: the mean gap is ``mean_service / offered_load``.  ``draws``
    maps a family name to its ``ScenarioDraws`` (``scenario_batch``)."""
    per_family = -(-cfg.n_requests // len(cfg.families))  # ceil
    batch = scenario_batch(base, n_cores, cfg.seed,
                           n_per_family=per_family,
                           families=tuple(cfg.families), draws=draws)
    order = np.random.default_rng(cfg.seed + 1).permutation(
        batch.num_scenarios)[: cfg.n_requests]
    arrivals = arrival_times(cfg, mean_service / cfg.offered_load)
    return [LoadRequest(tasks=TaskArrays(*[f[row] for f in batch.tasks]),
                        arrival=float(t),
                        family=FAMILIES[int(batch.family[row])])
            for t, row in zip(arrivals, order)]


def submit_trace(engine, trace: list[LoadRequest]) -> list:
    """Feed a generated trace into a ``QoSPlacementEngine``; returns the
    engine's ``RouteRequest`` handles aligned with the trace."""
    return [engine.submit(r.tasks, arrival=r.arrival) for r in trace]
