"""Domain-randomized scenario fleets (the port of the JAX package's
``core/scenarios.py``).

A base route becomes a fleet of randomized scenarios, each family as one
batched tensor transform over its scenarios:

* ``clean``          — the base route, untouched (the control arm).
* ``sensor_dropout`` — each non-front camera group drops for the whole
  route with probability ``drop_p``; its tasks become invalid rows (the
  front-center group always survives).
* ``weather``        — the task rate scales by r ~ U(0.6, 1.6): arrival
  times divide by r, order-preserving.
* ``burst``          — a cut-in: tasks inside a window around a random
  route point compress toward it (arrival' = c + 0.2 * (arrival - c)), a
  local 5x rate spike; the map is monotone, so arrivals stay sorted.
* ``fault``          — the base route plus an accelerator fail/degrade/
  recover health trace (``core.faults`` semantics).

Every family also returns a ``[T, n]`` health trace per scenario
(all-ones except ``fault``), so consumers treat scenarios uniformly as
(tasks, health) pairs.

Randomness: each family's random numbers form one :class:`ScenarioDraws`,
drawn from a ``torch.Generator`` on the base route's device seeded with
``seed``, or injected by the caller (a test regenerates the JAX package's
``jax.random`` draws and passes them in).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tasks import GROUP_ORDER, TaskArrays

FAMILIES = ("clean", "sensor_dropout", "weather", "burst", "fault")
N_FAULTS = 2


class ScenarioBatch(NamedTuple):
    """A generated scenario fleet: stacked tasks [S, T], aligned health
    traces [S, T, n], and the host-side family label per row."""
    tasks: TaskArrays
    health: torch.Tensor
    family: np.ndarray   # [S] indices into FAMILIES (host array)

    @property
    def num_scenarios(self) -> int:
        return int(self.health.shape[0])

    def family_rows(self, name: str) -> np.ndarray:
        return np.nonzero(self.family == FAMILIES.index(name))[0]


class ScenarioDraws(NamedTuple):
    """One family's random numbers for its P scenarios; a family reads
    only its own fields."""
    keep: torch.Tensor | None = None     # [P, 6] bool: sensor_dropout
    rate: torch.Tensor | None = None     # [P] f32: weather's rate
    burst_u: torch.Tensor | None = None  # [P] f32 in [0, 1): burst centre
    #                                      as a fraction of the last arrival
    perm: torch.Tensor | None = None     # [P, n] a permutation of the cores
    at: torch.Tensor | None = None       # [P, F] int: fault steps
    back: torch.Tensor | None = None     # [P, F] int: recovery delays
    fail: torch.Tensor | None = None     # [P, F] bool: fail, else degrade
    degrade: torch.Tensor | None = None  # [P, F] f32: degrade factors


def _n_faults(n_cores: int) -> int:
    return int(min(N_FAULTS, max(n_cores - 1, 0)))


def family_draws(name: str, gen: torch.Generator, p: int, t: int,
                 n_cores: int, drop_p: float = 0.4, p_fail: float = 0.5
                 ) -> ScenarioDraws:
    """Family ``name``'s draws for ``p`` scenarios of a ``t``-task route,
    from ``gen`` (on its device)."""
    dev = gen.device
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    if name == "sensor_dropout":
        return ScenarioDraws(keep=rand(p, len(GROUP_ORDER)) < 1.0 - drop_p)
    if name == "weather":
        return ScenarioDraws(rate=0.6 + (1.6 - 0.6) * rand(p))
    if name == "burst":
        return ScenarioDraws(burst_u=rand(p))
    if name == "fault":
        f = _n_faults(n_cores)
        randint = lambda lo, hi: torch.randint(  # noqa: E731
            lo, hi, (p, f), generator=gen, device=dev)
        return ScenarioDraws(
            perm=rand(p, n_cores).argsort(-1),
            at=randint(1, max(2 * t // 3, 2)),
            back=randint(max(t // 6, 1), max(t, 2)),
            fail=rand(p, f) < p_fail,
            degrade=0.25 + (0.75 - 0.25) * rand(p, f))
    return ScenarioDraws()


# ---------------------------------------------------------------------------
# per-family transforms: base [T] -> P scenarios [P, T]
# ---------------------------------------------------------------------------

def _clean(base: TaskArrays, dr: ScenarioDraws, p: int) -> TaskArrays:
    return TaskArrays(*[f.expand(p, -1) for f in base])


def _sensor_dropout(base: TaskArrays, dr: ScenarioDraws, p: int
                    ) -> TaskArrays:
    keep = dr.keep.clone()
    keep[:, 0] = True                        # front-center never drops
    out = _clean(base, dr, p)
    return out._replace(valid=out.valid & keep.gather(1, out.group))


def _weather(base: TaskArrays, dr: ScenarioDraws, p: int) -> TaskArrays:
    out = _clean(base, dr, p)
    return out._replace(arrival=out.arrival / dr.rate[:, None])


def _burst(base: TaskArrays, dr: ScenarioDraws, p: int,
           span_frac: float = 0.15, squeeze: float = 0.2) -> TaskArrays:
    out = _clean(base, dr, p)
    total = torch.where(base.valid, base.arrival, 0.0).amax()
    center = (dr.burst_u * total)[:, None]
    width = span_frac * total
    near = (out.arrival - center).abs() < width
    squeezed = center + squeeze * (out.arrival - center)
    return out._replace(arrival=torch.where(near, squeezed, out.arrival))


def _fault_trace(dr: ScenarioDraws, t: int, n_cores: int) -> torch.Tensor:
    """[P, T, n] fail/degrade/recover traces: ``N_FAULTS`` distinct cores
    (never all of them) fault in the first two-thirds of the route and
    recover later — the tensor twin of ``faults.random_fault_events``."""
    cores = dr.perm[:, :_n_faults(n_cores)]                   # [P, F]
    back = dr.at + dr.back
    factor = torch.where(dr.fail, 0.0, dr.degrade)
    steps = torch.arange(t, device=cores.device)
    in_window = ((steps >= dr.at[..., None])
                 & (steps < back[..., None]))                  # [P, F, T]
    onehot = cores[..., None] == torch.arange(n_cores,
                                              device=cores.device)
    # cores are distinct, so the per-fault deltas sum without clashing
    delta = ((in_window[..., None] & onehot[:, :, None, :])
             * (factor[..., None, None] - 1.0)).sum(1)         # [P, T, n]
    return 1.0 + delta


_TRANSFORMS = {"clean": _clean, "sensor_dropout": _sensor_dropout,
               "weather": _weather, "burst": _burst, "fault": _clean}


def scenario_batch(base: TaskArrays, n_cores: int, seed: int,
                   n_per_family: int = 8, families: tuple = FAMILIES,
                   draws: dict | None = None) -> ScenarioBatch:
    """``n_per_family`` scenarios per family from one base route [T],
    each family as one batched transform, on the base route's device.
    ``draws`` maps a family name to its :class:`ScenarioDraws`; without
    it every family draws from one generator seeded with ``seed``."""
    t = base.arrival.shape[0]
    dev = base.arrival.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    task_stacks, health_stacks, labels = [], [], []
    for name in families:
        dr = (draws[name] if draws is not None else
              family_draws(name, gen, n_per_family, t, n_cores))
        dr = ScenarioDraws(*[None if d is None else d.to(dev) for d in dr])
        task_stacks.append(_TRANSFORMS[name](base, dr, n_per_family))
        health_stacks.append(
            _fault_trace(dr, t, n_cores) if name == "fault" else
            torch.ones(n_per_family, t, n_cores, device=dev))
        labels.extend([FAMILIES.index(name)] * n_per_family)
    tasks = TaskArrays(*[torch.cat(f) for f in zip(*task_stacks)])
    return ScenarioBatch(tasks=tasks, health=torch.cat(health_stacks),
                         family=np.asarray(labels, np.int32))


def scenario_lane_batches(batch: ScenarioBatch, lanes: int):
    """Host-side iterator over [lanes, T] / [lanes, T, n] slices (order
    shuffled deterministically by scenario index) — the shape a
    population trainer's ``train_episode(tasks, health=...)`` consumes.
    The tail partial batch is dropped."""
    s = batch.num_scenarios
    order = np.random.default_rng(s).permutation(s)
    for i in range(0, s - lanes + 1, lanes):
        rows = torch.as_tensor(np.sort(order[i:i + lanes]),
                               device=batch.health.device)
        yield (TaskArrays(*[f[rows] for f in batch.tasks]),
               batch.health[rows])
