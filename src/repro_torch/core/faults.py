"""Deterministic fault model: schedules, health traces and replays (the
port of the JAX package's ``core/faults.py``).

* a **fault schedule** is a list of :class:`FaultEvent` — (step, core,
  factor) triples where ``factor`` 0.0 fails the core, 1.0 recovers it,
  and anything in (0, 1) throttles it to that capacity;
* :func:`build_health_trace` compiles a schedule into the dense
  ``[T, n]`` **health trace** the engines consume: row ``t`` is the
  capacity vector in force when the ``t``-th task commits;
* every engine installs a trace row with ``platform.with_health`` before
  its policy runs, so dead cores drop out of the action support and
  throttled cores advertise inflated effective exec times.

Granularity contract: per-task engines (FlexAI, worst, ATA) sample the
trace at every task index; windowed engines (Min-Min, GA, SA) sample it
once at each window's first task index and hold it for the window
(:func:`window_health`).

``random_fault_events`` draws with NumPy's ``default_rng``, the same
calls as the JAX package's, so a seed gives the same schedule in both.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.platform import (PlatformSpec, platform_init,
                                       platform_step, route, stack_records,
                                       with_health)
from repro_torch.core.tasks import TaskArrays


class FaultEvent(NamedTuple):
    """One scheduled health transition: at task index ``step``, core
    ``core`` moves to capacity ``factor`` (0.0 = fail, 1.0 = recover, else
    degrade) and stays there until its next event."""
    step: int
    core: int
    factor: float


def build_health_trace(n_steps: int, n_cores: int,
                       events: list) -> np.ndarray:
    """Compile a fault schedule into the dense [n_steps, n_cores] f32
    health trace (carry-forward semantics; all-healthy rows are 1.0)."""
    trace = np.ones((max(n_steps, 1), n_cores), np.float32)
    for ev in sorted(events, key=lambda e: e.step):
        if not 0 <= ev.core < n_cores:
            raise ValueError(
                f"fault event core {ev.core} out of range for "
                f"{n_cores} accelerators")
        if ev.step < n_steps:
            trace[max(ev.step, 0):, ev.core] = np.float32(ev.factor)
    return trace


def random_fault_events(seed: int, n_steps: int, n_cores: int,
                        n_faults: int = 2, recover: bool = True,
                        degrade_range: tuple = (0.25, 0.75),
                        p_fail: float = 0.5) -> list:
    """Seeded random fail/degrade/recover schedule.

    Draws ``n_faults`` distinct cores; each faults at a random step in the
    first two-thirds of the route (fail with probability ``p_fail``, else
    a degrade drawn from ``degrade_range``) and, with ``recover=True``,
    returns to full health at a later step.  ``n_faults`` is clamped to
    ``n_cores - 1`` so at least one core survives.
    """
    rng = np.random.default_rng(seed)
    n_faults = int(min(n_faults, max(n_cores - 1, 0)))
    cores = rng.choice(n_cores, size=n_faults, replace=False)
    events = []
    for core in cores:
        lo, hi = 1, max(2 * n_steps // 3, 2)
        at = int(rng.integers(lo, hi))
        if rng.uniform() < p_fail:
            factor = 0.0
        else:
            factor = float(rng.uniform(*degrade_range))
        events.append(FaultEvent(step=at, core=int(core), factor=factor))
        if recover:
            back = int(rng.integers(at + max(n_steps // 6, 1),
                                    max(n_steps, at + 2)))
            events.append(FaultEvent(step=back, core=int(core), factor=1.0))
    return events


def window_health(trace: torch.Tensor, window: int) -> torch.Tensor:
    """[..., T, n] trace -> [..., n_windows, n]: the row at each window's
    FIRST task index, the tail window padded with the last row (as
    ``tasks.window_task_arrays`` pads the tasks)."""
    pad = -trace.shape[-2] % window
    if pad:
        trace = torch.cat([trace, trace[..., -1:, :].expand(
            *trace.shape[:-2], pad, trace.shape[-1])], dim=-2)
    return trace[..., ::window, :]


def healthy_trace(n_steps: int, n_cores: int) -> np.ndarray:
    """The trivial all-alive trace (capacity 1.0 everywhere)."""
    return np.ones((max(n_steps, 1), n_cores), np.float32)


def start_trace(state, health, device):
    """Begin a run under an optional health trace: ``(state, trace)``.
    With a trace, ``trace`` is it as f32 on ``device`` and the run
    installs its rows.  Without one, ``trace`` is None and the state's
    cores are made healthy here, once: ``platform_step`` passes ``alive``
    and ``cap`` through, so this equals the JAX package's default of an
    all-ones row installed before every step, with no op a step."""
    if health is None:
        return with_health(state, torch.ones_like(state.cap)), None
    return state, torch.as_tensor(health, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# task-major action replay (the reference semantics of a fault trace)
# ---------------------------------------------------------------------------

def replay_actions(spec: PlatformSpec, tasks: TaskArrays, actions,
                   health=None, state0=None):
    """Replay FIXED placements under a fault trace: one ``platform_step``
    per task in stream order, health row ``t`` installed before step
    ``t``.  This is the reference execution semantics every fault-trace
    engine must reproduce, and the evaluation path of a fault-BLIND
    scheduler (dead-core picks pay the ``HEALTH_FLOOR`` penalty).

    Single route: tasks / actions [T], health [T, n], state [n].  A
    leading route axis on all of them replays a batch."""
    single = tasks.arrival.dim() == 1
    dev = spec.device
    if single:
        tasks = TaskArrays(*[f[None] for f in tasks])
        actions = torch.as_tensor(actions)[None]
        health = None if health is None else \
            torch.as_tensor(health)[None]
        state0 = None if state0 is None else \
            type(state0)(*[f[None] for f in state0])
    r, t_len = tasks.arrival.shape
    actions = torch.as_tensor(actions, device=dev)
    state, trace = start_trace(
        platform_init(spec.n, r, dev) if state0 is None else state0,
        health, dev)
    recs = []
    for t in range(t_len):
        if trace is not None:
            state = with_health(state, trace[:, t])
        state, rec = platform_step(spec, state, tasks.step(t),
                                   actions[:, t])
        recs.append(rec)
    recs = stack_records(recs)
    return (route(state, 0), route(recs, 0)) if single else (state, recs)
