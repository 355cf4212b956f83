"""Heuristic schedulers on the tensor platform (the port of the JAX
package's ``core/schedulers/scan.py``).

The per-task loop heuristics (``minmin.py`` / ``ata.py`` / ``worst.py``)
stay as oracles; these are their tensor twins on ``platform_step``, so
comparisons against FlexAI's engine run through the same substrate.
Each runs a [R, T] route batch in one Python loop over the task axis (the
place of ``vmap`` over routes); ``get_scan_scheduler(name)`` wraps one for
a single [T] route.  The loops read nothing back from the device.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.faults import start_trace, window_health
from repro_torch.core.platform import (PlatformSpec, _at, health_capacity,
                                       platform_init, platform_step, route,
                                       spec_from_platform, stack_records,
                                       summarize, with_health)
from repro_torch.core.tasks import (TaskArrays, tasks_to_arrays,
                                    window_task_arrays)
from repro_torch.kernels.protocol import resolve_device, synchronize


def _setup(spec: PlatformSpec, tasks: TaskArrays, state0, alive, health):
    """(initial state [R, n], alive mask [R, n], trace [R, T, n] or None:
    ``faults.start_trace``)."""
    r = tasks.arrival.shape[0]
    dev = spec.device
    state, trace = start_trace(
        platform_init(spec.n, r, dev) if state0 is None else state0,
        health, dev)
    mask = (torch.ones(spec.n, dtype=torch.bool, device=dev)
            if alive is None else torch.as_tensor(alive, device=dev))
    return state, mask.expand(r, spec.n), trace


def worst_scan(spec: PlatformSpec, tasks: TaskArrays, state0=None,
               alive=None, health=None):
    """Everything onto one accelerator (the unscheduled worst case):
    accelerator 0, or the first alive one under a fault mask / at each
    step of a ``health`` trace ([R, T, n], core.faults)."""
    state, mask, trace = _setup(spec, tasks, state0, alive, health)
    recs = []
    for t in range(tasks.arrival.shape[1]):
        if trace is not None:
            state = with_health(state, trace[:, t])
        target = (mask & state.alive).byte().argmax(-1)
        state, rec = platform_step(spec, state, tasks.step(t), target)
        recs.append(rec)
    return state, stack_records(recs)


def ata_scan(spec: PlatformSpec, tasks: TaskArrays, state0=None,
             alive=None, health=None):
    """ATA: lowest-energy accelerator meeting the safety time; fastest
    response as the deadline-salvage fallback (mirrors ``ATAScheduler``).
    ``alive`` ([n] or [R, n] bool) drops dead accelerators from both
    argmins; a ``health`` trace ([R, T, n]) drops per-step failures too
    and inflates throttled cores' response and energy by 1/capacity."""
    state, mask, trace = _setup(spec, tasks, state0, alive, health)
    recs = []
    for t in range(tasks.arrival.shape[1]):
        task = tasks.step(t)
        if trace is not None:
            state = with_health(state, trace[:, t])
        eff = health_capacity(state)
        ok = mask & state.alive
        arrival = task.arrival[:, None]
        resp = (torch.maximum(arrival, state.avail)
                + spec.exec_time.T[task.kind] / eff - arrival)
        feasible = (resp <= task.safety[:, None]) & ok
        energy = spec.energy.T[task.kind] / eff
        a_feas = torch.where(feasible, energy, torch.inf).argmin(-1)
        action = torch.where(feasible.any(-1), a_feas,
                             torch.where(ok, resp, torch.inf).argmin(-1))
        state, rec = platform_step(spec, state, task, action)
        recs.append(rec)
    return state, stack_records(recs)


def minmin_scan(spec: PlatformSpec, tasks: TaskArrays, state0=None,
                window: int = 30, alive=None, incremental: bool = True,
                health=None):
    """Windowed Min-Min: windows of ``window`` tasks; each inner step
    commits the (task, accelerator) pair with the smallest completion time
    among the window's unscheduled rows, row-major tie-break like the
    NumPy loop.  Padding rows start pre-scheduled, and a step of an
    all-scheduled window is a masked no-op ``platform_step``.

    A ``health`` trace ([R, T, n]) is sampled once per window, at the
    window's first task index, and held while the window commits.

    ``incremental=True`` carries the [R, W, n] completion-time matrix
    through the inner steps: committing ``(ti, a)`` only moves
    ``avail[a]``, so row ``ti`` goes to inf and column ``a`` is recomputed
    with the same elementwise expression.  ``incremental=False`` rebuilds
    the matrix every step (the parity oracle).
    """
    n = spec.n
    dev = spec.device
    state, mask, trace = _setup(spec, tasks, state0, alive, health)
    win = window_task_arrays(tasks, window)              # [R, NW, W]
    whealth = (None if trace is None
               else window_health(trace, window))        # [R, NW, n]
    r = tasks.arrival.shape[0]
    rows = torch.arange(window, device=dev)
    cols = torch.arange(n, device=dev)

    def ct_full(wt, state, scheduled):
        eff = health_capacity(state)
        ok = mask & state.alive
        ct = (torch.maximum(wt.arrival[:, :, None], state.avail[:, None, :])
              + spec.exec_time.T[wt.kind] / eff[:, None, :])   # [R, W, n]
        ct = torch.where(ok[:, None, :], ct, torch.inf)
        return torch.where(scheduled[:, :, None], torch.inf, ct)

    recs = []
    for w in range(win.arrival.shape[1]):
        wt = TaskArrays(*[f[:, w] for f in win])
        if whealth is not None:
            state = with_health(state, whealth[:, w])
        scheduled = ~wt.valid
        ct = ct_full(wt, state, scheduled) if incremental else None
        for _ in range(window):
            if not incremental:
                ct = ct_full(wt, state, scheduled)
            flat = ct.reshape(r, -1).argmin(-1)
            ti, a = flat // n, flat % n
            ok = ~_at(scheduled, ti)           # False if all done
            task_i = TaskArrays(*[_at(f, ti) for f in wt])
            state, rec = platform_step(spec, state, task_i, a, valid=ok)
            scheduled = scheduled | (rows == ti[:, None])
            recs.append(rec)
            if incremental:
                eff_a = _at(health_capacity(state), a)
                col = (torch.maximum(wt.arrival,
                                     _at(state.avail, a)[:, None])
                       + spec.exec_time[a[:, None], wt.kind]
                       / eff_a[:, None])                          # [R, W]
                live = _at(mask & state.alive, a)
                col = torch.where(live[:, None] & ~scheduled, col, torch.inf)
                ct = torch.where((rows == ti[:, None])[:, :, None],
                                 torch.inf, ct)
                ct = torch.where((cols == a[:, None])[:, None, :],
                                 col[:, :, None], ct)
    return state, stack_records(recs)


SCAN_SCHEDULERS = {
    "worst": worst_scan,
    "ata": ata_scan,
    "minmin": minmin_scan,
}


def single_route(run):
    """Wrap a batched ``run(spec, tasks [R, T], state0=None, ...,
    health=None)`` for one route: tasks [T], state0 [n], health [T, n];
    returns the route's state and records without the route axis."""
    def single(spec, tasks, state0=None, health=None, **kw):
        tasks = TaskArrays(*[f[None] for f in tasks])
        if state0 is not None:
            state0 = type(state0)(*[f[None] for f in state0])
        if health is not None:
            health = torch.as_tensor(health)[None]
        final, recs = run(spec, tasks, state0=state0, health=health, **kw)
        return route(final, 0), route(recs, 0)
    return single


def get_scan_scheduler(name: str, batched: bool = False):
    """The scan heuristic ``name``: ``fn(spec, tasks, state0=None,
    ..., health=None)``, over a [R, T] batch or (default) one [T] route."""
    fn = SCAN_SCHEDULERS[name]
    return fn if batched else single_route(fn)


def package_device_summary(spec, final, recs, dt: float,
                           n_tasks: int) -> dict:
    """``Scheduler.schedule``-shaped summary of one route: metrics via
    ``summarize``, wall time per task, and the committed placements
    trimmed to valid (non-padding) rows."""
    summ = summarize(spec, final, recs)
    summ["schedule_time_s"] = dt
    summ["schedule_time_per_task_s"] = dt / max(n_tasks, 1)
    summ["placements"] = recs.action.cpu().numpy()[
        recs.valid.cpu().numpy().astype(bool)]
    return summ


def scan_schedule(name: str, platform, tasks, device=None) -> dict:
    """Mirror of ``Scheduler.schedule`` (same summary keys) for one route
    through the scan heuristic ``name`` on ``device`` (default: the
    GPU)."""
    dev = resolve_device(device)
    spec = spec_from_platform(platform, dev)
    ta = tasks if isinstance(tasks, TaskArrays) else tasks_to_arrays(tasks)
    ta = ta.to(dev)
    t0 = time.perf_counter()
    final, recs = get_scan_scheduler(name)(spec, ta)
    synchronize(dev)
    dt = time.perf_counter() - t0
    return package_device_summary(spec, final, recs, dt, ta.num_tasks)

