"""GA/SA metaheuristics on the tensor platform (the port of the JAX
package's ``core/schedulers/metaheuristic_jax.py``).

The NumPy baselines (``ga.py`` / ``sa.py``) re-simulate the platform one
task per Python iteration, per individual.  Here a window's whole
population is scored as one tensor op:

* ``window_fitness`` — the Table-11 guided-random-search fitness
  (-(makespan + 0.1 * energy)) of candidate window assignments, from a
  snapshot ``PlatformState``, mutating nothing;
* GA window search — per generation, elite selection by stable-sorted
  fitness, uniform parent draws among the elites, one-point crossover and
  masked mutation;
* SA window search — ``chains`` annealing chains of single-task
  reassignments with Metropolis acceptance (or, with ``tempering``, fixed
  temperatures on a ladder and replica exchange); the best state wins;
* the route driver walks the route window by window and commits the
  winning assignment through ``platform_step``.

Every route of a [R, T] batch runs in the same Python loops (the place
of ``vmap``); the loops read nothing back from the device.

Randomness: the JAX package draws with ``jax.random`` inside the search.
Here all of a run's random numbers form one ``GADraws`` / ``SADraws``
tuple, drawn up front from a ``torch.Generator`` on the device seeded
with ``seed``, or injected by the caller (a test regenerates the JAX key
tree's draws and passes them in, to hold the two searches to one
trajectory).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.core.faults import start_trace, window_health
from repro_torch.core.platform import (PlatformSpec, PlatformState,
                                       health_capacity, platform_init,
                                       platform_step, route,
                                       spec_from_platform, stack_records,
                                       with_health)
from repro_torch.core.schedulers.base import Scheduler, register
from repro_torch.core.schedulers.scan import package_device_summary
from repro_torch.core.tasks import (TaskArrays, tasks_to_arrays,
                                    window_task_arrays)
from repro_torch.kernels.protocol import resolve_device, synchronize


class GAConfig(NamedTuple):
    """Mirrors ``GAScheduler``'s hyperparameters (paper Table 11)."""
    window: int = 30
    population: int = 16
    generations: int = 10
    mutation: float = 0.1


class SAConfig(NamedTuple):
    """Mirrors ``SAScheduler``; ``chains`` parallel annealing chains.

    ``tempering=True`` holds each chain at a FIXED temperature on a
    geometric ladder from ``t_start`` (hot, chain 0) to ``t_end`` (cold),
    and every ``exchange_every`` iterations adjacent chains attempt a
    replica-exchange Metropolis swap (parallel tempering, not Kirkpatrick
    annealing: no cooling schedule).
    """
    window: int = 30
    iters: int = 120
    t_start: float = 1.0
    t_end: float = 0.01
    chains: int = 8
    tempering: bool = False
    exchange_every: int = 10


class GADraws(NamedTuple):
    """A GA run's random numbers, per route r and window w ([R, NW, ...]):
    the initial population, then per generation g the parents' elite
    indices, the crossover points, the mutation uniforms and the mutation
    values."""
    init: torch.Tensor      # [R, NW, P, W] int in [0, n)
    parents: torch.Tensor   # [R, NW, G, C, 2] int in [0, P // 2)
    cx: torch.Tensor        # [R, NW, G, C] int in [1, max(W, 2))
    mut_u: torch.Tensor     # [R, NW, G, C, W] f32 in [0, 1)
    mut_val: torch.Tensor   # [R, NW, G, C, W] int in [0, n)


class SADraws(NamedTuple):
    """An SA run's random numbers ([R, NW, ...]): the initial chains,
    then per iteration i the proposal positions and values, the
    acceptance uniforms and (``tempering`` only) the exchange
    uniforms."""
    init: torch.Tensor      # [R, NW, C, W] int in [0, n)
    pos: torch.Tensor       # [R, NW, I, C] int in [0, W)
    val: torch.Tensor       # [R, NW, I, C] int in [0, n)
    acc_u: torch.Tensor     # [R, NW, I, C] f32 in [0, 1)
    ex_u: torch.Tensor | None = None  # [R, NW, I, C] f32 in [0, 1)


def ga_draws(cfg: GAConfig, gen: torch.Generator, r: int, nw: int, n: int,
             device) -> GADraws:
    w, p = cfg.window, cfg.population
    c, g = p - p // 2, cfg.generations
    kw = dict(generator=gen, device=device)
    return GADraws(
        init=torch.randint(0, n, (r, nw, p, w), **kw),
        parents=torch.randint(0, p // 2, (r, nw, g, c, 2), **kw),
        cx=torch.randint(1, max(w, 2), (r, nw, g, c), **kw),
        mut_u=torch.rand((r, nw, g, c, w), **kw),
        mut_val=torch.randint(0, n, (r, nw, g, c, w), **kw))


def sa_draws(cfg: SAConfig, gen: torch.Generator, r: int, nw: int, n: int,
             device) -> SADraws:
    w, c, i = cfg.window, cfg.chains, cfg.iters
    kw = dict(generator=gen, device=device)
    return SADraws(
        init=torch.randint(0, n, (r, nw, c, w), **kw),
        pos=torch.randint(0, w, (r, nw, i, c), **kw),
        val=torch.randint(0, n, (r, nw, i, c), **kw),
        acc_u=torch.rand((r, nw, i, c), **kw),
        ex_u=torch.rand((r, nw, i, c), **kw) if cfg.tempering else None)


# ---------------------------------------------------------------------------
# window fitness (the tensor mirror of ga._evaluate)
# ---------------------------------------------------------------------------

def _maxplus_reduce(c: torch.Tensor, d: torch.Tensor):
    """Order-preserving reduction of the affine max-plus maps
    ``g_k(x) = max(x + c_k, d_k)`` along axis -2.

    ``(g2 . g1)`` has ``c = c1 + c2`` and ``d = max(d1 + c2, d2)``, with
    identity ``(0, -inf)``: the window is padded with identities to a
    power of two and folded in pairwise combines, the same tree as the
    JAX package's, so the result is the same to the bit.
    """
    w = c.shape[-2]
    pad = (1 << max(w - 1, 1).bit_length()) - w
    c = torch.nn.functional.pad(c, (0, 0, 0, pad), value=0.0)
    d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=-torch.inf)
    while c.shape[-2] > 1:
        c0, c1 = c[..., 0::2, :], c[..., 1::2, :]
        d0, d1 = d[..., 0::2, :], d[..., 1::2, :]
        c = c0 + c1
        d = torch.maximum(d0 + c1, d1)
    return c[..., 0, :], d[..., 0, :]


class _WindowTables(NamedTuple):
    """What a window's fitness reads from the snapshot state, per route r,
    row w and accelerator j ([R, W, n]): the health-scaled exec time and
    energy (energy 0 on padding rows) and arrival + exec time."""
    et: torch.Tensor
    en: torch.Tensor
    arrival_et: torch.Tensor
    valid: torch.Tensor        # [R, W]
    avail: torch.Tensor        # [R, n]
    t_max: torch.Tensor        # [R]


def _window_tables(spec: PlatformSpec, state: PlatformState,
                   wtasks: TaskArrays) -> _WindowTables:
    # health scale from the snapshot state: throttled cores inflate
    # et/energy by 1/capacity, dead cores by 1/HEALTH_FLOOR — fitness
    # pressure alone drives genes off dead cores (all-healthy divides by
    # exactly 1.0)
    eff = health_capacity(state)[:, None, :]
    et = spec.exec_time.T[wtasks.kind] / eff
    en = torch.where(wtasks.valid[..., None],
                     spec.energy.T[wtasks.kind] / eff, 0.0)
    return _WindowTables(et=et, en=en,
                         arrival_et=wtasks.arrival[..., None] + et,
                         valid=wtasks.valid, avail=state.avail,
                         t_max=state.T.amax(-1))


def _fitness(tab: _WindowTables, a: torch.Tensor) -> torch.Tensor:
    """Fitness of assignments a [R, K, W] (see :func:`window_fitness`).
    Each value is the one the JAX function computes: the same divisions
    and sums of the same operands, picked by the one-hot of ``a``."""
    n = tab.et.shape[-1]
    onehot = ((a[..., None] == torch.arange(n, device=a.device))
              & tab.valid[:, None, :, None])                # [R, K, W, n]
    energy = tab.en[:, None].expand(*a.shape, n).gather(
        -1, a[..., None])[..., 0].sum(-1)
    c = torch.where(onehot, tab.et[:, None], 0.0)
    d = torch.where(onehot, tab.arrival_et[:, None], -torch.inf)
    c_all, d_all = _maxplus_reduce(c, d)                    # [R, K, n]
    finish = torch.maximum(tab.avail[:, None, :] + c_all, d_all)
    # idle accelerators fold in as avail_i, which never exceeds T.max()
    makespan = torch.maximum(tab.t_max[:, None], finish.amax(-1))
    return -(makespan + 0.1 * energy)


def window_fitness(spec: PlatformSpec, state: PlatformState,
                   wtasks: TaskArrays, assignment: torch.Tensor
                   ) -> torch.Tensor:
    """Fitness = -(makespan + 0.1 * energy) of candidate assignments
    simulated from ``state`` — arithmetic-identical to ``ga._evaluate``
    on the NumPy platform (time + energy only).

    ``state`` [R, n] fields, ``wtasks`` [R, W], ``assignment`` [R, ..., W]
    (any candidate axes between); returns [R, ...].  Each accelerator's
    FIFO recurrence ``f_k = max(arrival_k, f_{k-1}) + et_k`` is an affine
    max-plus map, so a window folds in ``log2(W)`` vectorized combines
    (``_maxplus_reduce``).  Invalid (padding) rows are identity maps and
    add no energy.
    """
    r, w = wtasks.arrival.shape
    a = assignment.reshape(r, -1, w).long()
    return _fitness(_window_tables(spec, state, wtasks), a).reshape(
        assignment.shape[:-1])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[r, idx[r, j]] along axis 1 of x [R, K, W] for idx [R, J]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


# ---------------------------------------------------------------------------
# window searches (one window of every route: state [R, n], tasks [R, W])
# ---------------------------------------------------------------------------

def _ga_window(spec: PlatformSpec, cfg: GAConfig, state: PlatformState,
               wtasks: TaskArrays, dr: GADraws) -> torch.Tensor:
    """One GA window search; returns the best assignment [R, W]."""
    r, w = wtasks.arrival.shape
    n_elite = cfg.population // 2
    pos = torch.arange(w, device=wtasks.arrival.device)
    tab = _window_tables(spec, state, wtasks)
    population = dr.init                                     # [R, P, W]
    for g in range(cfg.generations):
        fit = _fitness(tab, population)
        order = torch.argsort(-fit, dim=-1, stable=True)
        elite = _take(population, order[:, :n_elite])
        parents = _take(elite, dr.parents[:, g].reshape(r, -1)) \
            .reshape(r, -1, 2, w)                            # [R, C, 2, W]
        child = torch.where(pos < dr.cx[:, g, :, None],
                            parents[:, :, 0], parents[:, :, 1])
        child = torch.where(dr.mut_u[:, g] < cfg.mutation,
                            dr.mut_val[:, g], child)
        population = torch.cat([elite, child], dim=1)
    fit = _fitness(tab, population)
    return _take(population, fit.argmax(-1)[:, None])[:, 0]


def _ladder(cfg: SAConfig, count: int, device) -> torch.Tensor:
    """``count`` geometric temperatures t_start -> t_end (f32, as the JAX
    package computes them)."""
    frac = torch.arange(count, dtype=torch.float32, device=device) \
        / max(count - 1, 1)
    return cfg.t_start * (cfg.t_end / cfg.t_start) ** frac


def _sa_window(spec: PlatformSpec, cfg: SAConfig, state: PlatformState,
               wtasks: TaskArrays, dr: SADraws) -> torch.Tensor:
    """SA over ``cfg.chains`` chains of every route; best chain wins.
    With ``cfg.tempering`` the chains are parallel-tempering replicas
    (see :class:`SAConfig`)."""
    dev = wtasks.arrival.device
    c, every = cfg.chains, max(cfg.exchange_every, 1)
    tab = _window_tables(spec, state, wtasks)
    cur = dr.init                                            # [R, C, W]
    cur_fit = _fitness(tab, cur)
    best, best_fit = cur, cur_fit
    if cfg.tempering:
        # chain 0 hottest -> chain c-1 coldest, fixed for the whole window
        temps = _ladder(cfg, c, dev).clamp_min(1e-9)
        beta = 1.0 / temps
        idx = torch.arange(c, device=dev)
        pairs = []                 # (left, partner) at exchange parity 0, 1
        for parity in (0, 1):
            left = (idx % 2 == parity) & (idx < c - 1)
            partner = torch.where(left, idx + 1, torch.where(
                torch.roll(left, 1), idx - 1, idx))
            pairs.append((left, partner))
    else:
        temps = _ladder(cfg, cfg.iters, dev).clamp_min(1e-9)
    for i in range(cfg.iters):
        temp = temps if cfg.tempering else temps[i]
        cand = cur.scatter(-1, dr.pos[:, i, :, None], dr.val[:, i, :, None])
        fit = _fitness(tab, cand)
        # exponent clipped at 0: uphill moves are accepted by the first
        # clause, and exp() must not overflow for them
        p_acc = torch.exp(((fit - cur_fit) / temp).clamp_max(0.0))
        accept = (fit > cur_fit) | (dr.acc_u[:, i] < p_acc)
        cur = torch.where(accept[..., None], cand, cur)
        cur_fit = torch.where(accept, fit, cur_fit)
        if cfg.tempering and (i + 1) % every == 0:
            # replica exchange: alternating even/odd adjacent pairs, swap
            # acceptance exp((beta_j - beta_k)(E_j - E_k)) with
            # E = -fitness, one shared coin per pair (the left member's)
            left, partner = pairs[((i + 1) // every) % 2]
            delta = (beta - beta[partner]) * (cur_fit[:, partner] - cur_fit)
            u = dr.ex_u[:, i]
            u_pair = torch.where(left, u, u[:, partner])
            swap = ((u_pair < torch.exp(delta.clamp_max(0.0)))
                    & (partner != idx))
            cur = torch.where(swap[..., None], cur[:, partner], cur)
            cur_fit = torch.where(swap, cur_fit[:, partner], cur_fit)
        improved = cur_fit > best_fit
        best = torch.where(improved[..., None], cur, best)
        best_fit = torch.maximum(best_fit, cur_fit)
    return _take(best, best_fit.argmax(-1)[:, None])[:, 0]


_WINDOW_SEARCHES = {"ga": (_ga_window, GAConfig, ga_draws),
                    "sa": (_sa_window, SAConfig, sa_draws)}


# ---------------------------------------------------------------------------
# route driver: loop over windows, commit through platform_step
# ---------------------------------------------------------------------------

def _route_run(spec: PlatformSpec, cfg, search, tasks: TaskArrays, draws,
               state0=None, health=None):
    r = tasks.arrival.shape[0]
    dev, window = spec.device, cfg.window
    win = window_task_arrays(tasks, window)                  # [R, NW, W]
    state, trace = start_trace(
        platform_init(spec.n, r, dev) if state0 is None else state0,
        health, dev)
    whealth = None if trace is None else window_health(trace, window)
    recs = []
    for w in range(win.arrival.shape[1]):
        wt = TaskArrays(*[f[:, w] for f in win])
        # windowed granularity contract (core.faults): the health row at
        # the window's first task holds for the whole window, so the
        # search's fitness and the committed steps agree
        if whealth is not None:
            state = with_health(state, whealth[:, w])
        best = search(spec, cfg, state, wt, type(draws)(
            *[None if d is None else d[:, w] for d in draws]))
        for j in range(window):
            state, rec = platform_step(spec, state, wt.step(j), best[:, j])
            recs.append(rec)
    return state, stack_records(recs)


def _as_draw(d, device) -> torch.Tensor:
    """An injected draw on ``device``; integer draws as int64 indices."""
    d = torch.as_tensor(d, device=device)
    return d if d.is_floating_point() else d.long()


def make_metaheuristic_fn(spec: PlatformSpec, name: str, cfg=None,
                          batched: bool = False):
    """The windowed search ``name`` ("ga" / "sa"):
    ``fn(seed, tasks, state0=None, health=None, draws=None) ->
    (final_state, records)``.  One route by default (tasks [T], state0
    [n], health [T, n], draws without the route axis); ``batched=True``
    takes a [R, T] batch.  Without ``draws`` the run draws from a
    ``torch.Generator`` on ``spec.device`` seeded with ``seed``."""
    search, cfg_cls, draw_fn = _WINDOW_SEARCHES[name]
    cfg = cfg_cls() if cfg is None else cfg
    dev = spec.device

    def run(seed, tasks, state0=None, health=None, draws=None):
        r, t_len = tasks.arrival.shape
        if draws is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            draws = draw_fn(cfg, gen, r, -(-t_len // cfg.window), spec.n,
                            dev)
        else:
            draws = type(draws)(*[None if d is None else _as_draw(d, dev)
                                  for d in draws])
        return _route_run(spec, cfg, search, tasks, draws, state0, health)

    if batched:
        return run

    def single(seed, tasks, state0=None, health=None, draws=None):
        tasks = TaskArrays(*[f[None] for f in tasks])
        if state0 is not None:
            state0 = type(state0)(*[f[None] for f in state0])
        if health is not None:
            health = torch.as_tensor(health)[None]
        if draws is not None:
            draws = type(draws)(*[None if d is None else
                                  torch.as_tensor(d)[None] for d in draws])
        final, recs = run(seed, tasks, state0, health, draws)
        return route(final, 0), route(recs, 0)

    return single


def make_sharded_metaheuristic_fn(spec: PlatformSpec, name: str, mesh,
                                  cfg=None):
    """The batched search over ``mesh``: ``fn(seed, tasks [R, T],
    health=None, draws=None) -> (final_state, records)`` with every
    route's result on every rank.  Each rank searches its contiguous
    block of routes (R a multiple of the mesh size:
    ``tasks.pad_route_batch``).  The draws are made (or injected) for all
    R routes and each rank takes its block, so the result equals the
    batched path's; window searches are route-local, so the only
    collective is the closing ``all_gather``."""
    from repro_torch import distributed as pdist
    search, cfg_cls, draw_fn = _WINDOW_SEARCHES[name]
    cfg = cfg_cls() if cfg is None else cfg
    dev = spec.device

    def sharded(seed, tasks, health=None, draws=None):
        r, t_len = tasks.arrival.shape
        blk = pdist.local_block(mesh, r, "routes")
        if draws is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            draws = draw_fn(cfg, gen, r, -(-t_len // cfg.window), spec.n,
                            dev)
        draws = type(draws)(*[None if d is None else _as_draw(d, dev)[blk]
                              for d in draws])
        out = _route_run(spec, cfg, search,
                         TaskArrays(*[f[blk] for f in tasks]), draws,
                         health=None if health is None else health[blk])
        return pdist.all_gather(out, mesh)

    return sharded


# ---------------------------------------------------------------------------
# host-side scheduler wrappers (registry names "ga_scan" / "sa_scan")
# ---------------------------------------------------------------------------

class _DeviceMetaheuristic(Scheduler):
    """``Scheduler.schedule`` surface over the tensor search: same summary
    keys, one route.  The NumPy platform supplies the hardware tables only
    and is left untouched (the committed state lives in the summary)."""
    search_name = ""

    def __init__(self, cfg=None, seed: int = 0, device=None):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)

    def schedule(self, platform, tasks) -> dict:
        spec = spec_from_platform(platform, self.device)
        ta = tasks if isinstance(tasks, TaskArrays) else \
            tasks_to_arrays(tasks)
        ta = ta.to(self.device)
        fn = make_metaheuristic_fn(spec, self.search_name, self.cfg)
        t0 = time.perf_counter()
        final, recs = fn(self.seed, ta)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        return package_device_summary(spec, final, recs, dt, ta.num_tasks)


@register
class DeviceGAScheduler(_DeviceMetaheuristic):
    name = "ga_scan"
    search_name = "ga"


@register
class DeviceSAScheduler(_DeviceMetaheuristic):
    name = "sa_scan"
    search_name = "sa"


def metaheuristic_schedule(name: str, platform, tasks, cfg=None,
                           seed: int = 0, device=None) -> dict:
    """Mirror of ``scan_schedule`` for the GA/SA families."""
    cls = {"ga": DeviceGAScheduler, "sa": DeviceSAScheduler}[name]
    return cls(cfg=cfg, seed=seed, device=device).schedule(platform, tasks)
