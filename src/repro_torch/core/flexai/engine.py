"""FlexAI episode engine in PyTorch: greedy placement, and training on
one lane, on a population of lanes, and data-parallel over lanes.

The JAX package runs a route inside one ``lax.scan``; here a route is a
Python loop over its T steps, batched over routes on a leading axis (the
place of ``vmap``).  Everything the loop decides from task validity alone
(the epsilon schedule, replay size, the ``min_replay`` / ``update_every``
/ ``target_sync_every`` cadence) is computed on the host before the loop,
so no step waits for the device to decide whether to update.

* ``make_schedule_fn``: greedy inference (state vector, Q-net, alive-masked
  first-max argmax, ``platform_step``) per step; the params may be shared
  by the routes or carry a lane axis (one net a route).
* ``make_train_fn``: epsilon-greedy act, platform step, dGvalue + dMS
  reward, replay write and, on the cadence, a double-DQN TD update with
  TargNet sync; ``td_kernel=True`` sends the update through the fused CUDA
  kernel (``repro_torch.kernels.dqn_update``).  ``batched=True`` trains a
  population of independent lanes (own nets, ring, counters, route), one
  kernel launch a step for every lane that updates.
* ``make_dp_train_fn``: ONE agent trained data-parallel over a [lanes, T]
  route batch: per-lane gradients (the kernel's grads variant, one launch
  for all lanes), averaged, then one shared Adam step.
* ``make_sharded_{schedule,train}_fn`` and ``make_dp_train_fn(mesh=)``:
  the same over a ``repro_torch.distributed`` mesh, each rank running its
  contiguous block of routes or lanes.
* All but the data-parallel and sharded trainers take an optional
  ``health`` trace ([T, n], or [R, T, n] batched; ``core.faults``),
  installed row by row before each step: dead cores leave the greedy
  argmax and ``platform_step`` charges health-scaled exec and energy.
  Without one, the state's cores are made healthy once before the loop
  (``faults.start_trace``) and no step runs a health op.
* ``ScanFlexAI``: the train / schedule / weights surface of the JAX
  package's class of that name, with its ``lanes``, ``dp`` and ``mesh``.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import distributed as pdist
from repro_torch.core.faults import start_trace
from repro_torch.core.flexai.dqn import (AdamState, DQNParams, adam_apply,
                                         adam_init, dqn_td_update, init_qnet,
                                         load_dqn_npz, qnet_apply,
                                         save_dqn_npz)
from repro_torch.core.flexai.replay import (DeviceReplay, device_replay_add,
                                            device_replay_flat_lanes,
                                            device_replay_init,
                                            device_replay_init_lanes,
                                            device_replay_rows_lanes,
                                            device_replay_sample,
                                            device_replay_sample_lanes,
                                            device_replay_write_lanes)
from repro_torch.core.flexai.reward import reward_from_states
from repro_torch.core.platform import (PlatformSpec, kind_feature_table,
                                       platform_init, platform_step, route,
                                       spec_from_platform, stack_records,
                                       state_vector, summarize, with_health)
from repro_torch.core.tasks import (TaskArrays, pad_task_arrays,
                                    stack_task_arrays, tasks_to_arrays)
from repro_torch.kernels.protocol import resolve_device, synchronize


# ---------------------------------------------------------------------------
# greedy inference
# ---------------------------------------------------------------------------

def make_schedule_fn(spec: PlatformSpec, backlog_scale: float = 1.0,
                     batched: bool = False):
    """The greedy scheduler: ``fn(params, tasks, state0=None, health=None)
    -> (final_state, records)``.  Single route: tasks [T], state [n],
    health [T, n], records [T].  ``batched=True``: tasks [R, T], state
    [R, n] (``state0`` resumes mid-route), health [R, T, n], params shared
    across routes.  A health row is installed before each step's state
    vector, so the exec column and the argmax mask see it."""
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)

    def run(params: DQNParams, tasks: TaskArrays, state0=None,
            health=None):
        r, t_len = tasks.arrival.shape
        state, health = start_trace(
            platform_init(spec.n, r, spec.device) if state0 is None
            else state0, health, spec.device)
        recs = []
        for t in range(t_len):
            task = tasks.step(t)
            if health is not None:
                state = with_health(state, health[:, t])
            sv = state_vector(spec, feat, backlog_scale, state, task)
            q = qnet_apply(params, sv).masked_fill(~state.alive,
                                                   float("-inf"))
            state, rec = platform_step(spec, state, task, q.argmax(-1))
            recs.append(rec)
        return state, stack_records(recs)

    if batched:
        return run

    def single(params, tasks, state0=None, health=None):
        tasks = TaskArrays(*[f[None] for f in tasks])
        if state0 is not None:
            state0 = type(state0)(*[f[None] for f in state0])
        if health is not None:
            health = torch.as_tensor(health)[None]
        final, recs = run(params, tasks, state0, health)
        return route(final, 0), route(recs, 0)

    return single


def _schedule_run_masked(spec: PlatformSpec, backlog_scale: float = 1.0):
    """Greedy batched episode under a fixed ``alive`` accelerator mask
    ([n] or [R, n] bool): dead cores leave the Q argmax, so every
    placement lands on a survivor (the graceful-degradation reroute).
    The mask replaces the state's own; all-alive is the plain greedy
    run.  ``run(params, tasks [R, T], state0=None, alive=None)``."""
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)

    def run(params: DQNParams, tasks: TaskArrays, state0=None, alive=None):
        r, t_len = tasks.arrival.shape
        state = (platform_init(spec.n, r, spec.device) if state0 is None
                 else state0)
        dead = (torch.zeros(spec.n, dtype=torch.bool, device=spec.device)
                if alive is None else
                ~torch.as_tensor(alive, device=spec.device))
        recs = []
        for t in range(t_len):
            task = tasks.step(t)
            sv = state_vector(spec, feat, backlog_scale, state, task)
            q = qnet_apply(params, sv).masked_fill(dead, float("-inf"))
            state, rec = platform_step(spec, state, task, q.argmax(-1))
            recs.append(rec)
        return state, stack_records(recs)

    return run


def _shard_routes(run, mesh, split_last: bool):
    """``run(params, tasks [R, T], state0=None, last=None)`` over
    ``mesh``: each rank runs its contiguous block of the routes (R a
    multiple of the mesh size: ``tasks.pad_route_batch``), resuming from
    the same block of ``state0`` [R, ...] when one is given; ``last`` is
    split with the routes (a health trace) or replicated (an alive mask).
    Routes are independent, so the only collective is the closing
    ``all_gather``."""
    def sharded(params, tasks: TaskArrays, state0=None, last=None):
        blk = pdist.local_block(mesh, tasks.arrival.shape[0], "routes")
        local = TaskArrays(*[f[blk] for f in tasks])
        out = run(params, local,
                  None if state0 is None else type(state0)(
                      *[f[blk] for f in state0]),
                  last[blk] if split_last and last is not None else last)
        return pdist.all_gather(out, mesh)

    return sharded


def make_sharded_schedule_fn(spec: PlatformSpec, mesh,
                             backlog_scale: float = 1.0):
    """The greedy scheduler over ``mesh``: ``fn(params, tasks [R, T],
    state0=None, health=None) -> (final_state, records)`` with every
    route's result on every rank; the health trace [R, T, n] is split
    with the routes."""
    return _shard_routes(make_schedule_fn(spec, backlog_scale,
                                          batched=True), mesh, True)


def make_sharded_masked_fn(spec: PlatformSpec, mesh,
                           backlog_scale: float = 1.0):
    """:func:`_schedule_run_masked` over ``mesh``: ``fn(params, tasks
    [R, T], state0=None, alive=None)``, the [n] alive mask replicated on
    every rank and the routes and states split (the JAX package's
    ``in_specs=(P(), P(ax), P(ax), P())``)."""
    return _shard_routes(_schedule_run_masked(spec, backlog_scale), mesh,
                         False)


# ---------------------------------------------------------------------------
# single-lane training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """What a training episode carries from one episode to the next:
    EvalNet/TargNet/Adam, the replay ring, the epsilon / TargNet counters
    (host integers), and the generator of the default draws.

    Population lanes stack every field but the generator: params,
    moments and rings [L, ...], Adam step [L], counters NumPy [L].  The
    data-parallel trainer's state is one agent (unbatched params,
    counters and step) with a stack of rings, one a lane."""
    eval_p: DQNParams
    targ_p: DQNParams
    opt: AdamState
    replay: DeviceReplay
    env_steps: "int | np.ndarray"
    updates: "int | np.ndarray"
    generator: torch.Generator


class Draws(NamedTuple):
    """The random numbers of one episode, per step t: the exploration
    uniform, the random action, and the [B] replay rows of the TD batch.
    The JAX trainer draws these from ``split(key, 4)`` at every step; a
    test regenerates them from its key chain and injects them, so the two
    trainers can be held to the same trajectory.  With lanes (population
    or data-parallel) each field gains a leading [L] axis, lane l's draws
    from lane l's keys."""
    explore_u: torch.Tensor   # [(L,) T] f32 in [0, 1)
    action: torch.Tensor      # [(L,) T] int in [0, n_actions)
    sample_idx: torch.Tensor  # [(L,) T, B] int in [0, replay size at t)


def train_init(state_dim: int, n_actions: int, replay_capacity: int,
               seed: int = 0, device=None, lanes: int | None = None
               ) -> TrainState:
    """A fresh agent on ``device`` (default: the card, see
    :func:`repro_torch.kernels.protocol.resolve_device`).  With ``lanes``
    a population: one net, ring and counter set a lane, the nets drawn
    one after another from the generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if lanes is None:
        params = init_qnet(state_dim, n_actions, gen, device)
        return TrainState(
            eval_p=params, targ_p=params, opt=adam_init(params),
            replay=device_replay_init(replay_capacity, state_dim, device),
            env_steps=0, updates=0, generator=gen)
    nets = [init_qnet(state_dim, n_actions, gen, device)
            for _ in range(lanes)]
    params = DQNParams(*[torch.stack(w) for w in zip(*nets)])
    return TrainState(
        eval_p=params, targ_p=params, opt=adam_init(params),
        replay=device_replay_init_lanes(lanes, replay_capacity, state_dim,
                                        device),
        env_steps=np.zeros(lanes, np.int64),
        updates=np.zeros(lanes, np.int64), generator=gen)


class _Cadence(NamedTuple):
    eps: np.ndarray        # [T] f32 epsilon at each step
    size: np.ndarray       # [T] replay size after the step's write
    do_update: np.ndarray  # [T] bool
    sync: np.ndarray       # [T] bool TargNet sync after the update
    env_steps: int
    updates: int


def _epsilon(cfg, env: int) -> np.float32:
    """The exploration rate after ``env`` env steps, in f32 as the JAX
    trainer computes it."""
    decay = np.float32(max(cfg.eps_decay_steps, 1))
    frac = min(np.float32(1.0), np.float32(env) / decay)
    return (np.float32(cfg.eps_start)
            + np.float32(cfg.eps_end - cfg.eps_start) * frac)


def _ring_sizes(valid: np.ndarray, size0, cap: int) -> np.ndarray:
    """Replay fill after each step's write, per lane: ``valid`` [..., T],
    ``size0`` the fill before the episode."""
    return np.minimum(np.asarray(size0)[..., None]
                      + np.cumsum(valid, axis=-1), cap)


def _cadence(cfg, valid: np.ndarray, ts: TrainState) -> _Cadence:
    """The host-side counters of one episode, as plain functions of
    ``valid``.  Epsilon is computed in f32 as the JAX trainer does."""
    return _lane_cadence(cfg, valid, ts.env_steps, ts.replay.size,
                         ts.updates, ts.replay.capacity)


def _lane_cadence(cfg, valid: np.ndarray, env: int, size: int, upd: int,
                  cap: int) -> _Cadence:
    """:func:`_cadence` of one lane, from its counters ``env`` /
    ``size`` / ``upd`` and ring capacity ``cap``."""
    t_len = len(valid)
    eps = np.empty(t_len, np.float32)
    do_update = np.zeros(t_len, bool)
    sync = np.zeros(t_len, bool)
    sizes = _ring_sizes(valid, size, cap)
    for t in range(t_len):
        eps[t] = _epsilon(cfg, env)
        if valid[t]:
            env += 1
        if (valid[t] and sizes[t] >= cfg.min_replay
                and env % cfg.update_every == 0):
            do_update[t] = True
            upd += 1
            sync[t] = upd % cfg.target_sync_every == 0
    return _Cadence(eps, sizes, do_update, sync, env, upd)


def _default_draws(gen: torch.Generator, size: np.ndarray, n_actions: int,
                   batch_size: int, device) -> Draws:
    """One episode of draws from ``gen``, on the device, in three calls;
    ``size`` [(L,) T] is the replay fill at each step (lane)."""
    shape = size.shape
    u = torch.rand(shape, generator=gen, device=device)
    act = torch.randint(0, n_actions, shape, generator=gen, device=device)
    smp = torch.rand(*shape, batch_size, generator=gen, device=device,
                     dtype=torch.float64)
    n = torch.as_tensor(np.maximum(size, 1), device=device)[..., None]
    idx = torch.minimum((smp * n).long(), n - 1)
    return Draws(u, act, idx)


class _LaneEpisode(NamedTuple):
    """What a lane-batched episode indexes each step, made on the host and
    moved to the device once, so no step copies from the host."""
    nxt: TaskArrays          # [L, T] the task of each step's next state
    done: torch.Tensor       # [L, T] f32, the last valid task
    rows: torch.Tensor       # [L, T] replay write rows (flattened stack)
    replay: DeviceReplay     # the ring with its counters after the episode


def _lane_episode(tasks: TaskArrays, valid: np.ndarray,
                  replay: DeviceReplay) -> _LaneEpisode:
    """Each lane's next observation reads the *next valid* task (the last
    valid task pairs with itself and is ``done``)."""
    dev = tasks.arrival.device
    t_len = valid.shape[-1]
    nxt = np.broadcast_to(np.arange(t_len), valid.shape).copy()
    nxt[:, :-1] += valid[:, 1:]
    nxt = torch.as_tensor(nxt, device=dev)
    done = np.arange(t_len)[None] == valid.sum(-1, keepdims=True) - 1
    rows, replay = device_replay_rows_lanes(replay, valid)
    return _LaneEpisode(
        TaskArrays(*[f.gather(1, nxt) for f in tasks]),
        torch.as_tensor(done, dtype=torch.float32, device=dev),
        torch.as_tensor(rows, device=dev), replay)


def make_train_fn(spec: PlatformSpec, cfg, batched: bool = False,
                  td_kernel: bool = False):
    """The training episode for a ``FlexAIConfig``-shaped ``cfg``:
    ``fn(train_state, tasks, draws=None, health=None) -> (train_state,
    platform_state, records, losses [T], update_mask [T])`` on one [T]
    route.  Without ``draws`` the episode draws from
    ``train_state.generator``.

    A ``health`` trace ([T, n]) makes this the degradation trainer: row
    t lands on the platform before step t commits, so the greedy arm is
    masked to alive cores and ``platform_step`` charges health-scaled
    exec and energy; the observation sees the row one step later (the
    next state vector is built from the stepped state).  Exploration
    stays uniform over all cores.

    ``batched=True`` trains population lanes: the state from
    ``train_init(..., lanes=L)``, tasks [L, T], draws and health with a
    leading [L] axis, outputs [L, ...] (see :func:`_train_run_lanes`)."""
    if batched:
        return _train_run_lanes(spec, cfg, td_kernel)
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)
    n_actions = spec.n
    if td_kernel:
        from repro_torch.kernels.dqn_update import dqn_td_update_fused
        td_update = dqn_td_update_fused
    else:
        td_update = dqn_td_update

    def run(ts: TrainState, tasks: TaskArrays, draws: Draws | None = None,
            health=None):
        dev = spec.device
        tasks = TaskArrays(*[f[None].to(dev) for f in tasks])
        valid = tasks.valid[0].cpu().numpy()
        t_len = len(valid)
        # S_{i+1} pairs with the *next valid* task; the last valid task
        # pairs with itself and carries done=True
        nxt_idx = np.arange(t_len)
        nxt_idx[:-1] += valid[1:]
        nxt = TaskArrays(*[f[:, torch.as_tensor(nxt_idx, device=dev)]
                           for f in tasks])
        done = np.arange(t_len) == valid.sum() - 1
        cad = _cadence(cfg, valid, ts)
        if draws is None:
            draws = _default_draws(ts.generator, cad.size, n_actions,
                                   cfg.batch_size, dev)
        else:
            draws = Draws(*[d.to(dev) for d in draws])
        eval_p, targ_p, opt, replay = ts.eval_p, ts.targ_p, ts.opt, ts.replay
        plat, health = start_trace(platform_init(spec.n, 1, dev), health,
                                   dev)
        if health is not None:
            health = health[:, None]
        sv = state_vector(spec, feat, cfg.backlog_scale, plat, tasks.step(0))
        losses = torch.zeros(t_len, dtype=torch.float32, device=dev)
        recs = []
        for t in range(t_len):
            if health is not None:
                plat = with_health(plat, health[t])
            greedy = qnet_apply(eval_p, sv).masked_fill(
                ~plat.alive, float("-inf")).argmax(-1)
            action = torch.where(draws.explore_u[t] < float(cad.eps[t]),
                                 draws.action[t], greedy)
            plat2, rec = platform_step(spec, plat, tasks.step(t), action)
            reward = reward_from_states(spec, plat, plat2)
            nsv = state_vector(spec, feat, cfg.backlog_scale, plat2,
                               nxt.step(t))
            replay = device_replay_add(replay, sv[0], action[0], reward[0],
                                       nsv[0], float(done[t]),
                                       write=bool(valid[t]))
            if cad.do_update[t]:
                batch = device_replay_sample(replay, draws.sample_idx[t])
                new_p, opt, losses[t] = td_update(
                    eval_p, targ_p, opt, batch, gamma=cfg.gamma, lr=cfg.lr)
                if cad.sync[t]:
                    targ_p = new_p
                eval_p = new_p
            recs.append(rec)
            plat, sv = plat2, nsv
        ts = TrainState(eval_p, targ_p, opt, replay, cad.env_steps,
                        cad.updates, ts.generator)
        return (ts, route(plat, 0), route(stack_records(recs), 0), losses,
                torch.from_numpy(cad.do_update))

    return run


# ---------------------------------------------------------------------------
# population lanes
# ---------------------------------------------------------------------------

def _lane_select(mask: torch.Tensor, new, old):
    """Per lane, ``new`` where ``mask`` ([L] bool) and ``old`` elsewhere,
    leaf by leaf (the select that ``vmap`` makes of a per-lane
    ``lax.cond``)."""
    def pick(n, o):
        return torch.where(mask.view(-1, *[1] * (n.dim() - 1)), n, o)
    return type(new)(*[pick(n, o) for n, o in zip(new, old)])


def _lane_step(spec: PlatformSpec, feat, cfg, params, plat, sv,
               tasks: TaskArrays, ep: _LaneEpisode, replay: DeviceReplay,
               explore: torch.Tensor, draws: Draws, t: int):
    """Step ``t`` of every lane, the body both lane trainers share: act
    epsilon-greedy (the greedy arm masked to alive cores), step the
    platforms, reward, next state vector, ring write.  ``params`` are
    shared (DP) or one net a lane (population).  Returns ``(platform
    state after the step, next state vector, record)``."""
    greedy = qnet_apply(params, sv).masked_fill(
        ~plat.alive, float("-inf")).argmax(-1)
    action = torch.where(explore[:, t], draws.action[:, t], greedy)
    plat2, rec = platform_step(spec, plat, tasks.step(t), action)
    reward = reward_from_states(spec, plat, plat2)
    nsv = state_vector(spec, feat, cfg.backlog_scale, plat2, ep.nxt.step(t))
    device_replay_write_lanes(replay, ep.rows[:, t], sv, action, reward, nsv,
                              ep.done[:, t])
    return plat2, nsv, rec


def _lanes_of(x, blk):
    """Lanes ``blk`` of a population TrainState-like tuple (tensors and
    NumPy arrays sliced on their leading axis)."""
    if isinstance(x, tuple):
        return type(x)(*[_lanes_of(f, blk) for f in x])
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x[blk]
    return x


def _train_run_lanes(spec: PlatformSpec, cfg, td_kernel: bool = False):
    """Population training: L independent lanes (own nets, Adam, ring,
    counters and route) stepping together, the JAX ``make_train_fn(...,
    batched=True)`` (``jax.vmap`` of the single-lane episode).

    Every lane steps every step; the cadence is each lane's own, on the
    host.  On a step where any lane updates, one TD update runs for all
    lanes (with ``td_kernel`` one launch of the Adam-folded kernel), and
    the lanes whose cadence says no keep their params, moments and step
    (``torch.where`` on the lane axis), as ``vmap`` turns the JAX
    per-lane ``lax.cond`` into a select."""
    from repro_torch.kernels.dqn_update import (dqn_td_update_lanes,
                                                dqn_td_update_lanes_ref)
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)
    n_actions = spec.n
    td_update = dqn_td_update_lanes if td_kernel else dqn_td_update_lanes_ref

    def run(ts: TrainState, tasks: TaskArrays, draws: Draws | None = None,
            health=None):
        dev = spec.device
        tasks = tasks.to(dev)
        valid = tasks.valid.cpu().numpy()
        lanes, t_len = valid.shape
        ep = _lane_episode(tasks, valid, ts.replay)
        cads = [_lane_cadence(cfg, valid[i], int(ts.env_steps[i]),
                              int(ts.replay.size[i]), int(ts.updates[i]),
                              ts.replay.capacity) for i in range(lanes)]
        eps = np.stack([c.eps for c in cads])
        do_update = np.stack([c.do_update for c in cads])
        sync = np.stack([c.sync for c in cads])
        if draws is None:
            draws = _default_draws(ts.generator,
                                   np.stack([c.size for c in cads]),
                                   n_actions, cfg.batch_size, dev)
        else:
            draws = Draws(*[d.to(dev) for d in draws])
        explore = draws.explore_u < torch.as_tensor(eps, device=dev)
        sample = device_replay_flat_lanes(ts.replay, draws.sample_idx)
        upd_dev = torch.as_tensor(do_update, device=dev)
        sync_dev = torch.as_tensor(sync, device=dev)
        eval_p, targ_p, opt, replay = ts.eval_p, ts.targ_p, ts.opt, ts.replay
        plat, health = start_trace(platform_init(spec.n, lanes, dev),
                                   health, dev)
        sv = state_vector(spec, feat, cfg.backlog_scale, plat, tasks.step(0))
        losses = torch.zeros(lanes, t_len, dtype=torch.float32, device=dev)
        recs = []
        for t in range(t_len):
            if health is not None:
                plat = with_health(plat, health[:, t])
            plat, sv, rec = _lane_step(spec, feat, cfg, eval_p, plat, sv,
                                       tasks, ep, replay, explore, draws, t)
            upd = do_update[:, t]
            if upd.any():
                batch = device_replay_sample_lanes(replay, sample[:, t])
                new_p, new_opt, loss = td_update(
                    eval_p, targ_p, opt, batch, gamma=cfg.gamma, lr=cfg.lr)
                if upd.all():
                    eval_p, opt, losses[:, t] = new_p, new_opt, loss
                else:
                    m = upd_dev[:, t]
                    eval_p = _lane_select(m, new_p, eval_p)
                    opt = AdamState(torch.where(m, new_opt.step, opt.step),
                                    _lane_select(m, new_opt.mu, opt.mu),
                                    _lane_select(m, new_opt.nu, opt.nu))
                    losses[:, t] = torch.where(m, loss, 0.0)
                if sync[:, t].any():
                    targ_p = _lane_select(sync_dev[:, t], eval_p, targ_p)
            recs.append(rec)
        ts = TrainState(eval_p, targ_p, opt, ep.replay,
                        np.array([c.env_steps for c in cads]),
                        np.array([c.updates for c in cads]), ts.generator)
        return (ts, plat, stack_records(recs), losses,
                torch.from_numpy(do_update))

    return run


def make_sharded_train_fn(spec: PlatformSpec, cfg, mesh,
                          td_kernel: bool = False):
    """Population training over ``mesh``: ``fn(train_state, tasks [L, T],
    draws=None) -> (train_state, platform_state, records, losses,
    update_mask)``, all with every lane on every rank.  Each rank trains
    its contiguous block of lanes; lanes never communicate, so the only
    collectives are the closing gathers.  L must be a multiple of the
    mesh size.  Default draws are drawn for all L lanes on every rank
    (one generator state everywhere) and each rank takes its block, so
    the result equals the unsharded population's."""
    run = _train_run_lanes(spec, cfg, td_kernel)

    def sharded(ts: TrainState, tasks: TaskArrays, draws: Draws | None = None,
                health=None):
        if health is not None:
            raise ValueError("the sharded trainer is clean-only: "
                             "fault-trace training runs on the "
                             "single-host population trainer")
        lanes = tasks.arrival.shape[0]
        blk = pdist.local_block(mesh, lanes)
        if draws is None:
            valid = tasks.valid.cpu().numpy()
            size = _ring_sizes(valid, ts.replay.size, ts.replay.capacity)
            draws = _default_draws(ts.generator, size, spec.n,
                                   cfg.batch_size, spec.device)
        local = _lanes_of(ts._replace(generator=None), blk)
        out = run(local._replace(generator=ts.generator),
                  TaskArrays(*[f[blk] for f in tasks]),
                  Draws(*[d[blk] for d in draws]))
        gathered = pdist.all_gather(
            (out[0]._replace(generator=None),) + out[1:], mesh)
        return (gathered[0]._replace(generator=ts.generator),) \
            + tuple(gathered[1:])

    return sharded


# ---------------------------------------------------------------------------
# data-parallel training (one synchronized agent over route lanes)
# ---------------------------------------------------------------------------

def dp_train_init(state_dim: int, n_actions: int, replay_capacity: int,
                  lanes: int, seed: int = 0, device=None) -> TrainState:
    """State of the data-parallel trainer: ONE shared agent (nets, Adam,
    counters and generator as :func:`train_init`) plus a stack of
    ``lanes`` replay rings, one a route lane, so each lane's TD batch
    samples its own trajectory."""
    ts = train_init(state_dim, n_actions, replay_capacity, seed, device)
    return ts._replace(replay=device_replay_init_lanes(
        lanes, replay_capacity, state_dim, ts.eval_p.w1.device))


class _DPCadence(NamedTuple):
    eps: np.ndarray        # [T] f32
    size: np.ndarray       # [L_local, T] ring fill after each step
    do_update: np.ndarray  # [T] bool
    sync: np.ndarray       # [T] bool
    env_steps: int
    updates: int


def _dp_cadence(cfg, valid: np.ndarray, ts: TrainState, mesh,
                axis: str | None = None) -> _DPCadence:
    """The shared agent's counters from this rank's lanes' ``valid``
    [L_local, T].  An update happens when ``env_steps // update_every``
    crosses a boundary, ``env_steps`` advancing by the number of valid
    lanes over the whole mesh (an exact-multiple test would alias: 4
    lanes at ``update_every`` 3 land on a multiple every third step),
    and only once every ring over the mesh holds ``min_replay``.  With a
    mesh the per-step valid counts and ring fills are exchanged once,
    here, before the loop, over ``axis`` (default: the route axis): they
    are all that the JAX trainer's per-step ``psum`` carries."""
    sizes = _ring_sizes(valid, ts.replay.size, ts.replay.capacity)
    count = torch.as_tensor(valid.sum(0), dtype=torch.int64)
    fill = torch.as_tensor(sizes.min(0), dtype=torch.int64)
    if mesh is not None:
        dev = ts.eval_p.w1.device
        count = pdist.psum(count.to(dev), mesh, axis).cpu()
        fill = pdist.pmin(fill.to(dev), mesh, axis).cpu()
    count, fill = count.numpy(), fill.numpy()
    t_len = valid.shape[1]
    eps = np.empty(t_len, np.float32)
    do_update = np.zeros(t_len, bool)
    sync = np.zeros(t_len, bool)
    env, upd = ts.env_steps, ts.updates
    for t in range(t_len):
        eps[t] = _epsilon(cfg, env)
        env2 = env + int(count[t])
        if env2 // cfg.update_every > env // cfg.update_every \
                and fill[t] >= cfg.min_replay:
            do_update[t] = True
            upd += 1
            sync[t] = upd % cfg.target_sync_every == 0
        env = env2
    return _DPCadence(eps, sizes, do_update, sync, env, upd)


def _flatten(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten(flat: torch.Tensor, like):
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def make_dp_train_fn(spec: PlatformSpec, cfg, lanes: int, mesh=None,
                     td_kernel: bool = False):
    """The data-parallel trainer: ``fn(train_state, tasks [lanes, T],
    draws=None) -> (train_state, platform_states [lanes], records
    [lanes, T], losses [T], update_mask [T])`` with ``train_state`` from
    :func:`dp_train_init`.

    Every lane advances ONE agent.  Acting, platform steps and replay
    writes are per lane; on an update each lane samples a TD batch from
    its own ring, the per-lane clipped gradients (with ``td_kernel`` the
    kernel's grads variant, one launch for all lanes, the nets read with
    lane stride 0) are averaged, and one shared Adam step follows.  The
    epsilon schedule, cadence and TargNet sync run on global counters
    (:func:`_dp_cadence`).  Lane 0 takes the step's draws raw, as the
    single-lane trainer does, so one lane on the same route walks its
    trajectory.

    With ``mesh`` the lanes split over the mesh (``lanes`` a multiple of
    its size), each rank running its contiguous block; the gradient
    average is an all-reduce across ranks, and the rings, platform
    states and records come back whole to every rank.  The gradient
    all-reduce fires on update steps only: every rank holds the same
    host-side cadence, so all ranks enter it together (the JAX package's
    ``chunk_collectives=True`` layout; its every-step layout is not
    ported)."""
    if mesh is not None and (lanes < 1 or lanes % pdist.mesh_size(mesh)):
        raise ValueError(f"lanes={lanes} must be a positive multiple of "
                         f"the mesh size {pdist.mesh_size(mesh)}")
    from repro_torch.kernels.dqn_update import (dqn_td_grads_lanes,
                                                dqn_td_grads_lanes_ref)
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)
    n_actions = spec.n
    td_grads = dqn_td_grads_lanes if td_kernel else dqn_td_grads_lanes_ref

    def pmean(x):
        return x if mesh is None else pdist.pmean(x, mesh)

    def run(ts: TrainState, tasks: TaskArrays, draws: Draws | None = None,
            health=None):
        if health is not None:
            raise ValueError("the data-parallel trainer is clean-only: "
                             "fault-trace training runs on the "
                             "single-host population trainer")
        dev = spec.device
        if tasks.arrival.shape[0] != lanes:
            raise ValueError(f"expected a [{lanes}, T] route batch, got "
                             f"{tuple(tasks.arrival.shape)}")
        blk = (slice(0, lanes) if mesh is None
               else pdist.local_block(mesh, lanes))
        if draws is None:
            valid_all = tasks.valid.cpu().numpy()
            draws = _default_draws(
                ts.generator, _ring_sizes(valid_all, ts.replay.size,
                                          ts.replay.capacity),
                n_actions, cfg.batch_size, dev)
        draws = Draws(*[d[blk].to(dev) for d in draws])
        tasks = TaskArrays(*[f[blk].to(dev) for f in tasks])
        replay = _lanes_of(ts.replay, blk)
        valid = tasks.valid.cpu().numpy()
        t_len = valid.shape[1]
        ep = _lane_episode(tasks, valid, replay)
        cad = _dp_cadence(cfg, valid, ts._replace(replay=replay), mesh)
        explore = draws.explore_u < torch.as_tensor(cad.eps, device=dev)
        sample = device_replay_flat_lanes(replay, draws.sample_idx)
        eval_p, targ_p, opt = ts.eval_p, ts.targ_p, ts.opt
        plat = platform_init(spec.n, valid.shape[0], dev)
        sv = state_vector(spec, feat, cfg.backlog_scale, plat, tasks.step(0))
        losses = torch.zeros(t_len, dtype=torch.float32, device=dev)
        recs = []
        for t in range(t_len):
            plat, sv, rec = _lane_step(spec, feat, cfg, eval_p, plat, sv,
                                       tasks, ep, replay, explore, draws, t)
            if cad.do_update[t]:
                batch = device_replay_sample_lanes(replay, sample[:, t])
                lane_loss, grads = td_grads(eval_p, targ_p, batch,
                                            gamma=cfg.gamma)
                flat = pmean(_flatten([lane_loss.mean()[None],
                                       *[g.mean(0) for g in grads]]))
                loss, *g = _unflatten(flat, [lane_loss[:1], *eval_p])
                eval_p, opt = adam_apply(eval_p, opt, DQNParams(*g),
                                         lr=cfg.lr)
                losses[t] = loss[0]
            if cad.sync[t]:
                targ_p = eval_p
            recs.append(rec)
        recs, replay = stack_records(recs), ep.replay
        if mesh is not None:
            replay, plat, recs = pdist.all_gather((replay, plat, recs), mesh)
        ts = TrainState(eval_p, targ_p, opt, replay, cad.env_steps,
                        cad.updates, ts.generator)
        return ts, plat, recs, losses, torch.from_numpy(cad.do_update)

    return run


# ---------------------------------------------------------------------------
# host-side wrapper
# ---------------------------------------------------------------------------

class ScanFlexAI:
    """FlexAI trained and run by the step-loop engine.

    Runs on ``device`` (default: the GPU, see
    :func:`repro_torch.kernels.protocol.default_device`).  Two multi-lane
    training modes, as the JAX package's class:

    * ``dp=False`` (default): ``lanes`` independent population agents,
      one a lane; with ``mesh`` (``repro_torch.distributed.make_mesh``)
      the lanes split over the mesh.
    * ``dp=True``: ONE agent trained data-parallel over a ``lanes``-route
      batch (per-lane gradients averaged, with ``mesh`` across ranks too).

    ``td_kernel`` routes every TD update through the fused CUDA kernel:
    the single-lane trainer through its single-lane launch, population
    lanes through the Adam-folded lane launch, the DP trainer through the
    grads variant's lane launch ahead of its average and shared Adam
    step.  On the CPU the same entry points run the plain version.
    """

    def __init__(self, platform, cfg, lanes: int = 1, mesh=None,
                 dp: bool = False, td_kernel: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec_from_platform(platform, self.device)
        self.n_actions = platform.n
        self.state_dim = 3 + 5 * platform.n
        self.lanes = lanes
        self.mesh = mesh
        self.dp = dp
        self.td_kernel = td_kernel
        args = (self.state_dim, self.n_actions, cfg.replay_capacity)
        if dp:
            self.ts = dp_train_init(*args, lanes, seed=cfg.seed,
                                    device=self.device)
            self._train_fn = make_dp_train_fn(self.spec, cfg, lanes,
                                              mesh=mesh, td_kernel=td_kernel)
        else:
            self.ts = train_init(*args, seed=cfg.seed, device=self.device,
                                 lanes=None if lanes == 1 else lanes)
            if mesh is not None:
                # a single lane keeps an unstacked state and has nothing
                # to split
                if lanes < 2 or lanes % pdist.mesh_size(mesh):
                    raise ValueError(
                        f"lanes={lanes} must be >= 2 and a multiple of the "
                        f"mesh size {pdist.mesh_size(mesh)} (omit mesh for "
                        f"single-lane)")
                self._train_fn = make_sharded_train_fn(self.spec, cfg, mesh,
                                                       td_kernel=td_kernel)
            else:
                self._train_fn = make_train_fn(self.spec, cfg,
                                               batched=lanes > 1,
                                               td_kernel=td_kernel)
        self._sched_fn = make_schedule_fn(self.spec, cfg.backlog_scale)
        self._lanes_fn = make_schedule_fn(self.spec, cfg.backlog_scale,
                                          batched=True)
        self.losses: list[float] = []
        self.best_eval_stm: float | None = None
        # model-selection state lives on the instance, so a run resumed
        # mid-way keeps its best-so-far candidate
        self._best_stm: float = -1.0
        self._best_params: DQNParams | None = None

    @property
    def _population(self) -> bool:
        return not self.dp and self.lanes > 1

    @staticmethod
    def _as_arrays(tasks) -> TaskArrays:
        return tasks if isinstance(tasks, TaskArrays) else \
            tasks_to_arrays(tasks)

    def _lane_summaries(self, plat, recs) -> list:
        plat = type(plat)(*[f.cpu() for f in plat])
        recs = type(recs)(*[f.cpu() for f in recs])
        return [summarize(self.spec, route(plat, i), route(recs, i))
                for i in range(recs.action.shape[0])]

    def train_episode(self, tasks, draws: Draws | None = None,
                      health=None) -> dict:
        """One training episode: on one route (single lane), or one route
        a lane (``tasks`` a list of routes or stacked [lanes, T]
        ``TaskArrays``).  ``health`` ([T, n], or [lanes, T, n] for
        population lanes) trains under a fault trace (the degradation
        trainer); the DP and sharded trainers are clean-only.  Every
        summary carries ``update_steps``: the episode's steps with a TD
        update (for population lanes, with an update in any lane; each
        such step is one launch with ``td_kernel``)."""
        if health is not None and (self.dp or self.mesh is not None):
            raise ValueError(
                "fault-trace training is supported on the single-host "
                "population trainer only (not dp/mesh)")
        if self.lanes > 1:
            ta = tasks if isinstance(tasks, TaskArrays) else \
                stack_task_arrays([self._as_arrays(q) for q in tasks])
        else:
            ta = self._as_arrays(tasks)
            if self.dp:   # the DP trainer always takes a [lanes, T] batch
                ta = TaskArrays(*[f[None] for f in ta])
        self.ts, plat, recs, losses, upd = self._train_fn(
            self.ts, ta, draws, health)
        losses, upd = losses.cpu(), upd.bool()
        self.losses.extend(losses[upd].tolist())
        steps = int(upd.reshape(-1, upd.shape[-1]).any(0).sum())
        if self.dp:
            summ = self._lane_summaries(plat, recs)
            mean_loss = float(losses[upd].mean()) if upd.any() else None
            if self.lanes == 1:
                return {**summ[0], "mean_loss": mean_loss,
                        "update_steps": steps}
            return {"lanes": summ, "mean_loss": mean_loss,
                    "update_steps": steps}
        if self.lanes > 1:
            summ = self._lane_summaries(plat, recs)
            for i, lane in enumerate(summ):
                m = upd[i]
                lane["mean_loss"] = (float(losses[i][m].mean())
                                     if m.any() else None)
            return {"lanes": summ, "update_steps": steps}
        s = summarize(self.spec, plat, recs)
        s["mean_loss"] = float(losses[upd].mean()) if upd.any() else None
        s["update_steps"] = steps
        return s

    def train(self, queues: list, episodes: int, eval_queue=None,
              eval_every: int = 5, on_episode=None,
              start_episode: int = 0) -> list:
        """Cycle the queue pool for ``episodes`` episodes; with more than
        one lane (population or DP) each episode takes the next ``lanes``
        routes round-robin, one a lane.  With ``eval_queue``, every
        ``eval_every`` episodes the greedy policy of each candidate (the
        agent, or each population lane) is scored on it and the best
        EvalNet weights are restored into every lane at the end (model
        selection).  ``on_episode(ep, trainer)`` fires after each
        episode; ``start_episode`` resumes mid-run (route cycling and
        the eval cadence follow the global episode number)."""
        routes = [self._as_arrays(q) for q in queues]
        if self.lanes > 1 or self.dp:
            # one shared length for every lane batch.  Single-lane pools
            # stay unpadded: padding rows are training no-ops but still
            # consume per-step draws, which would shift the exploration
            # stream of every later episode
            t_max = max(r.num_tasks for r in routes)
            routes = [pad_task_arrays(r, t_max) for r in routes]
        ta_eval = (self._as_arrays(eval_queue) if eval_queue is not None
                   else None)
        history = []
        if start_episode == 0:
            self._best_stm, self._best_params = -1.0, None
        per_lane = 1 if (self.lanes == 1 and not self.dp) else self.lanes
        for ep in range(start_episode, episodes):
            if per_lane == 1:
                history.append(self.train_episode(routes[ep % len(routes)]))
            else:
                history.append(self.train_episode(
                    [routes[(ep * per_lane + i) % len(routes)]
                     for i in range(per_lane)]))
            if ta_eval is not None and (ep + 1) % eval_every == 0:
                stms = self._eval_stms(ta_eval)
                history[-1]["eval_stm"] = stms[0] if len(stms) == 1 else stms
                lane = int(np.argmax(stms))
                if stms[lane] > self._best_stm:
                    self._best_stm = stms[lane]
                    self._best_params = self.eval_params(lane)
            if on_episode is not None:
                on_episode(ep, self)
        if self._best_params is not None:
            self.set_params(self._best_params)
            self.best_eval_stm = self._best_stm
        return history

    def _eval_stms(self, ta_eval: TaskArrays) -> list[float]:
        """Greedy STM rate on the held-out queue, per candidate: one entry
        for the shared agent (single lane, DP), one a lane for population
        training (each lane's net on the same queue, one batched run)."""
        if not self._population:
            return [self.schedule(ta_eval)["stm_rate"]]
        batch = TaskArrays(*[f[None].expand(self.lanes, -1)
                             for f in ta_eval.to(self.device)])
        final, recs = self._lanes_fn(self.ts.eval_p, batch)
        return [s["stm_rate"] for s in self._lane_summaries(final, recs)]

    def eval_params(self, lane: int = 0) -> DQNParams:
        if not self._population:
            return self.ts.eval_p
        return DQNParams(*[p[lane] for p in self.ts.eval_p])

    def set_params(self, params: DQNParams) -> None:
        """Install EvalNet weights (TargNet synced, Adam reset); with
        population lanes the weights go to every lane."""
        params = DQNParams(*[p.to(self.device, torch.float32)
                             for p in params])
        if self._population:
            params = DQNParams(*[p.expand(self.lanes, *p.shape).clone()
                                 for p in params])
        self.ts = self.ts._replace(eval_p=params, targ_p=params,
                                   opt=adam_init(params))

    @classmethod
    def from_agent(cls, agent, platform, *, lanes: int = 1, mesh=None,
                   dp: bool = False, td_kernel: bool = False, cfg=None,
                   device=None) -> "ScanFlexAI":
        """Import a ``FlexAIAgent``: its config (unless overridden) and
        EvalNet weights, ready to continue training on this engine."""
        trainer = cls(platform, cfg if cfg is not None else agent.cfg,
                      lanes=lanes, mesh=mesh, dp=dp, td_kernel=td_kernel,
                      device=device if device is not None
                      else agent.learner.device)
        trainer.set_params(agent.learner.eval_p)
        trainer.losses = list(agent.losses)
        return trainer

    def to_agent(self, platform, lane: int = 0):
        """Export to a ``FlexAIAgent`` (the loop trainer): the greedy
        policy, and so every placement, is kept bit for bit."""
        from repro_torch.core.flexai.agent import FlexAIAgent
        agent = FlexAIAgent(platform, self.cfg, device=self.device)
        params = self.eval_params(lane)
        agent.learner.eval_p = params
        agent.learner.targ_p = params
        agent.losses = list(self.losses)
        return agent

    def save_weights(self, path: str, lane: int = 0) -> None:
        """The shared p0..p5 npz (readable by the JAX package)."""
        save_dqn_npz(path, self.eval_params(lane))

    def load_weights(self, path: str) -> None:
        self.set_params(load_dqn_npz(path, self.device))

    def schedule(self, tasks, lane: int = 0, health=None) -> dict:
        ta = self._as_arrays(tasks).to(self.device)
        t0 = time.perf_counter()
        final, recs = self._sched_fn(self.eval_params(lane), ta,
                                     health=health)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        summ = summarize(self.spec, final, recs)
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(ta.num_tasks, 1)
        summ["placements"] = recs.action.cpu().numpy()
        return summ
