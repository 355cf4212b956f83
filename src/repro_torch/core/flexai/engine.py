"""FlexAI episode engine in PyTorch: greedy placement and single-lane
training.

The JAX package runs a route inside one ``lax.scan``; here a route is a
Python loop over its T steps, batched over routes on a leading axis (the
place of ``vmap``).  Everything the loop decides from task validity alone
(the epsilon schedule, replay size, the ``min_replay`` / ``update_every``
/ ``target_sync_every`` cadence) is computed on the host before the loop,
so no step waits for the device to decide whether to update.

* ``make_schedule_fn``: greedy inference (state vector, Q-net, alive-masked
  first-max argmax, ``platform_step``) per step.
* ``make_train_fn``: epsilon-greedy act, platform step, dGvalue + dMS
  reward, replay write and, on the cadence, a double-DQN TD update with
  TargNet sync; ``td_kernel=True`` sends the update through the fused CUDA
  kernel (``repro_torch.kernels.dqn_update``).
* Both take an optional ``health`` trace ([T, n], ``core.faults``),
  installed row by row before each step: dead cores leave the greedy
  argmax and ``platform_step`` charges health-scaled exec and energy.
  Without one, the state's cores are made healthy once before the loop
  (``faults.start_trace``) and no step runs a health op.
* ``ScanFlexAI``: the train / schedule / weights surface of the JAX
  package's class of that name, single lane.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.faults import start_trace
from repro_torch.core.flexai.dqn import (AdamState, DQNParams, adam_init,
                                         dqn_td_update, init_qnet,
                                         load_dqn_npz, qnet_apply,
                                         save_dqn_npz)
from repro_torch.core.flexai.replay import (DeviceReplay, device_replay_add,
                                            device_replay_init,
                                            device_replay_sample)
from repro_torch.core.flexai.reward import reward_from_states
from repro_torch.core.platform import (PlatformSpec, kind_feature_table,
                                       platform_init, platform_step, route,
                                       spec_from_platform, stack_records,
                                       state_vector, summarize, with_health)
from repro_torch.core.tasks import TaskArrays, tasks_to_arrays
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


# ---------------------------------------------------------------------------
# single-lane training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """What a training episode carries from one episode to the next:
    EvalNet/TargNet/Adam, the replay ring, the epsilon / TargNet counters
    (host integers), and the generator of the default draws."""
    eval_p: DQNParams
    targ_p: DQNParams
    opt: AdamState
    replay: DeviceReplay
    env_steps: int
    updates: int
    generator: torch.Generator


class Draws(NamedTuple):
    """The random numbers of one episode, per step t: the exploration
    uniform, the random action, and the [B] replay rows of the TD batch.
    The JAX trainer draws these from ``split(key, 4)`` at every step; a
    test regenerates them from its key chain and injects them, so the two
    trainers can be held to the same trajectory."""
    explore_u: torch.Tensor   # [T] f32 in [0, 1)
    action: torch.Tensor      # [T] int in [0, n_actions)
    sample_idx: torch.Tensor  # [T, B] int in [0, replay size at step t)


def train_init(state_dim: int, n_actions: int, replay_capacity: int,
               seed: int = 0, device="cpu") -> TrainState:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_qnet(state_dim, n_actions, gen, device)
    return TrainState(
        eval_p=params, targ_p=params, opt=adam_init(params),
        replay=device_replay_init(replay_capacity, state_dim, device),
        env_steps=0, updates=0, generator=gen)


class _Cadence(NamedTuple):
    eps: np.ndarray        # [T] f32 epsilon at each step
    size: np.ndarray       # [T] replay size after the step's write
    do_update: np.ndarray  # [T] bool
    sync: np.ndarray       # [T] bool TargNet sync after the update
    env_steps: int
    updates: int


def _cadence(cfg, valid: np.ndarray, ts: TrainState) -> _Cadence:
    """The host-side counters of one episode, as plain functions of
    ``valid``.  Epsilon is computed in f32 as the JAX trainer does."""
    t_len = len(valid)
    eps = np.empty(t_len, np.float32)
    size = np.empty(t_len, np.int64)
    do_update = np.zeros(t_len, bool)
    sync = np.zeros(t_len, bool)
    env, n, upd = ts.env_steps, ts.replay.size, ts.updates
    cap = ts.replay.capacity
    decay = np.float32(max(cfg.eps_decay_steps, 1))
    for t in range(t_len):
        frac = min(np.float32(1.0), np.float32(env) / decay)
        eps[t] = (np.float32(cfg.eps_start)
                  + np.float32(cfg.eps_end - cfg.eps_start) * frac)
        if valid[t]:
            env += 1
            n = min(n + 1, cap)
        size[t] = n
        if valid[t] and n >= cfg.min_replay and env % cfg.update_every == 0:
            do_update[t] = True
            upd += 1
            sync[t] = upd % cfg.target_sync_every == 0
    return _Cadence(eps, size, do_update, sync, env, upd)


def _default_draws(gen: torch.Generator, size: np.ndarray, n_actions: int,
                   batch_size: int, device) -> Draws:
    """One episode of draws from ``gen``, on the device, in three calls."""
    t_len = len(size)
    u = torch.rand(t_len, generator=gen, device=device)
    act = torch.randint(0, n_actions, (t_len,), generator=gen, device=device)
    smp = torch.rand(t_len, batch_size, generator=gen, device=device,
                     dtype=torch.float64)
    n = torch.as_tensor(np.maximum(size, 1), device=device)[:, None]
    idx = torch.minimum((smp * n).long(), n - 1)
    return Draws(u, act, idx)


def make_train_fn(spec: PlatformSpec, cfg, td_kernel: bool = False):
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
    stays uniform over all cores."""
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
# host-side wrapper
# ---------------------------------------------------------------------------

class ScanFlexAI:
    """FlexAI trained and run by the step-loop engine, single lane.

    Runs on ``device`` (default: the GPU, see
    :func:`repro_torch.kernels.protocol.default_device`).  ``td_kernel``
    routes every TD update through the fused CUDA kernel; on the CPU the
    same entry point runs its plain version.
    """

    def __init__(self, platform, cfg, td_kernel: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec_from_platform(platform, self.device)
        self.n_actions = platform.n
        self.state_dim = 3 + 5 * platform.n
        self.td_kernel = td_kernel
        self.ts = train_init(self.state_dim, self.n_actions,
                             cfg.replay_capacity, seed=cfg.seed,
                             device=self.device)
        self._train_fn = make_train_fn(self.spec, cfg, td_kernel=td_kernel)
        self._sched_fn = make_schedule_fn(self.spec, cfg.backlog_scale)
        self.losses: list[float] = []
        self.best_eval_stm: float | None = None
        self._best_stm: float = -1.0
        self._best_params: DQNParams | None = None

    @staticmethod
    def _as_arrays(tasks) -> TaskArrays:
        return tasks if isinstance(tasks, TaskArrays) else \
            tasks_to_arrays(tasks)

    def train_episode(self, tasks, draws: Draws | None = None,
                      health=None) -> dict:
        """One training episode on one route; ``health`` ([T, n]) trains
        under a fault trace (the degradation trainer)."""
        self.ts, plat, recs, losses, upd = self._train_fn(
            self.ts, self._as_arrays(tasks), draws, health)
        losses = losses.cpu()[upd]
        self.losses.extend(losses.tolist())
        s = summarize(self.spec, plat, recs)
        s["mean_loss"] = float(losses.mean()) if len(losses) else None
        return s

    def train(self, queues: list, episodes: int, eval_queue=None,
              eval_every: int = 5, on_episode=None,
              start_episode: int = 0) -> list:
        """Cycle the queue pool for ``episodes`` episodes.  With
        ``eval_queue``, every ``eval_every`` episodes the greedy policy is
        scored on it and the best EvalNet weights are restored at the
        end (model selection)."""
        routes = [self._as_arrays(q) for q in queues]
        ta_eval = (self._as_arrays(eval_queue) if eval_queue is not None
                   else None)
        history = []
        if start_episode == 0:
            self._best_stm, self._best_params = -1.0, None
        for ep in range(start_episode, episodes):
            history.append(self.train_episode(routes[ep % len(routes)]))
            if ta_eval is not None and (ep + 1) % eval_every == 0:
                stm = self.schedule(ta_eval)["stm_rate"]
                history[-1]["eval_stm"] = stm
                if stm > self._best_stm:
                    self._best_stm = stm
                    self._best_params = self.eval_params()
            if on_episode is not None:
                on_episode(ep, self)
        if self._best_params is not None:
            self.set_params(self._best_params)
            self.best_eval_stm = self._best_stm
        return history

    def eval_params(self) -> DQNParams:
        return self.ts.eval_p

    def set_params(self, params: DQNParams) -> None:
        """Install EvalNet weights (TargNet synced, Adam reset)."""
        params = DQNParams(*[p.to(self.device, torch.float32)
                             for p in params])
        self.ts = self.ts._replace(eval_p=params, targ_p=params,
                                   opt=adam_init(params))

    def save_weights(self, path: str) -> None:
        """The shared p0..p5 npz (readable by the JAX package)."""
        save_dqn_npz(path, self.eval_params())

    def load_weights(self, path: str) -> None:
        self.set_params(load_dqn_npz(path, self.device))

    def schedule(self, tasks, health=None) -> dict:
        ta = self._as_arrays(tasks).to(self.device)
        t0 = time.perf_counter()
        final, recs = self._sched_fn(self.eval_params(), ta, health=health)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        summ = summarize(self.spec, final, recs)
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(ta.num_tasks, 1)
        summ["placements"] = recs.action.cpu().numpy()
        return summ
