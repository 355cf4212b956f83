"""FlexAI's loop trainer (paper §7, Fig 8), the port of the JAX package's
``FlexAIAgent``.

The agent's input state is Task-Info (Amount, LayerNum, safety_time) +
HW-Info (E_i, T_i, R_Balance_i, MS_i and the service time of the task's
class for every accelerator); its action is the accelerator index; the
reward is dGvalue + dMS (``reward.py``).  Training follows Fig 8 task by
task on the NumPy ``HMAIPlatform``: schedule -> execute -> record
(S_i, H_j, r_i, S_{i+1}) in the host ``ReplayBuffer`` -> replay-sample ->
TD update (``DQNLearner``, plain PyTorch on the device), TargNet synced on
a fixed cadence.  Exploration draws from ``np.random.default_rng(seed)``
as the JAX agent does, so the two take the same random decisions.

This is the slow reference loop (one Q forward and one update dispatch a
task); ``engine.ScanFlexAI`` is the trainer to use, and the two exchange
weights losslessly (``ScanFlexAI.from_agent`` / ``to_agent`` and the
shared npz).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.flexai.config import FlexAIConfig
from repro_torch.core.flexai.dqn import (DQNLearner, load_dqn_npz,
                                         save_dqn_npz)
from repro_torch.core.flexai.replay import ReplayBuffer
from repro_torch.core.flexai.reward import compute_reward, snapshot
from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.tasks import KIND_INDEX, Task, task_features
from repro_torch.kernels.protocol import resolve_device, synchronize


class FlexAIAgent:
    def __init__(self, platform: HMAIPlatform,
                 cfg: FlexAIConfig = FlexAIConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_actions = platform.n
        self.state_dim = 3 + 5 * platform.n
        self.learner = DQNLearner(
            self.state_dim, self.n_actions, gamma=cfg.gamma, lr=cfg.lr,
            target_sync_every=cfg.target_sync_every, seed=cfg.seed,
            device=self.device)
        self.replay = ReplayBuffer(cfg.replay_capacity, self.state_dim,
                                   seed=cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)
        self.env_steps = 0
        self.losses: list[float] = []

    # ------------------------------------------------------------------
    def state_vector(self, task: Task, platform: HMAIPlatform) -> np.ndarray:
        tf = np.asarray(task_features(task), np.float32)
        hw = platform.hw_info(now=task.arrival_time).astype(np.float32)
        hw[:, 1] = np.log1p(hw[:, 1] / self.cfg.backlog_scale)
        exec_row = platform.exec_time_table[:, KIND_INDEX[task.kind]] \
            .astype(np.float32)[:, None]
        hw = np.concatenate([hw, exec_row], axis=1)
        return np.concatenate([tf, hw.reshape(-1)])

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.env_steps / max(c.eps_decay_steps, 1))
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def act(self, state: np.ndarray, explore: bool) -> int:
        if explore and self.rng.random() < self.epsilon():
            return int(self.rng.integers(0, self.n_actions))
        q = self.learner.q_values(state[None])[0]
        return int(q.argmax())

    # ------------------------------------------------------------------
    def train_episode(self, platform: HMAIPlatform, tasks: list) -> dict:
        """One episode = one task queue (paper §8.3)."""
        platform.reset()
        c = self.cfg
        ep_losses = []
        for i, task in enumerate(tasks):
            state = self.state_vector(task, platform)
            action = self.act(state, explore=True)
            before = snapshot(platform)
            platform.execute(task, action)
            reward = compute_reward(before, platform)
            nxt_task = tasks[i + 1] if i + 1 < len(tasks) else task
            next_state = self.state_vector(nxt_task, platform)
            self.replay.add(state, action, reward, next_state,
                            done=(i + 1 == len(tasks)))
            self.env_steps += 1
            if (self.replay.size >= c.min_replay
                    and self.env_steps % c.update_every == 0):
                loss = self.learner.update(self.replay.sample(c.batch_size))
                ep_losses.append(loss)
                self.losses.append(loss)
        summ = platform.summary()
        summ["mean_loss"] = float(np.mean(ep_losses)) if ep_losses else None
        return summ

    def train(self, platform: HMAIPlatform, queues: list, episodes: int,
              eval_queue: list | None = None, eval_every: int = 5) -> list:
        """Cycle through task queues for the given number of episodes;
        with ``eval_queue``, keep the best-eval EvalNet weights (model
        selection on a validation queue)."""
        history = []
        best_stm = -1.0
        best_params = None
        for ep in range(episodes):
            tasks = queues[ep % len(queues)]
            history.append(self.train_episode(platform, tasks))
            if eval_queue is not None and (ep + 1) % eval_every == 0:
                p_eval = HMAIPlatform(
                    specs=list(platform.specs), capacity_scale=1.0)
                stm = self.schedule(p_eval, eval_queue)["stm_rate"]
                history[-1]["eval_stm"] = stm
                if stm > best_stm:
                    best_stm = stm
                    best_params = self.learner.eval_p
        if best_params is not None:
            self.learner.eval_p = best_params
            self.learner.targ_p = best_params
        return history

    # ------------------------------------------------------------------
    def save_weights(self, path: str) -> None:
        save_dqn_npz(path, self.learner.eval_p)

    def load_weights(self, path: str) -> None:
        params = load_dqn_npz(path, self.device)
        self.learner.eval_p = params
        self.learner.targ_p = params

    # ------------------------------------------------------------------
    def schedule(self, platform: HMAIPlatform, tasks: list) -> dict:
        """Inference (well-trained agent): greedy Q per task (§7.1)."""
        t0 = time.perf_counter()
        for task in tasks:
            state = self.state_vector(task, platform)
            action = self.act(state, explore=False)
            platform.execute(task, action)
        sched_time = time.perf_counter() - t0
        summ = platform.summary()
        summ["schedule_time_s"] = sched_time
        summ["schedule_time_per_task_s"] = sched_time / max(len(tasks), 1)
        return summ

    def schedule_scan(self, platform: HMAIPlatform, tasks) -> dict:
        """Greedy inference through the step-loop engine: the same policy
        and weights as ``schedule``, one batched run a route instead of a
        Q forward a task.  ``tasks`` may be a Task list or ``TaskArrays``;
        the schedule function is cached per platform table and
        ``backlog_scale``."""
        from repro_torch.core.flexai.engine import make_schedule_fn
        from repro_torch.core.platform import spec_from_platform, summarize
        from repro_torch.core.tasks import TaskArrays, tasks_to_arrays
        key = (platform.exec_time_table.tobytes(),
               platform.energy_table.tobytes(),
               float(self.cfg.backlog_scale))
        cache = getattr(self, "_scan_cache", None)
        if cache is None:
            cache = self._scan_cache = {}
        if key not in cache:
            spec = spec_from_platform(platform, self.device)
            cache[key] = (spec, make_schedule_fn(spec,
                                                 self.cfg.backlog_scale))
        spec, fn = cache[key]
        ta = tasks if isinstance(tasks, TaskArrays) else \
            tasks_to_arrays(tasks)
        ta = ta.to(self.device)
        t0 = time.perf_counter()
        final, recs = fn(self.learner.eval_p, ta)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        summ = summarize(spec, final, recs)
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(ta.num_tasks, 1)
        summ["placements"] = recs.action.cpu().numpy()
        return summ
