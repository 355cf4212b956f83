"""Fault tolerance: heartbeats, straggler detection, the preemption
flag, the checkpointed training runner and elastic restore (the port of
``repro.train.fault_tolerance``).

The coordinator-side logic (who is slow, who went silent) is pure Python
over step-timing records.  The QoS serving layer drives the detector from
its virtual clock, so a fault's detection is deterministic and replays
bit for bit.  ``run_with_fault_tolerance`` drives a train step over a
step-indexed batch stream, checkpointing every ``ckpt_every`` steps and
on preemption; a restart restores the latest checkpoint
(``elastic_restore``) and continues from its step.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class HeartbeatRecord:
    host_id: int
    step: int
    step_time_s: float
    timestamp: float


class StragglerDetector:
    """Flags hosts whose recent step times exceed ``threshold`` x the fleet
    median, and hosts that sent no heartbeat for ``dead_after_s``.

    What a coordinator does with the flags: a straggler gets a smaller
    share of the work, a dead host is evicted (the serving layer masks
    the core and sheds what no longer fits)."""

    def __init__(self, n_hosts: int, threshold: float = 1.5,
                 window: int = 16, dead_after_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.window = window
        self.dead_after_s = dead_after_s
        # ``clock`` makes heartbeat timeouts deterministic: the QoS serving
        # layer injects its virtual clock, tests inject a counter
        self._clock = time.time if clock is None else clock
        self._times: dict[int, list[float]] = {h: [] for h in range(n_hosts)}
        self._last_seen: dict[int, float] = {h: self._clock()
                                             for h in range(n_hosts)}

    def record(self, hb: HeartbeatRecord) -> None:
        times = self._times[hb.host_id]
        times.append(hb.step_time_s)
        if len(times) > self.window:
            del times[: len(times) - self.window]
        self._last_seen[hb.host_id] = hb.timestamp

    def stragglers(self) -> list[int]:
        means = {h: float(np.mean(t)) for h, t in self._times.items() if t}
        if len(means) < 2:
            return []
        median = float(np.median(list(means.values())))
        return [h for h, m in means.items() if m > self.threshold * median]

    def dead_hosts(self, now: Optional[float] = None) -> list[int]:
        now = self._clock() if now is None else now
        return [h for h, seen in self._last_seen.items()
                if now - seen > self.dead_after_s]


class PreemptionGuard:
    """SIGTERM-aware flag, checked once a step (a serving segment)."""

    def __init__(self, install_handler: bool = True):
        self.preempted = False
        if install_handler:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not the main thread

    def _handler(self, signum, frame):
        self.preempted = True


@dataclasses.dataclass
class RunResult:
    completed_steps: int
    final_state: object
    interrupted: bool


def run_with_fault_tolerance(
    train_step: Callable,
    state,
    batch_at_step: Callable[[int], dict],
    *,
    num_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    start_step: int = 0,
    guard: Optional[PreemptionGuard] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    fail_at_step: Optional[int] = None,  # fault injection for tests
) -> RunResult:
    """Checkpointed training loop with preemption handling.

    Restart pattern: the caller restores the latest checkpoint
    (``elastic_restore``) and calls this again with ``start_step`` = the
    restored step.  The data are step-indexed (``batch_at_step``), so a
    restart consumes exactly the batches it would have seen.
    """
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
    step = start_step
    while step < num_steps:
        if guard is not None and guard.preempted:
            saver.wait()
            ckpt_lib.save_checkpoint(ckpt_dir, step, state)
            return RunResult(step, state, interrupted=True)
        if fail_at_step is not None and step == fail_at_step:
            saver.wait()
            raise RuntimeError(f"injected fault at step {step}")
        batch = batch_at_step(step)
        state, metrics = train_step(state, batch)
        step += 1
        if on_metrics is not None:
            on_metrics(step, metrics)
        if step % ckpt_every == 0 or step == num_steps:
            saver.save(step, state)
    saver.wait()
    return RunResult(step, state, interrupted=False)


def elastic_restore(ckpt_dir: str, template, target_shardings=None):
    """Restore the latest checkpoint in ``ckpt_dir`` into ``template``'s
    structure, each leaf on the template leaf's device and dtype.

    Returns (state, step) or (None, 0) when no checkpoint exists.
    Checkpoints hold whole arrays, whichever mesh or process saved them,
    so one restores on one process on any device, and the JAX package's
    restore by leaf name alike.  With ``target_shardings`` (a tree of
    ``sharding.NamedSharding`` leaves of the template's structure) each
    array is placed on the target mesh: this is the elastic rescale onto
    a mesh of another shape.
    """
    path = ckpt_lib.latest_checkpoint(ckpt_dir)
    if path is None:
        return None, 0
    return (ckpt_lib.restore_checkpoint(path, template, target_shardings),
            ckpt_lib.checkpoint_step(path))
