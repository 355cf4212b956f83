"""Fault tolerance: heartbeats, straggler detection and the preemption
flag (the port of ``repro.train.fault_tolerance``).

The coordinator-side logic (who is slow, who went silent) is pure Python
over step-timing records.  The QoS serving layer drives the detector from
its virtual clock, so a fault's detection is deterministic and replays
bit for bit.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np


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
