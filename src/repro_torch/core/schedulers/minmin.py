"""Min-Min heuristic (Braun et al. 2001, paper baseline).

Classic Min-Min operates on a batch of ready tasks: repeatedly find, for
each unscheduled task, its minimum-completion-time machine; then commit the
task whose minimum completion time is smallest.  Streaming arrival is
handled by windowing the queue (tasks within a window are treated as
simultaneously ready), matching how the paper applies batch heuristics to
camera bursts (30 frames arrive at once).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.schedulers.base import Scheduler, register


@register
class MinMinScheduler(Scheduler):
    name = "minmin"

    def __init__(self, window: int = 30):
        self.window = window

    def schedule(self, platform: HMAIPlatform, tasks: list) -> dict:
        t0 = time.perf_counter()
        for w0 in range(0, len(tasks), self.window):
            batch = list(tasks[w0: w0 + self.window])
            while batch:
                # completion time of each (task, accel) pair
                best_pair = None
                best_ct = np.inf
                for ti, task in enumerate(batch):
                    for i in range(platform.n):
                        start = max(task.arrival_time, platform.avail[i])
                        ct = start + platform.exec_time(task, i)
                        if ct < best_ct:
                            best_ct = ct
                            best_pair = (ti, i)
                ti, i = best_pair
                platform.execute(batch.pop(ti), i)
        dt = time.perf_counter() - t0
        summ = platform.summary()
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(len(tasks), 1)
        return summ
