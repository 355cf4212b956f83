"""Scheduler interface + registry (the port's copy of the JAX package's
``core/schedulers/base.py``).

A scheduler consumes a task queue (arrival-ordered) and commits every task
to an accelerator on the platform.  ``schedule`` returns the platform
summary augmented with scheduling-runtime stats (T_schedule in the Fig-14
breakdown).
"""
from __future__ import annotations

import time

from repro_torch.core.hmai import HMAIPlatform


class Scheduler:
    name = "base"

    def assign(self, platform: HMAIPlatform, task) -> int:
        raise NotImplementedError

    def schedule(self, platform: HMAIPlatform, tasks: list) -> dict:
        t0 = time.perf_counter()
        for task in tasks:
            idx = self.assign(platform, task)
            platform.execute(task, idx)
        dt = time.perf_counter() - t0
        summ = platform.summary()
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(len(tasks), 1)
        return summ


SCHEDULERS: dict = {}


def register(cls):
    SCHEDULERS[cls.name] = cls
    return cls


def get_scheduler(name: str, **kwargs) -> Scheduler:
    return SCHEDULERS[name](**kwargs)
