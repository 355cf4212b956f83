"""ATA — Adaptive Task-partitioning Algorithm (Oh et al., ICTC'18 per the
paper's citation [47]): minimize energy while guaranteeing latency.

Per task: among accelerators whose predicted response time meets the
safety time, pick the lowest-energy one; if none is feasible, fall back to
the fastest response (deadline salvage).  This makes ATA MS-optimized
(Fig 12c/13) at some energy/time cost elsewhere — matching the paper.
"""
from __future__ import annotations

from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.schedulers.base import Scheduler, register


@register
class ATAScheduler(Scheduler):
    name = "ata"

    def assign(self, platform: HMAIPlatform, task) -> int:
        feasible = []
        for i in range(platform.n):
            resp = platform.predicted_response(task, i)
            if resp <= task.safety_time:
                feasible.append((platform.specs[i].energy(task.kind), i))
        if feasible:
            return min(feasible)[1]
        # no feasible accelerator: minimize response time
        return min(range(platform.n),
                   key=lambda i: platform.predicted_response(task, i))
