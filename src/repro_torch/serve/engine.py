"""FlexAI placement serving on the step-loop greedy scheduler.

Each request is one vehicle's task queue.  Queues are precompiled to
``TaskArrays``, right-padded to power-of-two length buckets, stacked per
bucket and placed by one batched greedy run per bucket; results come back
to the host in one transfer per bucket.
"""
from __future__ import annotations

import torch

from repro_torch.core.flexai.dqn import DQNParams
from repro_torch.core.flexai.engine import make_schedule_fn
from repro_torch.core.platform import route, spec_from_platform, summarize
from repro_torch.core.tasks import (TaskArrays, pad_task_arrays,
                                    stack_task_arrays, tasks_to_arrays)
from repro_torch.kernels.protocol import resolve_device


def power_of_two_bucket(n: int, minimum: int) -> int:
    """Power-of-two length bucket >= max(n, minimum) — the shape
    quantization of the wave engines (lockstep cost is set by the longest
    member, so co-batching only makes sense within a bucket)."""
    if minimum < 1:
        raise ValueError(
            f"power_of_two_bucket minimum must be >= 1, got {minimum}")
    b = minimum
    while b < n:
        b *= 2
    return b


def _host(x):
    return type(x)(*[f.cpu() for f in x])


class FlexAIPlacementService:
    """Multi-vehicle placement serving: bucketed, route-batched greedy
    placement, with a solo path for requests whose deadline is tight."""

    def __init__(self, platform, params: DQNParams, *,
                 backlog_scale: float = 1.0, min_bucket: int = 64,
                 tight_slack_s: "float | None" = None, device=None):
        self.device = resolve_device(device)
        self.spec = spec_from_platform(platform, self.device)
        self.params = DQNParams(*[p.to(self.device, torch.float32)
                                  for p in params])
        self.backlog_scale = backlog_scale
        self.min_bucket = min_bucket
        self.tight_slack_s = tight_slack_s
        self._batched_fn = make_schedule_fn(self.spec, backlog_scale,
                                            batched=True)
        # tight-deadline lane: the single-route run, dispatched at once
        # instead of waiting to co-batch with bucket peers
        self._fused_fn = make_schedule_fn(self.spec, backlog_scale)
        self.dispatches = 0
        self.fused_dispatches = 0

    def _bucket(self, n: int) -> int:
        return power_of_two_bucket(n, self.min_bucket)

    def place(self, queues: list, deadlines: "list | None" = None,
              now: float = 0.0) -> list[dict]:
        """Schedule every queue; returns one summary dict per queue with
        ``placements`` trimmed to the queue's real length.

        With ``tight_slack_s`` set, a request whose slack ``deadline -
        now`` is below it skips co-batching and runs solo ("fused" path);
        the rest run per bucket ("batched").
        """
        arrays = [q if isinstance(q, TaskArrays) else tasks_to_arrays(q)
                  for q in queues]
        results: list = [None] * len(arrays)
        tight: set = set()
        if deadlines is not None and self.tight_slack_s is not None:
            tight = {i for i, d in enumerate(deadlines)
                     if d is not None and d - now < self.tight_slack_s}
        for i in sorted(tight):
            ta = pad_task_arrays(arrays[i], self._bucket(arrays[i].num_tasks))
            final, recs = self._fused_fn(self.params, ta.to(self.device))
            final, recs = _host(final), _host(recs)
            self.dispatches += 1
            self.fused_dispatches += 1
            summ = summarize(self.spec, final, recs)
            summ["placements"] = recs.action[: arrays[i].num_tasks].numpy()
            summ["bucket"] = ta.num_tasks
            summ["path"] = "fused"
            results[i] = summ
        by_bucket: dict = {}
        for i, ta in enumerate(arrays):
            if i not in tight:
                by_bucket.setdefault(self._bucket(ta.num_tasks), []).append(i)
        for bucket, idxs in sorted(by_bucket.items()):
            batch = stack_task_arrays(
                [pad_task_arrays(arrays[i], bucket) for i in idxs])
            finals, recs = self._batched_fn(self.params,
                                            batch.to(self.device))
            # one device->host transfer per bucket, then host slicing
            finals, recs = _host(finals), _host(recs)
            self.dispatches += 1
            for lane, i in enumerate(idxs):
                lane_recs = route(recs, lane)
                summ = summarize(self.spec, route(finals, lane), lane_recs)
                summ["placements"] = \
                    lane_recs.action[: arrays[i].num_tasks].numpy()
                summ["bucket"] = bucket
                summ["path"] = "batched"
                results[i] = summ
        return results

