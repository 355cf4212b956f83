"""Task descriptors for the driving-automation workload (paper §7.1).

A Task is one camera frame needing one CNN inference (DET via YOLO or SSD,
TRA via GOTURN).  Task-Info fed to the RL agent is (Amount, LayerNum,
safety_time) exactly as §7.1 specifies; Amount/LayerNum derive from the
perception model definitions (Table 1), not hard-coded constants.

The second half holds the struct-of-arrays queue, ``TaskArrays``, as torch
tensors: the form the step-loop engines consume.  Queues are built on the
host; :meth:`TaskArrays.to` moves one to the engine's device.
"""
from __future__ import annotations

import dataclasses
import enum
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch


class TaskKind(enum.Enum):
    YOLO = "yolo"      # DET, small/medium objects
    SSD = "ssd"        # DET, large objects
    GOTURN = "goturn"  # TRA


# canonical integer encoding shared by the NumPy platform's cached tables
# and the tensor platform (``core.platform``)
KIND_ORDER = tuple(TaskKind)
KIND_INDEX = {k: i for i, k in enumerate(KIND_ORDER)}
GOTURN_INDEX = KIND_INDEX[TaskKind.GOTURN]
GROUP_ORDER = ("FC", "FLSC", "RLSC", "FRSC", "RRSC", "RC")
GROUP_INDEX = {g: i for i, g in enumerate(GROUP_ORDER)}


@lru_cache(maxsize=1)
def _model_stats() -> dict:
    from repro_torch.models.perception.stats import perception_stats
    return perception_stats()


@dataclasses.dataclass(frozen=True)
class Task:
    uid: int
    kind: TaskKind
    camera_group: str    # FC / FLSC / RLSC / FRSC / RRSC / RC
    camera_id: int
    arrival_time: float  # seconds since route start
    safety_time: float   # response budget (criteria.camera_safety_time)

    @property
    def amount(self) -> float:
        """Computation amount (MACs)."""
        return float(_model_stats()[self.kind.value]["macs"])

    @property
    def layer_num(self) -> int:
        return int(_model_stats()[self.kind.value]["layers"])


def task_features(task: Task) -> tuple[float, float, float]:
    """Task-Info vector for the RL agent: (Amount, LayerNum, safety_time),
    scaled to O(1) ranges."""
    return (task.amount / 30e9, task.layer_num / 100.0, task.safety_time)


# ---------------------------------------------------------------------------
# serving deadlines (Table 5 period requirements)
# ---------------------------------------------------------------------------

# Table 5, urban go-straight row, split per model: the fleet must sustain
# these aggregate FPS, so each submitted frame of a kind has 1/FPS seconds
# of serving slack before the next frame of that kind lands.
TABLE5_FPS = {TaskKind.YOLO: 435.0, TaskKind.SSD: 435.0,
              TaskKind.GOTURN: 840.0}


def kind_period_s(kind: TaskKind) -> float:
    """Required processing period (s/frame) for one task of ``kind``."""
    return 1.0 / TABLE5_FPS[kind]


@lru_cache(maxsize=1)
def kind_period_table() -> np.ndarray:
    """[n_kinds] f32 periods in KIND_INDEX order (vectorized lookup for
    ``TaskArrays.kind``)."""
    return np.asarray([kind_period_s(k) for k in KIND_ORDER], np.float32)


def route_deadline_budget(ta: "TaskArrays", scale: float = 1.0) -> float:
    """Serving-deadline budget (s) for a placement request: the summed
    per-task Table-5 period over valid tasks, scaled by ``scale``."""
    periods = kind_period_table()[ta.kind.cpu().numpy()]
    return float(scale * periods[ta.valid.cpu().numpy()].sum())


def token_deadline_budget(prompt_len: int, max_new_tokens: int,
                          scale: float = 1.0,
                          per_token: float = 2.0) -> float:
    """Deadline budget for a token-serving request, in engine step units:
    ``per_token`` steps of slack per token of total length (prompt replay +
    decode), scaled by ``scale``.  The default 2.0 admits one full wave of
    queueing ahead of the request before its deadline is at risk."""
    return scale * per_token * max(prompt_len + max_new_tokens, 1)


# ---------------------------------------------------------------------------
# struct-of-arrays form (the queue fed to the step-loop engines)
# ---------------------------------------------------------------------------

class TaskArrays(NamedTuple):
    """A task queue as parallel tensors: [T] for one route, [R, T] for a
    route batch, [R] for one step of a batch.  ``valid`` marks real tasks;
    padding rows (added so routes share a length) carry valid=False and
    leave the platform state untouched."""
    kind: torch.Tensor      # int64, KIND_INDEX encoding
    arrival: torch.Tensor   # f32 seconds
    safety: torch.Tensor    # f32 seconds
    group: torch.Tensor     # int64, GROUP_INDEX encoding
    valid: torch.Tensor     # bool

    @property
    def num_tasks(self) -> int:
        return int(self.arrival.shape[-1])

    def to(self, device) -> "TaskArrays":
        return TaskArrays(*[f.to(device) for f in self])

    def step(self, t: int) -> "TaskArrays":
        """Column ``t`` of a [R, T] batch: the [R] task row of step t."""
        return TaskArrays(*[f[:, t] for f in self])


def tasks_to_arrays(tasks: list) -> TaskArrays:
    """Precompile a ``Task`` list into struct-of-arrays form on the host."""
    return TaskArrays(
        kind=torch.tensor([KIND_INDEX[t.kind] for t in tasks],
                          dtype=torch.int64),
        arrival=torch.tensor([t.arrival_time for t in tasks],
                             dtype=torch.float32),
        safety=torch.tensor([t.safety_time for t in tasks],
                            dtype=torch.float32),
        group=torch.tensor([GROUP_INDEX[t.camera_group] for t in tasks],
                           dtype=torch.int64),
        valid=torch.ones(len(tasks), dtype=torch.bool),
    )


def invalid_task_arrays(length: int) -> TaskArrays:
    """An all-padding route: every row carries ``valid=False`` so the
    engine passes the platform state through untouched."""
    return TaskArrays(
        kind=torch.zeros(length, dtype=torch.int64),
        arrival=torch.zeros(length, dtype=torch.float32),
        safety=torch.ones(length, dtype=torch.float32),
        group=torch.zeros(length, dtype=torch.int64),
        valid=torch.zeros(length, dtype=torch.bool),
    )


def pad_task_arrays(ta: TaskArrays, to_len: int) -> TaskArrays:
    """Right-pad a [T] route with invalid rows to a static length (shape
    bucketing)."""
    n = ta.arrival.shape[-1]
    if to_len < n:
        raise ValueError(f"cannot pad {n} tasks down to {to_len}")
    if to_len == n:
        return ta
    pad = invalid_task_arrays(to_len - n)
    return TaskArrays(*[torch.cat([a, p.to(a.device)])
                        for a, p in zip(ta, pad)])


def stack_task_arrays(routes: list) -> TaskArrays:
    """Stack per-route ``TaskArrays`` into a [R, T_max] batch, padding every
    route to the longest."""
    t_max = max(r.arrival.shape[-1] for r in routes)
    padded = [pad_task_arrays(r, t_max) for r in routes]
    return TaskArrays(*[torch.stack([getattr(p, f) for p in padded])
                        for f in TaskArrays._fields])


def pad_route_batch(batch: TaskArrays, multiple: int) -> TaskArrays:
    """Pad the leading route axis of a [R, T] batch to a multiple of
    ``multiple`` with all-invalid routes."""
    r, t = batch.arrival.shape
    pad = (-r) % multiple
    if pad == 0:
        return batch
    inv = invalid_task_arrays(t)
    return TaskArrays(*[
        torch.cat([b, f.to(b.device).expand(pad, t)])
        for b, f in zip(batch, inv)])


def window_task_arrays(ta: TaskArrays, window: int) -> TaskArrays:
    """Right-pad the task axis ([..., T]) with invalid zero rows to a
    ``window`` multiple and fold it to [..., n_windows, window]: the
    shared layout of the windowed schedulers (Min-Min, device GA/SA)."""
    t = ta.arrival.shape[-1]
    pad = -t % window
    return TaskArrays(*[
        torch.nn.functional.pad(f, (0, pad)).reshape(
            *f.shape[:-1], -1, window) for f in ta])
