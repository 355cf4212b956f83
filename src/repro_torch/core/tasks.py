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


# ---------------------------------------------------------------------------
# pipeline-stage DAG form (one route -> chunk tasks -> pipeline stages)
# ---------------------------------------------------------------------------

class StageGraph(NamedTuple):
    """A route compiled to a pipeline DAG: every task of ``tasks`` flows
    through ``n_stages`` stages (stage s of task k depends on stage s-1 of
    task k: the perception net cut into MAC-balanced layer windows).

    Static per-kind metadata (NumPy):

    * ``layer_splits`` [n_kinds, S+1]: stage s of kind k runs layers
      ``splits[k, s]:splits[k, s+1]``;
    * ``mac_frac``     [n_kinds, S]: MAC fraction per stage (rows sum to 1);
    * ``act_bytes``    [n_kinds, S]: activation bytes crossing the boundary
      AFTER stage s (the last column, the net's output, is 0).

    ``edges_src`` / ``edges_dst`` ([S-1] each) are the producer ->
    consumer stage edges, ``s -> s+1`` for the chain."""
    tasks: TaskArrays
    n_stages: int
    layer_splits: np.ndarray   # [n_kinds, S+1] i32
    mac_frac: np.ndarray       # [n_kinds, S] f32
    act_bytes: np.ndarray      # [n_kinds, S] f32
    edges_src: np.ndarray      # [S-1] i32
    edges_dst: np.ndarray      # [S-1] i32


@lru_cache(maxsize=8)
def stage_layer_stats(n_stages: int):
    """MAC-balanced layer windows of every perception net (Table 1):
    ``(layer_splits [n_kinds, S+1], mac_frac [n_kinds, S], act_bytes
    [n_kinds, S])`` in KIND_INDEX order.  Each boundary is the first layer
    boundary at or after the equal-MACs target, with at least one layer a
    stage.  A boundary's activation is the boundary layer's output tensor,
    ``4 * c_out * (hw // stride)^2`` bytes (``hw`` of a conv layer is
    already its output size; the second division by the stride is the
    reference's, kept)."""
    stats = _model_stats()
    splits = np.zeros((len(KIND_ORDER), n_stages + 1), np.int32)
    frac = np.zeros((len(KIND_ORDER), n_stages), np.float32)
    act = np.zeros((len(KIND_ORDER), n_stages), np.float32)
    for ki, kind in enumerate(KIND_ORDER):
        per_layer = stats[kind.value]["per_layer"]
        macs = np.asarray([l["macs"] for l in per_layer], np.float64)
        csum = np.concatenate([[0.0], np.cumsum(macs)])
        total = csum[-1]
        bounds = [0]
        for s in range(1, n_stages):
            b = int(np.searchsorted(csum, total * s / n_stages))
            b = min(max(b, bounds[-1] + 1), len(per_layer) - (n_stages - s))
            bounds.append(b)
        bounds.append(len(per_layer))
        splits[ki] = np.asarray(bounds, np.int32)
        for s in range(n_stages):
            lo, hi = bounds[s], bounds[s + 1]
            frac[ki, s] = (csum[hi] - csum[lo]) / total
            if s < n_stages - 1:
                out = per_layer[hi - 1]
                hw = out.get("hw", 1) // max(out.get("stride", 1), 1)
                act[ki, s] = 4.0 * out["c_out"] * max(hw, 1) ** 2
    return splits, frac, act


def route_to_stage_graph(tasks, n_stages: int) -> StageGraph:
    """One route (a ``Task`` list or ``TaskArrays``) as its pipeline DAG
    of ``n_stages`` stages; one stage is the whole-task form."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    ta = tasks if isinstance(tasks, TaskArrays) else tasks_to_arrays(tasks)
    splits, frac, act = stage_layer_stats(n_stages)
    s = np.arange(n_stages - 1, dtype=np.int32)
    return StageGraph(tasks=ta, n_stages=n_stages, layer_splits=splits,
                      mac_frac=frac, act_bytes=act,
                      edges_src=s, edges_dst=s + 1)
