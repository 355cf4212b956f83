"""Tensor HMAI platform: the port of the JAX package's ``platform_jax``.

``PlatformState`` holds the mutable half of ``HMAIPlatform`` as tensors
with a leading route axis ([R, n] per accelerator field, [R] per scalar),
and ``platform_step`` is its pure transition for one task per route.  The
route axis takes the place of ``jax.vmap``; a single route is R = 1.

Sums over the accelerator axis go through :func:`seq_sum`, a left-to-right
fold.  XLA reduces these short rows in that order, so on the CPU every
float field of a step and the Gvalue equal the JAX functions called op by
op, bit for bit.  (Under ``jit`` XLA also contracts ``a * b + c`` into
FMAs, which moves the last bit of ``R_Balance``; no torch path mirrors
that.)
"""
from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tasks import GOTURN_INDEX, KIND_ORDER, TaskArrays


class PlatformSpec(NamedTuple):
    """Static tables ([n_accel, n_kinds]) and Gvalue scales (0-d)."""
    exec_time: torch.Tensor       # f32 seconds
    energy: torch.Tensor          # f32 joules
    gvalue_e_scale: torch.Tensor  # f32 per-task energy scale (§6.2)
    gvalue_t_scale: torch.Tensor  # f32 per-task time scale

    @property
    def n(self) -> int:
        return self.exec_time.shape[0]

    @property
    def device(self) -> torch.device:
        return self.exec_time.device


class PlatformState(NamedTuple):
    """HW-Info (§7.2) per route: [R, n] fields, [R] running scales.

    ``alive`` / ``cap`` are the health vector: ``alive`` masks failed
    cores out of the greedy argmax and ``cap`` scales the survivors'
    capacity.  All-alive at ``cap=1.0`` divides every lookup by exactly 1.
    """
    avail: torch.Tensor       # next-free time per accelerator
    busy: torch.Tensor        # cumulative busy seconds
    E: torch.Tensor           # energy
    T: torch.Tensor           # max finish time
    MS: torch.Tensor          # summed Matching Score
    R_Balance: torch.Tensor   # running mean utilization
    num_tasks: torch.Tensor   # int32
    e_scale: torch.Tensor     # [R] running max total energy
    t_scale: torch.Tensor     # [R] running max makespan
    alive: torch.Tensor       # bool
    cap: torch.Tensor         # f32 capacity scale of alive cores


# Effective-capacity floor of a dead core a policy places on anyway.
HEALTH_FLOOR = 1e-3
# Observation-side slowdown cap (state_vector only).
OBS_SLOWDOWN_CAP = 10.0


class StepRecord(NamedTuple):
    """Per-decision outputs of ``platform_step``: [R] per step, [R, T]
    once a route's records are stacked."""
    action: torch.Tensor
    start: torch.Tensor
    finish: torch.Tensor
    wait: torch.Tensor
    exec_time: torch.Tensor
    response: torch.Tensor
    ms: torch.Tensor
    energy: torch.Tensor
    met: torch.Tensor     # response <= safety_time (STM hit)
    valid: torch.Tensor   # False for padding tasks: state passed through


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (XLA's order for these rows;
    ``torch.sum`` reassociates and differs in the last bit)."""
    return functools.reduce(operator.add, x.unbind(-1))


def seq_mean(x: torch.Tensor) -> torch.Tensor:
    # jnp.mean multiplies by the f32 reciprocal of the count; so does this
    return seq_sum(x) * (1.0 / x.shape[-1])


def spec_from_platform(platform, device="cpu") -> PlatformSpec:
    """Static tables of an ``HMAIPlatform``, as f32 tensors on ``device``."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    return PlatformSpec(
        exec_time=f32(platform.exec_time_table),
        energy=f32(platform.energy_table),
        gvalue_e_scale=f32(platform.gvalue_e_scale),
        gvalue_t_scale=f32(platform.gvalue_t_scale),
    )


def spec_from_tables(exec_time: np.ndarray, energy: np.ndarray,
                     device="cpu") -> PlatformSpec:
    """A spec from bare tables; the Gvalue scales are the f32 tables'
    means (``jnp.mean``'s order: a left fold times 1/count)."""
    exec_time = torch.as_tensor(np.asarray(exec_time, np.float32),
                                device=device)
    energy = torch.as_tensor(np.asarray(energy, np.float32), device=device)
    return PlatformSpec(exec_time=exec_time, energy=energy,
                        gvalue_e_scale=seq_mean(energy.flatten()),
                        gvalue_t_scale=seq_mean(exec_time.flatten()))


def platform_init(n: int, routes: int = 1, device="cpu") -> PlatformState:
    z = torch.zeros(routes, n, dtype=torch.float32, device=device)
    return PlatformState(
        avail=z, busy=z, E=z, T=z, MS=z, R_Balance=z,
        num_tasks=torch.zeros(routes, n, dtype=torch.int32, device=device),
        e_scale=torch.full((routes,), 1e-9, dtype=torch.float32,
                           device=device),
        t_scale=torch.full((routes,), 1e-9, dtype=torch.float32,
                           device=device),
        alive=torch.ones(routes, n, dtype=torch.bool, device=device),
        cap=torch.ones(routes, n, dtype=torch.float32, device=device),
    )


def state_from_platform(platform, device="cpu") -> PlatformState:
    """Snapshot a live ``HMAIPlatform`` into one route's ``PlatformState``
    ([n] fields, 0-d scales; all cores alive at capacity 1)."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    n = platform.n
    return PlatformState(
        avail=f32(platform.avail), busy=f32(platform.busy),
        E=f32(platform.E), T=f32(platform.T), MS=f32(platform.MS),
        R_Balance=f32(platform.R_Balance),
        num_tasks=torch.tensor(platform.num_tasks, dtype=torch.int32,
                               device=device),
        e_scale=f32(platform._e_scale), t_scale=f32(platform._t_scale),
        alive=torch.ones(n, dtype=torch.bool, device=device),
        cap=torch.ones(n, dtype=torch.float32, device=device),
    )


def state_to_platform(state: PlatformState, platform) -> None:
    """Restore one route's ``PlatformState`` into a live ``HMAIPlatform``
    (the inverse of :func:`state_from_platform`; the platform keeps its
    own ``records``)."""
    f64 = lambda x: x.cpu().numpy().astype(np.float64)  # noqa: E731
    platform.avail = f64(state.avail)
    platform.busy = f64(state.busy)
    platform.E = f64(state.E)
    platform.T = f64(state.T)
    platform.MS = f64(state.MS)
    platform.R_Balance = f64(state.R_Balance)
    platform.num_tasks = state.num_tasks.cpu().numpy().astype(np.int64)
    platform._e_scale = float(state.e_scale)
    platform._t_scale = float(state.t_scale)


def stack_states(states: list) -> PlatformState:
    """Stack single-route states into one [R, ...] batch (the ``state0``
    layout of the batched engines)."""
    return PlatformState(*[torch.stack(f) for f in zip(*states)])


def health_capacity(state: PlatformState) -> torch.Tensor:
    """[R, n] effective capacity: ``cap`` for alive cores, ``HEALTH_FLOOR``
    for dead ones."""
    return torch.where(state.alive, state.cap, 0.0).clamp_min(HEALTH_FLOOR)


def with_health(state: PlatformState, hrow: torch.Tensor) -> PlatformState:
    """Install a health row ([R, n] f32; 0 = dead, (0, 1] = capacity)."""
    return state._replace(alive=hrow > 0.0,
                          cap=torch.where(hrow > 0.0, hrow, 1.0))


def _at(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x[r, a[r]] for every route r."""
    return x.gather(1, a[:, None])[:, 0]


def platform_step(spec: PlatformSpec, state: PlatformState, task: TaskArrays,
                  action: torch.Tensor, valid=None
                  ) -> tuple[PlatformState, StepRecord]:
    """Pure mirror of ``HMAIPlatform.execute`` (§7.2 update formulas) for
    one [R] task row and one [R] action per route.

    Where ``valid`` is False the route's state passes through unchanged
    (padding row) and its record is flagged invalid.
    """
    if valid is None:
        valid = task.valid
    a = action.long()
    kind = task.kind
    eff = _at(health_capacity(state), a)
    et = spec.exec_time[a, kind] / eff
    en = spec.energy[a, kind] / eff
    start = torch.maximum(task.arrival, _at(state.avail, a))
    finish = start + et
    wait = start - task.arrival
    response = finish - task.arrival
    # Matching Score: GOTURN tasks are TRA (step function, Fig 7b), the
    # detectors use the linear DET ramp (Fig 7a)
    met = response <= task.safety
    ms_det = torch.where(met & (task.safety > 0),
                         response / task.safety.clamp_min(1e-12), -1.0)
    ms_tra = met.float() * 2.0 - 1.0
    ms = torch.where(kind == GOTURN_INDEX, ms_tra, ms_det)

    # padding rows select no accelerator, so every per-accelerator field
    # passes through; the two running scales are masked explicitly
    hot = (torch.arange(spec.n, device=a.device) == a[:, None]) \
        & valid[:, None]
    avail = torch.where(hot, finish[:, None], state.avail)
    busy = torch.where(hot, state.busy + et[:, None], state.busy)
    E = torch.where(hot, state.E + en[:, None], state.E)
    T = torch.where(hot, torch.maximum(state.T, finish[:, None]), state.T)
    MS = torch.where(hot, state.MS + ms[:, None], state.MS)
    num_tasks = state.num_tasks + hot.int()
    # paper: R_Balance_i = (r_j + R_Balance_i) / num
    r_j = _at(busy, a) / finish.clamp_min(1e-9)
    n = _at(num_tasks, a).float()
    rb = (r_j + _at(state.R_Balance, a) * (n - 1.0)) / n
    R_Balance = torch.where(hot, rb[:, None], state.R_Balance)
    new = PlatformState(
        avail=avail, busy=busy, E=E, T=T, MS=MS, R_Balance=R_Balance,
        num_tasks=num_tasks,
        e_scale=torch.where(valid, torch.maximum(state.e_scale, seq_sum(E)),
                            state.e_scale),
        t_scale=torch.where(valid, torch.maximum(state.t_scale, T.amax(-1)),
                            state.t_scale),
        alive=state.alive, cap=state.cap,
    )
    rec = StepRecord(action=a, start=start, finish=finish, wait=wait,
                     exec_time=et, response=response, ms=ms, energy=en,
                     met=met, valid=valid)
    return new, rec


def stack_records(recs: list) -> StepRecord:
    """Per-step [R] records -> one [R, T] record."""
    return StepRecord(*[torch.stack(f, dim=1) for f in zip(*recs)])


# ---------------------------------------------------------------------------
# metrics (pure mirrors of the HMAIPlatform properties)
# ---------------------------------------------------------------------------

def gvalue_state(spec: PlatformSpec, state: PlatformState) -> torch.Tensor:
    """[R] Global State Value = (-E - T + R_Balance)/3 after §6.2
    normalization."""
    total_e = seq_sum(state.E)
    makespan = state.T.amax(-1)
    rb = seq_mean(state.R_Balance)
    e_scale = spec.gvalue_e_scale * state.num_tasks.sum(-1).float() \
        .clamp_min(1.0)
    e = total_e / e_scale.clamp_min(1e-12)
    t = makespan / spec.gvalue_t_scale.clamp_min(1e-12)
    return (-e - t + rb) / 3.0


def hw_info_state(state: PlatformState, now: torch.Tensor) -> torch.Tensor:
    """[R, n, 4] HW-Info = (E_i, T_i, R_Balance_i, MS_i), T_i as backlog
    relative to ``now`` ([R])."""
    return torch.stack([
        state.E / state.e_scale.clamp_min(1e-9)[:, None],
        (state.avail - now[:, None]).clamp_min(0.0),
        state.R_Balance,
        state.MS / state.num_tasks.float().clamp_min(1.0),
    ], dim=2)


def state_vector(spec: PlatformSpec, feat_table: torch.Tensor,
                 backlog_scale, state: PlatformState,
                 task: TaskArrays) -> torch.Tensor:
    """[R, 3 + 5n] FlexAI observation: Task-Info + HW-Info + the
    health-effective exec column (slowdown capped at ``OBS_SLOWDOWN_CAP``).
    """
    tf = torch.cat([feat_table[task.kind], task.safety[:, None]], dim=1)
    hw = hw_info_state(state, task.arrival)
    backlog = torch.log1p(hw[..., 1] / backlog_scale)
    slow = (1.0 / health_capacity(state)).clamp_max(OBS_SLOWDOWN_CAP)
    hw = torch.stack([hw[..., 0], backlog, hw[..., 2], hw[..., 3],
                      spec.exec_time.T[task.kind] * slow], dim=2)
    return torch.cat([tf, hw.flatten(1)], dim=1)


def stage_state_vector(spec: PlatformSpec, feat_table: torch.Tensor,
                       backlog_scale, state: PlatformState, task: TaskArrays,
                       *, stage_exec: torch.Tensor, mac_frac: torch.Tensor,
                       group_mask: torch.Tensor,
                       stage_frac) -> torch.Tensor:
    """[R, 4 + 6n] FlexAI observation of a pipeline-stage sub-task.

    Group-local and order-independent: every per-accelerator feature is
    masked to the stage's accelerator group, and energy is normalised by
    the static ``gvalue_e_scale`` times each core's task count, not the
    running ``e_scale`` (a global reduction that would depend on how far
    other stage groups have progressed).  Task-Info scales by the stage's
    MAC fraction ([R]) and appends ``stage_frac`` (an f32 tensor, 0-d or
    [R]);
    HW-Info gains the group-membership flag.  ``stage_exec`` is the
    stage's [n, K] table, or [R, n, K] when routes sit at different
    stages; ``group_mask`` is [n] or [R, n]."""
    r, n = state.avail.shape
    mask = group_mask.float().expand(r, n)
    frac = stage_frac.expand(r)
    tf = torch.cat([feat_table[task.kind] * mac_frac[:, None],
                    task.safety[:, None], frac[:, None]], dim=1)
    nt = state.num_tasks.float().clamp_min(1.0)
    e_norm = state.E / (spec.gvalue_e_scale.clamp_min(1e-12) * nt)
    backlog = torch.log1p((state.avail - task.arrival[:, None])
                          .clamp_min(0.0) / backlog_scale)
    col = (stage_exec.T[task.kind] if stage_exec.dim() == 2 else
           stage_exec.gather(2, task.kind.view(-1, 1, 1).expand(r, n, 1))
           [..., 0])
    ex = col / health_capacity(state) / spec.gvalue_t_scale.clamp_min(1e-12)
    per = torch.stack([e_norm, backlog, state.R_Balance, state.MS / nt, ex,
                       mask], dim=2) * mask[..., None]
    return torch.cat([tf, per.flatten(1)], dim=1)


def route(x, r: int):
    """Route ``r`` of a batched ``PlatformState`` / ``StepRecord``."""
    return type(x)(*[f[r] for f in x])


def summarize(spec: PlatformSpec, state: PlatformState,
              recs: StepRecord) -> dict:
    """Host-side summary of ONE route (state fields [n], records [T]),
    matching ``HMAIPlatform.summary`` keys."""
    state = type(state)(*[f.cpu() for f in state])
    spec = type(spec)(*[f.cpu() for f in spec])
    valid = recs.valid.cpu().numpy().astype(bool)
    n_valid = int(valid.sum())
    met = int(recs.met.cpu().numpy()[valid].sum())
    wait = recs.wait.cpu().numpy()[valid]
    batched = PlatformState(*[f[None] for f in state])
    return {
        "tasks": n_valid,
        "makespan_s": float(state.T.max()),
        "total_energy_j": float(seq_sum(state.E)),
        "r_balance": float(seq_mean(state.R_Balance)),
        "total_ms": float(seq_sum(state.MS)),
        "mean_wait_s": float(wait.mean()) if n_valid else 0.0,
        "stm_rate": met / max(n_valid, 1),
        "gvalue": float(gvalue_state(spec, batched)[0]),
    }


def kind_feature_table() -> np.ndarray:
    """[n_kinds, 2] scaled (Amount, LayerNum) Task-Info features, matching
    ``tasks.task_features``."""
    from repro_torch.core.tasks import _model_stats
    stats = _model_stats()
    return np.asarray(
        [[stats[k.value]["macs"] / 30e9, stats[k.value]["layers"] / 100.0]
         for k in KIND_ORDER], np.float32)
