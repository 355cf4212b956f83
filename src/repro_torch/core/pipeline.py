"""Pipeline parallelism over the heterogeneous platform: the port of the
JAX package's ``core/pipeline.py``.

A route's tasks are cut into ``S`` pipeline stages (MAC-balanced layer
windows of the perception nets), and each stage is placed on its own
group of accelerators:

* ``build_stage_plan``: the stage-construction pass.  Per-stage exec and
  energy tables come from architecture-affinity share profiles (the
  shares sum to 1 over stages, so no core is made faster in aggregate),
  and the cores are split into stage groups by an exact bottleneck search
  over arch-class count compositions.  Host NumPy, equal to the JAX
  package's arrays bit for bit; the plan's tensors live on one device.
* ``_pipeline_segment_run`` / ``make_pipeline_schedule_fn``: the flat
  wavefront.  Step (task k, stage s) runs in column k + s, stages
  descending inside a column, so stage s reads the ring entry stage s-1
  wrote one column earlier: its arrival is that finish plus the
  boundary's reshard latency.  A Python loop over the flat steps, batched
  over routes on a leading axis; each flat step's stage is a host int
  that every route shares, so a stage's tables are a static slice.
* ``make_pipeline_reference_fn``: the unpipelined task-major reference
  (stages unrolled per task), the parity oracle of the flat engine.
* Stage-level FlexAI: the action places a *stage*; the observation
  (``platform.stage_state_vector``, ``4 + 6n``) is group-masked.  The
  trainers mirror ``flexai/engine.py``'s on the flat stream: single lane
  (``td_kernel`` sends an update through the fused kernel's single-lane
  Adam launch), population lanes (one lane-axis Adam launch a step with
  any update) and data-parallel (one lane-axis grads launch, the mean,
  one Adam step).  Exploration draws inside the step's stage group.
  ``PipelineFlexAI`` is the train / schedule / weights surface.

The mesh half (``repro_torch.distributed``, ``launch/mesh.py``):

* ``make_sharded_pipeline_fn``: the wavefront over a 2-D ``("stages",
  "routes")`` mesh.  Each rank is one stage group (a host int, so its
  tables are the flat engine's static slice) over its block of routes;
  it runs all ``T + S - 1`` columns with its own diagonal valid, and
  after each column the finish ring hops to stage s+1
  (``distributed.ring_hop``).  Records and per-stage states come back to
  every rank as [S, R, ...]; ``combine_stage_states`` folds the states
  into the flat engine's final state, bit for bit.
* ``make_sharded_pipeline_train_fn`` (population lanes in blocks over the
  route axis, no collectives but the closing gathers) and
  ``make_pipeline_dp_train_fn(mesh=)`` (one agent; the per-step counts
  exchanged once an episode, one gradient all-reduce an update step).
  Both refuse a mesh whose other axes hold more than one rank: a lane
  would train on each of them.  ``PipelineFlexAI(mesh=)`` trains through
  them; its evaluation, schedule and weights stay unsharded.

Two behaviours of the reference are kept as they are: the greedy
``flexai`` policy passes the raw stage index as ``stage_frac`` where the
trainers pass ``s / S``, and the trainers' greedy arm masks by the group
alone where serving masks by group and alive.
"""
from __future__ import annotations

import functools
import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import distributed as pdist
from repro_torch.core.faults import start_trace
from repro_torch.core.flexai.dqn import (AdamState, DQNParams, adam_apply,
                                         adam_init, dqn_td_update,
                                         load_dqn_npz, qnet_apply,
                                         save_dqn_npz)
from repro_torch.core.flexai.engine import (Draws, TrainState, _dp_cadence,
                                            _flatten, _lane_cadence,
                                            _lane_select, _lanes_of,
                                            _ring_sizes, _unflatten,
                                            dp_train_init, train_init)
from repro_torch.core.flexai.replay import (DeviceReplay,
                                            device_replay_flat_lanes,
                                            device_replay_rows_lanes,
                                            device_replay_sample_lanes,
                                            device_replay_write_lanes)
from repro_torch.core.flexai.reward import reward_from_states
from repro_torch.core.platform import (PlatformSpec, PlatformState,
                                       StepRecord, health_capacity,
                                       kind_feature_table, platform_init,
                                       platform_step, route, seq_sum,
                                       spec_from_platform, stack_records,
                                       stage_state_vector, state_vector,
                                       summarize, with_health)
from repro_torch.core.tasks import (KIND_ORDER, TABLE5_FPS, TaskArrays,
                                    _model_stats, pad_task_arrays,
                                    stack_task_arrays, stage_layer_stats,
                                    tasks_to_arrays)
from repro_torch.kernels.protocol import resolve_device, synchronize

# Cross-stage link bandwidth of the reshard latency model (bytes/s):
# activations are sub-MB, so a boundary hop is tens of microseconds.
DEFAULT_LINK_BYTES_PER_S = 16e9


class StagePlan(NamedTuple):
    """Output of the stage-construction pass, as tensors on one device.

    * ``stage_exec`` / ``stage_energy`` [S, n, K] f32: per-stage views of
      the platform tables (summing over S gives the whole-model tables up
      to rounding: the shares sum to 1 in f64 before the f32 product).
    * ``groups`` [n] i32: accelerator -> stage group.
    * ``group_mask`` [S, n] bool: row s flags stage s's accelerators.
    * ``mac_frac`` [S, K] f32: MAC fraction of stage s for each kind.
    * ``reshard_s`` [S, K] f32: seconds to move kind k's activation over
      the boundary AFTER stage s (the last row is 0).
    """
    stage_exec: torch.Tensor
    stage_energy: torch.Tensor
    groups: torch.Tensor
    group_mask: torch.Tensor
    mac_frac: torch.Tensor
    reshard_s: torch.Tensor

    @property
    def n_stages(self) -> int:
        return self.stage_exec.shape[0]

    @property
    def n(self) -> int:
        return self.stage_exec.shape[1]

    def to(self, device) -> "StagePlan":
        return StagePlan(*[f.to(device) for f in self])


def stage_state_dim(n: int) -> int:
    """Observation width of the stage-placement agent
    (``platform.stage_state_vector``)."""
    return 4 + 6 * n


def _layer_eff(arch: str, layer: dict) -> float:
    """Relative efficiency of ``arch`` on one layer, in (0, 1]: SconvOD is
    strongest on large-spatial early conv, MconvMC on channel-heavy late
    layers, SconvIC neutral.  ``hw`` is a conv layer's output size already;
    the division by the stride is the reference's, kept."""
    hw_out = layer.get("hw", 1) // max(layer.get("stride", 1), 1)
    if arch == "SconvOD":
        return float(np.clip(hw_out / 48.0, 0.25, 1.0))
    if arch == "MconvMC":
        return float(np.clip(layer.get("c_in", 1) / 256.0, 0.30, 1.0))
    return 0.65


@functools.lru_cache(maxsize=32)
def stage_share_table(arch_names: tuple, n_stages: int) -> np.ndarray:
    """[n_accel, S, K] f32 share of each kind's exec time spent in each
    stage, per accelerator: per-layer MACs over the arch's efficiency,
    summed over the stage's layer window (in f64, rows sum to 1)."""
    splits, _, _ = stage_layer_stats(n_stages)
    stats = _model_stats()
    share = np.zeros((len(arch_names), n_stages, len(KIND_ORDER)),
                     np.float32)
    for ai, arch in enumerate(arch_names):
        for ki, kind in enumerate(KIND_ORDER):
            per_layer = stats[kind.value]["per_layer"]
            w = np.asarray([l["macs"] / _layer_eff(arch, l)
                            for l in per_layer], np.float64)
            tot = w.sum()
            for s in range(n_stages):
                lo, hi = int(splits[ki, s]), int(splits[ki, s + 1])
                share[ai, s, ki] = w[lo:hi].sum() / tot
    return share


def assign_stage_groups(arch_names: tuple, stage_exec: np.ndarray,
                        kind_weights: np.ndarray) -> np.ndarray:
    """Bottleneck-optimal partition of the accelerators into stage groups.
    Same-arch cores are interchangeable, so the search enumerates how many
    of each arch class serve each stage; the score is the slowest stage's
    aggregate service rate (sum of 1 / kind-weighted stage time)."""
    n_st = stage_exec.shape[0]
    classes: dict = {}
    for i, nm in enumerate(arch_names):
        classes.setdefault(nm, []).append(i)
    cls_names = sorted(classes)
    w = np.asarray(kind_weights, np.float64)
    tbar = (stage_exec.astype(np.float64) * w[None, None, :]).sum(-1)

    def comps(m: int, k: int):
        if k == 1:
            yield (m,)
            return
        for first in range(m + 1):
            for rest in comps(m - first, k - 1):
                yield (first,) + rest

    best = None
    for combo in itertools.product(
            *[list(comps(len(classes[nm]), n_st)) for nm in cls_names]):
        counts = np.asarray(combo)                       # [n_cls, S]
        if (counts.sum(0) == 0).any():
            continue
        rate = np.zeros(n_st)
        for ci, nm in enumerate(cls_names):
            rate += counts[ci] / tbar[:, classes[nm][0]]
        score = rate.min()
        if best is None or score > best[0]:
            best = (score, counts)
    if best is None:
        raise ValueError(f"cannot form {n_st} non-empty stage groups from "
                         f"{len(arch_names)} accelerators")
    counts = best[1]
    groups = np.zeros(len(arch_names), np.int64)
    for ci, nm in enumerate(cls_names):
        members, off = classes[nm], 0
        for s in range(n_st):
            for _ in range(int(counts[ci, s])):
                groups[members[off]] = s
                off += 1
    return groups.astype(np.int32)


def build_stage_plan(platform, n_stages: int, groups=None,
                     link_bytes_per_s: float = DEFAULT_LINK_BYTES_PER_S,
                     kind_weights=None, device="cpu") -> StagePlan:
    """``HMAIPlatform`` + stage count -> :class:`StagePlan` on ``device``.
    ``groups`` overrides the partition search with an explicit [n]
    stage-id assignment; ``kind_weights`` defaults to the Table-5 frame
    rates' shares."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    arch_names = tuple(s.name for s in platform.specs)
    exec_table = np.asarray(platform.exec_time_table, np.float32)
    energy_table = np.asarray(platform.energy_table, np.float32)
    share = stage_share_table(arch_names, n_stages)      # [n, S, K]
    stage_exec = np.swapaxes(share, 0, 1) * exec_table[None]
    stage_energy = np.swapaxes(share, 0, 1) * energy_table[None]
    if kind_weights is None:
        kw = np.asarray([TABLE5_FPS[k] for k in KIND_ORDER], np.float64)
        kind_weights = kw / kw.sum()
    if groups is None:
        groups = assign_stage_groups(arch_names, stage_exec, kind_weights)
    groups = np.asarray(groups, np.int32)
    if groups.shape != (len(arch_names),):
        raise ValueError(f"groups must be [{len(arch_names)}]")
    present = np.unique(groups)
    if present.min() < 0 or present.max() >= n_stages or \
            len(present) != n_stages:
        raise ValueError(
            f"groups must cover every stage id in [0, {n_stages})")
    _, frac, act = stage_layer_stats(n_stages)           # [K, S] each
    reshard = act.T.astype(np.float32) / float(link_bytes_per_s)
    mask = groups[None, :] == np.arange(n_stages)[:, None]
    return StagePlan(
        stage_exec=torch.as_tensor(stage_exec, device=device),
        stage_energy=torch.as_tensor(stage_energy, device=device),
        groups=torch.as_tensor(groups, device=device),
        group_mask=torch.as_tensor(mask, device=device),
        mac_frac=torch.as_tensor(frac.T.astype(np.float32), device=device),
        reshard_s=torch.as_tensor(reshard, device=device))


def stage_spec(spec: PlatformSpec, plan: StagePlan, s: int) -> PlatformSpec:
    """Stage ``s``'s view of the platform tables: ``platform_step`` runs on
    it unchanged.  The Gvalue scales stay whole-model, so rewards and
    summaries compare across stage counts."""
    return PlatformSpec(exec_time=plan.stage_exec[s],
                        energy=plan.stage_energy[s],
                        gvalue_e_scale=spec.gvalue_e_scale,
                        gvalue_t_scale=spec.gvalue_t_scale)


def _stage_task_view(plan: StagePlan, ring: torch.Tensor, row: TaskArrays,
                     s) -> TaskArrays:
    """Rows ([R]) as their stage-``s`` sub-tasks: the arrival becomes the
    upstream stage's finish (``ring`` [R, S]) plus the boundary's reshard
    latency, and the safety budget shrinks by that delay, so the final
    stage's ``met`` is the end-to-end deadline check.  ``s`` is a host int
    shared by the rows, or an [R] tensor of each row's stage."""
    if isinstance(s, int):
        return _stage_rows(plan, ring[:, s - 1] if s else None, row, s)
    prev = (s - 1).clamp_min(0)
    arrival = torch.where(
        s == 0, row.arrival,
        ring.gather(1, prev[:, None])[:, 0] + plan.reshard_s[prev, row.kind])
    return row._replace(arrival=arrival,
                        safety=row.safety - (arrival - row.arrival))


def _stage_rows(plan: StagePlan, upstream, row: TaskArrays,
                s: int) -> TaskArrays:
    """:func:`_stage_task_view` at host stage ``s`` from ``upstream``
    ([R], stage s-1's finish; unused at s = 0)."""
    arrival = row.arrival if s == 0 else \
        upstream + plan.reshard_s[s - 1][row.kind]
    return row._replace(arrival=arrival,
                        safety=row.safety - (arrival - row.arrival))


# ---------------------------------------------------------------------------
# placement policies (shared by the engines; all group-masked)
# ---------------------------------------------------------------------------

def _make_policy(policy: str, spec: PlatformSpec, plan: StagePlan,
                 backlog_scale: float):
    """``act(params, state, trow, s) -> [R] actions`` at host stage ``s``.

    * ``"eft"``: earliest health-effective finish time within the stage
      group (params ignored).
    * ``"flexai"``: greedy stage-placement Q argmax over the group's live
      cores (the whole group if all are down); ``stage_frac`` is the raw
      stage index, as in the reference's greedy policy.
    * ``"task"``: the task-level observation and alive-masked argmax of
      the greedy scheduler; with a 1-stage plan the pipeline engines then
      reproduce ``flexai.engine.make_schedule_fn``.
    """
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)
    index = torch.arange(plan.n_stages, dtype=torch.float32,
                         device=spec.device)
    neg = float("-inf")

    if policy == "eft":
        def act(params, state, trow, s):
            ct = torch.maximum(trow.arrival[:, None], state.avail) \
                + plan.stage_exec[s].T[trow.kind] / health_capacity(state)
            return ct.masked_fill(~plan.group_mask[s],
                                  float("inf")).argmin(-1)
    elif policy == "flexai":
        def act(params, state, trow, s):
            gm = plan.group_mask[s]
            sv = stage_state_vector(
                spec, feat, backlog_scale, state, trow,
                stage_exec=plan.stage_exec[s],
                mac_frac=plan.mac_frac[s][trow.kind], group_mask=gm,
                stage_frac=index[s])
            live = gm & state.alive
            live = torch.where(live.any(-1, keepdim=True), live, gm)
            return qnet_apply(params, sv).masked_fill(~live, neg).argmax(-1)
    elif policy == "task":
        def act(params, state, trow, s):
            sv = state_vector(spec, feat, backlog_scale, state, trow)
            alive = state.alive | ~state.alive.any(-1, keepdim=True)
            return qnet_apply(params, sv).masked_fill(~alive,
                                                      neg).argmax(-1)
    else:
        raise ValueError(f"unknown pipeline policy {policy!r}")
    return act


def _stage_obs(spec, plan, feat, fracs, backlog_scale, state, ring, row,
               s):
    """The stage observation of the training paths, ``stage_frac`` =
    ``fracs[s]`` = s / S.  ``s`` is a host int or an [R] tensor."""
    trow = _stage_task_view(plan, ring, row, s)
    frac_s = (plan.mac_frac[s][row.kind] if isinstance(s, int)
              else plan.mac_frac[s, row.kind])
    return stage_state_vector(spec, feat, backlog_scale, state, trow,
                              stage_exec=plan.stage_exec[s],
                              mac_frac=frac_s,
                              group_mask=plan.group_mask[s],
                              stage_frac=fracs[s])


# ---------------------------------------------------------------------------
# wavefront stream layout
# ---------------------------------------------------------------------------

def _wavefront_index(t_len: int, n_st: int):
    """Host ``(k_seq, s_seq)`` of the [(T + S - 1) * S] flat stream:
    column c holds steps (k = c - s, s), stages descending."""
    cols = t_len + n_st - 1
    s_seq = np.tile(np.arange(n_st - 1, -1, -1), cols)
    k_seq = np.repeat(np.arange(cols), n_st) - s_seq
    return k_seq, s_seq


def _wavefront_stream(tasks: TaskArrays, n_st: int):
    """Flatten routes ([..., T]) into the wavefront stream ([..., (T + S -
    1) * S]) and its host stage sequence.  Out-of-range corners become
    invalid rows (clip-gathered; the state passes through)."""
    t_len = tasks.arrival.shape[-1]
    k_seq, s_seq = _wavefront_index(t_len, n_st)
    idx = torch.as_tensor(np.clip(k_seq, 0, t_len - 1),
                          device=tasks.arrival.device)
    ok = torch.as_tensor((k_seq >= 0) & (k_seq < t_len),
                         device=tasks.arrival.device)
    rows = TaskArrays(*[f[..., idx] for f in tasks])
    return rows._replace(valid=rows.valid & ok), s_seq


def _record_order(t_len: int, n_st: int) -> np.ndarray:
    """[T, S] indices mapping the flat record stream back to task-major
    ``recs[k, s]`` (step (k, s) ran at flat position (k + s) S + S-1-s)."""
    k = np.arange(t_len)[:, None]
    s = np.arange(n_st)[None, :]
    return (k + s) * n_st + (n_st - 1 - s)


def _task_major(recs: StepRecord, t_len: int, n_st: int) -> StepRecord:
    """[R, flat] records -> [R, T, S]."""
    order = torch.as_tensor(_record_order(t_len, n_st).reshape(-1),
                            device=recs.action.device)
    return StepRecord(*[f[:, order].reshape(f.shape[0], t_len, n_st)
                        for f in recs])


# ---------------------------------------------------------------------------
# inference engines
# ---------------------------------------------------------------------------

def _pipeline_segment_run(spec: PlatformSpec, plan: StagePlan,
                          backlog_scale: float = 1.0,
                          policy: str = "flexai"):
    """The runner over a flattened wavefront segment, the serving seam:
    ``run(params, rows [R, L], s_seq [L], state0=None, ring0=None,
    health=None) -> (state, ring [R, S], records [R, L])``.  QoS waves cut
    the flat stream into segments and checkpoint ``(state, ring)``
    between them.  ``params`` are shared or carry a lane axis (one net a
    route); ``health`` [R, L, n] is already in flat order."""
    act = _make_policy(policy, spec, plan, backlog_scale)
    specs = [stage_spec(spec, plan, s) for s in range(plan.n_stages)]

    def run(params, rows: TaskArrays, s_seq, state0=None, ring0=None,
            health=None):
        dev = spec.device
        rows = rows.to(dev)
        r = rows.arrival.shape[0]
        state, health = start_trace(
            platform_init(spec.n, r, dev) if state0 is None else state0,
            health, dev)
        ring = (torch.zeros(r, plan.n_stages, device=dev) if ring0 is None
                else ring0.to(dev).clone())
        recs = []
        for i, s in enumerate(np.asarray(s_seq).tolist()):
            row = rows.step(i)
            if health is not None:
                # health rows are indexed by task: every stage of task k
                # installs row k before acting
                state = with_health(state, health[:, i])
            trow = _stage_task_view(plan, ring, row, s)
            state, rec = platform_step(specs[s], state, trow,
                                       act(params, state, trow, s))
            ring[:, s] = torch.where(row.valid, rec.finish, ring[:, s])
            recs.append(rec)
        return state, ring, stack_records(recs)

    return run


def _pipeline_run(spec: PlatformSpec, plan: StagePlan,
                  backlog_scale: float = 1.0, policy: str = "flexai"):
    """A whole-route wavefront episode over a batch: flatten, run,
    regather.  ``run(params, tasks [R, T], state0=None, ring0=None,
    health=None [R, T, n]) -> (final, ring, records [R, T, S])``."""
    seg = _pipeline_segment_run(spec, plan, backlog_scale, policy)
    n_st = plan.n_stages

    def run(params, tasks: TaskArrays, state0=None, ring0=None,
            health=None):
        t_len = tasks.arrival.shape[-1]
        rows, s_seq = _wavefront_stream(tasks.to(spec.device), n_st)
        if health is not None:
            # the [R, T, n] task-indexed trace in flat order (corner rows
            # are clip-gathered like the tasks)
            k_seq, _ = _wavefront_index(t_len, n_st)
            idx = torch.as_tensor(np.clip(k_seq, 0, t_len - 1),
                                  device=spec.device)
            health = torch.as_tensor(health, dtype=torch.float32,
                                     device=spec.device)[:, idx]
        final, ring, recs = seg(params, rows, s_seq, state0, ring0, health)
        return final, ring, _task_major(recs, t_len, n_st)

    return run


def _single_route(run):
    """A batched ``run(params, tasks [R, T], **kw)`` as a one-route
    function: tasks [T], ``state0`` [n], ``ring0`` [S], ``health`` [T,
    n], records [T, S]."""
    def single(params, tasks, **kw):
        tasks = TaskArrays(*[f[None] for f in tasks])
        kw = {k: v for k, v in kw.items() if v is not None}
        if "state0" in kw:
            kw["state0"] = type(kw["state0"])(*[f[None] for f in kw["state0"]])
        for k in ("ring0", "health"):
            if k in kw:
                kw[k] = torch.as_tensor(kw[k])[None]
        final, ring, recs = run(params, tasks, **kw)
        return route(final, 0), ring[0], route(recs, 0)

    return single


def make_pipeline_schedule_fn(spec: PlatformSpec, plan: StagePlan,
                              backlog_scale: float = 1.0,
                              policy: str = "flexai",
                              batched: bool = False):
    """The flat wavefront scheduler: ``fn(params, tasks, state0=None,
    ring0=None, health=None) -> (final_state, ring, records)``, one route
    ([T]; records [T, S]) or with ``batched=True`` a route batch ([R, T];
    params shared, or one net a route)."""
    run = _pipeline_run(spec, plan, backlog_scale, policy)
    return run if batched else _single_route(run)


def _pipeline_reference_run(spec: PlatformSpec, plan: StagePlan,
                            backlog_scale: float = 1.0,
                            policy: str = "flexai"):
    """Unpipelined task-major reference: every task runs all S stages
    before the next starts.  Each group commits in the same order as in
    the wavefront, so states and records equal the flat engine's."""
    act = _make_policy(policy, spec, plan, backlog_scale)
    specs = [stage_spec(spec, plan, s) for s in range(plan.n_stages)]

    def run(params, tasks: TaskArrays, health=None):
        dev = spec.device
        tasks = tasks.to(dev)
        r, t_len = tasks.arrival.shape
        state, health = start_trace(platform_init(spec.n, r, dev), health,
                                    dev)
        ring = torch.zeros(r, plan.n_stages, device=dev)
        recs = []
        for t in range(t_len):
            row = tasks.step(t)
            if health is not None:
                state = with_health(state, health[:, t])
            for s in range(plan.n_stages):
                trow = _stage_task_view(plan, ring, row, s)
                state, rec = platform_step(specs[s], state, trow,
                                           act(params, state, trow, s))
                ring[:, s] = torch.where(row.valid, rec.finish, ring[:, s])
                recs.append(rec)
        recs = stack_records(recs)
        return state, ring, StepRecord(*[
            f.reshape(r, t_len, plan.n_stages) for f in recs])

    return run


def make_pipeline_reference_fn(spec: PlatformSpec, plan: StagePlan,
                               backlog_scale: float = 1.0,
                               policy: str = "flexai",
                               batched: bool = False):
    """The task-major reference: ``fn(params, tasks, health=None) ->
    (final_state, ring, records)``, one route or a batch as
    :func:`make_pipeline_schedule_fn`."""
    run = _pipeline_reference_run(spec, plan, backlog_scale, policy)
    return run if batched else _single_route(run)


def _lead(x):
    """A leading axis of one on every tensor of ``x``."""
    return type(x)(*[f[None] for f in x]) if isinstance(x, tuple) \
        else x[None]


def make_sharded_pipeline_fn(spec: PlatformSpec, plan: StagePlan, mesh,
                             backlog_scale: float = 1.0,
                             policy: str = "flexai",
                             stage_axis: str = "stages",
                             route_axis: str = pdist.AXIS):
    """The stage-sharded wavefront over a 2-D ``(stage_axis,
    route_axis)`` mesh: ``fn(params, tasks [R, T]) -> (states [S, R,
    ...], ring [S, R], recs [S, R, T])`` on every rank, where ``recs[s,
    r, k]`` equals the flat engine's ``recs[r][k, s]`` bit for bit and
    :func:`combine_stage_states` folds ``states`` into its final state.

    Each rank runs stage ``s`` (its index on ``stage_axis``, a host int)
    over its block of routes (R a multiple of the route axis:
    ``tasks.pad_route_batch``), with its own platform state: the policies
    and observations are group-local, so a stage reads nothing of the
    other groups.  It walks the ``T + S - 1`` wavefront columns and steps
    at ``k = c - s`` where ``0 <= k < T``; after each column but the last
    its finish ring goes to stage s+1 (``distributed.ring_hop``), whose
    arrivals are that finish plus the boundary's reshard latency.
    ``fn.stats`` counts the last call's ``columns``, ``hops`` and the
    hops' ``host_copies`` on this rank."""
    n_st = plan.n_stages
    if pdist.mesh_size(mesh, stage_axis) != n_st:
        raise ValueError(
            f"mesh axis {stage_axis!r} has size "
            f"{pdist.mesh_size(mesh, stage_axis)}, plan has {n_st} stages")
    act = _make_policy(policy, spec, plan, backlog_scale)
    s = pdist.mesh_rank(mesh, stage_axis)
    sp = stage_spec(spec, plan, s)

    def gather(x):
        x = pdist.all_gather(x, mesh, route_axis)
        return pdist.all_gather(_lead(x), mesh, stage_axis)

    def run(params, tasks: TaskArrays):
        dev = spec.device
        blk = pdist.local_block(mesh, tasks.arrival.shape[0], "routes",
                                route_axis)
        tasks = TaskArrays(*[f[blk] for f in tasks]).to(dev)
        r, t_len = tasks.arrival.shape
        cols = t_len + n_st - 1
        run.stats = {"columns": cols, "hops": 0, "host_copies": 0}
        state = platform_init(spec.n, r, dev)
        ring = torch.zeros(r, device=dev)
        upstream = torch.zeros(r, device=dev)
        recs = []
        for c in range(cols):
            if 0 <= c - s < t_len:
                row = tasks.step(c - s)
                trow = _stage_rows(plan, upstream, row, s)
                state, rec = platform_step(sp, state, trow,
                                           act(params, state, trow, s))
                ring = torch.where(row.valid, rec.finish, ring)
                recs.append(rec)
            if n_st > 1 and c + 1 < cols:
                upstream = pdist.ring_hop(ring, mesh, stage_axis, run.stats)
        return gather(state), gather(ring), gather(stack_records(recs))

    run.stats = {}
    return run


def combine_stage_states(plan: StagePlan, states: PlatformState
                         ) -> PlatformState:
    """Fold per-stage states ([S, ...], a route axis optional after S)
    into the global platform state: accelerator i's row comes from its
    own group's stage, and the running scales are recomputed from the
    folded totals (the flat engine's are running maxima of the same
    monotone totals, so they are equal)."""
    idx = torch.arange(plan.n, device=states.E.device)
    groups = plan.groups.long().to(states.E.device)

    def pick(a):
        return a.movedim(0, -1)[..., idx, groups]

    E, T = pick(states.E), pick(states.T)
    return PlatformState(
        avail=pick(states.avail), busy=pick(states.busy), E=E, T=T,
        MS=pick(states.MS), R_Balance=pick(states.R_Balance),
        num_tasks=pick(states.num_tasks),
        e_scale=seq_sum(E).clamp_min(1e-9),
        t_scale=T.amax(-1).clamp_min(1e-9),
        alive=pick(states.alive), cap=pick(states.cap))


def pipeline_summarize(spec: PlatformSpec, state, recs: StepRecord) -> dict:
    """Summary of one route from its [T, S] stage records: the end-to-end
    verdicts (met, response, wait) are the final stage's, whose safety
    budget already absorbed every upstream delay."""
    summ = summarize(spec, state, StepRecord(*[f[..., -1] for f in recs]))
    summ["stages"] = int(recs.valid.shape[-1])
    return summ


# ---------------------------------------------------------------------------
# stage-level FlexAI training
# ---------------------------------------------------------------------------

def _next_valid_flat(valid: np.ndarray):
    """Per flat step i ([..., L] host bools): the index of the next valid
    step (> i), or i itself with ``done`` where none remains.  The state
    and ring do not change over the skipped invalid corners, so the next
    observation is built from the current post-step state."""
    n = valid.shape[-1]
    ar = np.arange(n)
    pos = np.where(valid, ar, n)
    suff = np.minimum.accumulate(pos[..., ::-1], axis=-1)[..., ::-1]
    nv = np.concatenate([suff[..., 1:],
                         np.full(valid.shape[:-1] + (1,), n)], axis=-1)
    done = valid & (nv >= n)
    return np.where(nv >= n, ar, nv), done


def _stage_draws(gen: torch.Generator, size: np.ndarray, s_seq: np.ndarray,
                 groups: np.ndarray, batch_size: int, device) -> Draws:
    """One episode of draws ([L, flat] steps) from ``gen``: the random
    action of a step is uniform over the step's stage group."""
    shape = size.shape
    n_st = int(groups.max()) + 1
    members = np.zeros((n_st, len(groups)), np.int64)
    count = np.zeros(n_st, np.int64)
    for s in range(n_st):
        m = np.nonzero(groups == s)[0]
        members[s, :len(m)], count[s] = m, len(m)
    u = torch.rand(shape, generator=gen, device=device)
    pick = torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float64)
    cnt = torch.as_tensor(count[s_seq], device=device)
    j = torch.minimum((pick * cnt).long(), cnt - 1)
    act = torch.as_tensor(members, device=device)[
        torch.as_tensor(s_seq, device=device), j]
    smp = torch.rand(*shape, batch_size, generator=gen, device=device,
                     dtype=torch.float64)
    n = torch.as_tensor(np.maximum(size, 1), device=device)[..., None]
    return Draws(u, act, torch.minimum((smp * n).long(), n - 1))


def _lane_draws(gen: torch.Generator, tasks: TaskArrays,
                replay: DeviceReplay, n_st: int, groups: np.ndarray,
                batch_size: int, device) -> Draws:
    """The default draws of every lane of ``tasks`` [L, T] (a stack of
    rings): drawn for all L lanes on every rank of a mesh, each rank
    then taking its block, so the blocks equal the unsharded draws."""
    valid = _wavefront_stream(tasks, n_st)[0].valid.cpu().numpy()
    _, s_seq = _wavefront_index(tasks.arrival.shape[-1], n_st)
    return _stage_draws(gen, _ring_sizes(valid, replay.size,
                                         replay.capacity),
                        s_seq, groups, batch_size, device)


def _route_axis_only(mesh, axis: str) -> None:
    """The stage trainers split lanes over ``axis`` alone: refuse a mesh
    whose other axes (a stage axis) hold more than one rank, where each
    lane would train once on each of them."""
    k = mesh.mesh.numel() // pdist.mesh_size(mesh, axis)
    if k > 1:
        raise ValueError(
            f"the stage trainers split lanes over the route axis {axis!r} "
            f"only; this mesh {tuple(mesh.mesh_dim_names)} has {k} ranks at "
            f"each route index (use a mesh whose stage axis is 1)")


def _as_lanes(replay: DeviceReplay) -> DeviceReplay:
    """One ring as a stack of one (views: writes land in the ring)."""
    return DeviceReplay(*[f[None] for f in replay[:5]],
                        ptr=np.array([replay.ptr]),
                        size=np.array([replay.size]))


def _pipeline_train_run(spec: PlatformSpec, plan: StagePlan, cfg,
                        mode: str = "single", lanes: int = 1,
                        td_kernel: bool = False, mesh=None,
                        axis: str = pdist.AXIS):
    """The stage-placement training episode on the flat wavefront stream,
    ``mode`` one of:

    * ``"single"``: one lane, ``flexai.engine.make_train_fn``'s contract on
      one route [T]: ``fn(ts, tasks, draws=None) -> (ts, platform_state,
      records [T, S], losses [flat], update_mask [flat])``; with
      ``td_kernel`` an update is one single-lane launch of the fused
      kernel's Adam variant.
    * ``"population"``: independent lanes (``train_init(lanes=L)``, tasks
      [L, T]); each lane's own cadence, one lane-axis Adam launch a step
      in which any lane updates, lanes that do not update keep their
      params.  Outputs carry the [L] axis.
    * ``"dp"``: ONE agent over ``lanes`` routes (``dp_train_init``): a
      lane-axis grads launch with the nets shared, the mean, one Adam
      step; ``engine._dp_cadence``'s update-every crossing and min-fill
      gate.  Losses and update mask are [flat].  With ``mesh`` each rank
      runs its block of the lanes along ``axis``: the cadence's per-step
      counts are exchanged once, the averaged loss and gradients are
      all-reduced on update steps only, and the rings, platform states
      and records come back whole to every rank.

    Epsilon-greedy: the greedy arm is the Q argmax masked to the step's
    stage group (group only, as the reference's trainers); exploration is
    uniform inside the group (``Draws.action`` holds group members).  The
    next observation reads the next valid flat step of the lane, whose
    stage differs per lane when lanes are padded differently."""
    feat = torch.as_tensor(kind_feature_table(), device=spec.device)
    n_st = plan.n_stages
    # s / S divided on the host: a CUDA division by a scalar multiplies
    # by its reciprocal, which may round differently
    fracs = torch.as_tensor(np.arange(n_st, dtype=np.float32)
                            / np.float32(n_st), device=spec.device)
    specs = [stage_spec(spec, plan, s) for s in range(n_st)]
    groups = plan.groups.cpu().numpy()
    if mode == "single":
        td = dqn_td_update
        if td_kernel:
            from repro_torch.kernels.dqn_update import dqn_td_update_fused
            td = dqn_td_update_fused
    elif mode == "population":
        from repro_torch.kernels.dqn_update import (dqn_td_update_lanes,
                                                    dqn_td_update_lanes_ref)
        td = dqn_td_update_lanes if td_kernel else dqn_td_update_lanes_ref
    elif mode == "dp":
        from repro_torch.kernels.dqn_update import (dqn_td_grads_lanes,
                                                    dqn_td_grads_lanes_ref)
        td = dqn_td_grads_lanes if td_kernel else dqn_td_grads_lanes_ref
    else:
        raise ValueError(f"unknown training mode {mode!r}")

    def run(ts: TrainState, tasks: TaskArrays, draws: Draws | None = None):
        dev = spec.device
        single = mode == "single"
        if single:
            tasks = TaskArrays(*[f[None] for f in tasks])
            if draws is not None:
                draws = Draws(*[d[None] for d in draws])
        tasks = tasks.to(dev)
        n_lanes, t_len = tasks.arrival.shape
        if mode == "dp" and n_lanes != lanes:
            raise ValueError(f"expected a [{lanes}, T] route batch, got "
                             f"{tuple(tasks.arrival.shape)}")
        replay = _as_lanes(ts.replay) if single else ts.replay
        if mesh is not None:
            blk = pdist.local_block(mesh, n_lanes, axis=axis)
            if draws is None:
                draws = _lane_draws(ts.generator, tasks, replay, n_st,
                                    groups, cfg.batch_size, dev)
            draws = Draws(*[d[blk] for d in draws])
            tasks = TaskArrays(*[f[blk] for f in tasks])
            replay = _lanes_of(replay, blk)
            n_lanes = tasks.arrival.shape[0]
        rows, s_seq = _wavefront_stream(tasks, n_st)
        valid = rows.valid.cpu().numpy()
        flat = valid.shape[1]
        nv, done = _next_valid_flat(valid)
        ns = s_seq[nv]                                       # [L, flat]
        ns_dev = torch.as_tensor(ns, device=dev)
        nv_dev = torch.as_tensor(nv, device=dev)
        nrows = TaskArrays(*[f.gather(1, nv_dev) for f in rows])
        shared_ns = (ns == ns[:1]).all(0)
        if mode == "dp":
            cad = _dp_cadence(cfg, valid, ts._replace(replay=replay), mesh,
                              axis)
            eps, sizes = cad.eps[None], cad.size
            do_update, sync = cad.do_update[None], cad.sync[None]
            env_steps, updates = cad.env_steps, cad.updates
        else:
            env0 = np.atleast_1d(ts.env_steps)
            upd0 = np.atleast_1d(ts.updates)
            cads = [_lane_cadence(cfg, valid[i], int(env0[i]),
                                  int(replay.size[i]), int(upd0[i]),
                                  replay.capacity) for i in range(n_lanes)]
            eps = np.stack([c.eps for c in cads])
            sizes = np.stack([c.size for c in cads])
            do_update = np.stack([c.do_update for c in cads])
            sync = np.stack([c.sync for c in cads])
            env_steps = np.array([c.env_steps for c in cads])
            updates = np.array([c.updates for c in cads])
        if draws is None:
            draws = _stage_draws(ts.generator, sizes, s_seq, groups,
                                 cfg.batch_size, dev)
        else:
            draws = Draws(*[d.to(dev) for d in draws])
        explore = draws.explore_u < torch.as_tensor(eps, device=dev)
        sample = device_replay_flat_lanes(replay, draws.sample_idx)
        w_rows, replay_after = device_replay_rows_lanes(replay, valid)
        w_rows = torch.as_tensor(w_rows, device=dev)
        done_dev = torch.as_tensor(done, dtype=torch.float32, device=dev)
        upd_any = do_update.any(0)
        upd_dev = torch.as_tensor(do_update, device=dev)
        sync_dev = torch.as_tensor(sync, device=dev)
        eval_p, targ_p, opt = ts.eval_p, ts.targ_p, ts.opt
        plat = platform_init(spec.n, n_lanes, dev)
        ring = torch.zeros(n_lanes, n_st, device=dev)
        sv = _stage_obs(spec, plan, feat, fracs, cfg.backlog_scale, plat,
                        ring, rows.step(0), int(s_seq[0]))
        losses = torch.zeros(do_update.shape[0], flat, device=dev)
        recs = []
        for i, s in enumerate(s_seq.tolist()):
            greedy = qnet_apply(eval_p, sv).masked_fill(
                ~plan.group_mask[s], float("-inf")).argmax(-1)
            action = torch.where(explore[:, i], draws.action[:, i], greedy)
            row = rows.step(i)
            trow = _stage_task_view(plan, ring, row, s)
            plat2, rec = platform_step(specs[s], plat, trow, action)
            ring[:, s] = torch.where(row.valid, rec.finish, ring[:, s])
            reward = reward_from_states(spec, plat, plat2)
            nxt = int(ns[0, i]) if shared_ns[i] else ns_dev[:, i]
            nsv = _stage_obs(spec, plan, feat, fracs, cfg.backlog_scale,
                             plat2, ring, nrows.step(i), nxt)
            device_replay_write_lanes(replay, w_rows[:, i], sv, action,
                                      reward, nsv, done_dev[:, i])
            if upd_any[i]:
                batch = device_replay_sample_lanes(replay, sample[:, i])
                if single:
                    new_p, opt, loss = td(
                        eval_p, targ_p, opt, {k: v[0] for k, v in
                                              batch.items()},
                        gamma=cfg.gamma, lr=cfg.lr)
                    losses[0, i] = loss
                    if sync[0, i]:
                        targ_p = new_p
                    eval_p = new_p
                elif mode == "population":
                    new_p, new_opt, loss = td(eval_p, targ_p, opt, batch,
                                              gamma=cfg.gamma, lr=cfg.lr)
                    if do_update[:, i].all():
                        eval_p, opt, losses[:, i] = new_p, new_opt, loss
                    else:
                        m = upd_dev[:, i]
                        eval_p = _lane_select(m, new_p, eval_p)
                        opt = AdamState(
                            torch.where(m, new_opt.step, opt.step),
                            _lane_select(m, new_opt.mu, opt.mu),
                            _lane_select(m, new_opt.nu, opt.nu))
                        losses[:, i] = torch.where(m, loss, 0.0)
                    if sync[:, i].any():
                        targ_p = _lane_select(sync_dev[:, i], eval_p,
                                              targ_p)
                else:
                    lane_loss, grads = td(eval_p, targ_p, batch,
                                          gamma=cfg.gamma)
                    flat_g = _flatten([lane_loss.mean()[None],
                                       *[g.mean(0) for g in grads]])
                    if mesh is not None:
                        flat_g = pdist.pmean(flat_g, mesh, axis)
                    loss, *g = _unflatten(flat_g, [lane_loss[:1], *eval_p])
                    eval_p, opt = adam_apply(eval_p, opt, DQNParams(*g),
                                             lr=cfg.lr)
                    losses[0, i] = loss[0]
                    if sync[0, i]:
                        targ_p = eval_p
            recs.append(rec)
            plat, sv = plat2, nsv
        recs = _task_major(stack_records(recs), t_len, n_st)
        upd_mask = torch.from_numpy(do_update)
        if single:
            replay_after = ts.replay._replace(ptr=int(replay_after.ptr[0]),
                                              size=int(replay_after.size[0]))
            ts = TrainState(eval_p, targ_p, opt, replay_after,
                            int(env_steps[0]), int(updates[0]), ts.generator)
            return ts, route(plat, 0), route(recs, 0), losses[0], upd_mask[0]
        if mesh is not None:
            replay_after, plat, recs = pdist.all_gather(
                (replay_after, plat, recs), mesh, axis)
        ts = TrainState(eval_p, targ_p, opt, replay_after, env_steps,
                        updates, ts.generator)
        if mode == "dp":
            return ts, plat, recs, losses[0], upd_mask[0]
        return ts, plat, recs, losses, upd_mask

    return run


def make_pipeline_train_fn(spec: PlatformSpec, plan: StagePlan, cfg,
                           batched: bool = False, td_kernel: bool = False):
    """The stage-placement trainer: one lane, or with ``batched=True``
    independent population lanes (the state of ``train_init(lanes=L)``,
    tasks [L, T], draws with a leading [L] axis)."""
    return _pipeline_train_run(spec, plan, cfg,
                               "population" if batched else "single",
                               td_kernel=td_kernel)


def make_sharded_pipeline_train_fn(spec: PlatformSpec, plan: StagePlan,
                                   cfg, mesh, axis: str = pdist.AXIS,
                                   td_kernel: bool = False):
    """Population stage training over ``mesh``'s ``axis``: ``fn(ts,
    tasks [L, T], draws=None)`` as ``make_pipeline_train_fn(batched=
    True)``, with every lane on every rank.  Each rank trains its
    contiguous block of lanes (L a multiple of the axis); lanes never
    communicate, so the only collectives are the closing gathers.
    Default draws are drawn for all L lanes on every rank and each rank
    takes its block, so the result equals the unsharded population's."""
    _route_axis_only(mesh, axis)
    run = _pipeline_train_run(spec, plan, cfg, "population",
                              td_kernel=td_kernel)
    groups = plan.groups.cpu().numpy()

    def sharded(ts: TrainState, tasks: TaskArrays,
                draws: Draws | None = None):
        blk = pdist.local_block(mesh, tasks.arrival.shape[0], axis=axis)
        if draws is None:
            draws = _lane_draws(ts.generator, tasks.to(spec.device),
                                ts.replay, plan.n_stages, groups,
                                cfg.batch_size, spec.device)
        local = _lanes_of(ts._replace(generator=None), blk)
        out = run(local._replace(generator=ts.generator),
                  TaskArrays(*[f[blk] for f in tasks]),
                  Draws(*[d[blk] for d in draws]))
        gathered = pdist.all_gather(
            (out[0]._replace(generator=None),) + out[1:], mesh, axis)
        return (gathered[0]._replace(generator=ts.generator),) \
            + tuple(gathered[1:])

    return sharded


def make_pipeline_dp_train_fn(spec: PlatformSpec, plan: StagePlan, cfg,
                              lanes: int, mesh=None, td_kernel: bool = False,
                              axis: str = pdist.AXIS):
    """The data-parallel stage trainer: ``fn(ts, tasks [lanes, T],
    draws=None)`` with ``ts`` from ``dp_train_init``; lane 0 takes the
    draws' first row as the single-lane trainer does.  With ``mesh`` the
    lanes split over its ``axis`` (``lanes`` a multiple of that axis
    alone, whose ranks must be the whole mesh)."""
    if mesh is not None:
        _route_axis_only(mesh, axis)
        n = pdist.mesh_size(mesh, axis)
        if lanes < 1 or lanes % n:
            raise ValueError(f"lanes={lanes} must be a positive multiple "
                             f"of the route axis {axis!r} size {n}")
    return _pipeline_train_run(spec, plan, cfg, "dp", lanes, td_kernel,
                               mesh, axis)


# ---------------------------------------------------------------------------
# host-side wrapper
# ---------------------------------------------------------------------------

class PipelineFlexAI:
    """Stage-placement FlexAI on the wavefront engines: ``ScanFlexAI``'s
    train / schedule / weights surface where an action places a *stage*
    on its accelerator group.  Single lane (default), ``lanes > 1``
    population agents, or ``dp=True`` for one agent trained
    data-parallel over a lane batch.  With ``mesh`` the population
    (``lanes >= 2``, a multiple of the mesh's route axis, its last) or
    the DP lanes split over that axis
    (``make_sharded_pipeline_train_fn``, ``make_pipeline_dp_train_fn(
    mesh=)``); evaluation, ``schedule`` and the weights stay unsharded.
    ``td_kernel`` sends every TD update through the fused kernel.  Runs
    on the card unless ``device="cpu"``.
    """

    def __init__(self, platform, cfg, n_stages: int = 2, lanes: int = 1,
                 mesh=None, dp: bool = False, plan: StagePlan = None,
                 td_kernel: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec_from_platform(platform, self.device)
        self.plan = (build_stage_plan(platform, n_stages) if plan is None
                     else plan).to(self.device)
        self.n_stages = self.plan.n_stages
        self.n_actions = platform.n
        self.state_dim = stage_state_dim(platform.n)
        self.lanes = lanes
        self.mesh = mesh
        self.dp = dp
        self.td_kernel = td_kernel
        axis = None if mesh is None else mesh.mesh_dim_names[-1]
        args = (self.state_dim, self.n_actions, cfg.replay_capacity)
        if dp:
            self.ts = dp_train_init(*args, lanes, seed=cfg.seed,
                                    device=self.device)
            self._train_fn = make_pipeline_dp_train_fn(
                self.spec, self.plan, cfg, lanes, mesh=mesh,
                td_kernel=td_kernel, axis=axis)
        elif mesh is not None:
            n = pdist.mesh_size(mesh, axis)
            if lanes < 2 or lanes % n:
                raise ValueError(
                    f"lanes={lanes} must be >= 2 and a multiple of the "
                    f"mesh size {n} (omit mesh for single-lane)")
            self.ts = train_init(*args, seed=cfg.seed, device=self.device,
                                 lanes=lanes)
            self._train_fn = make_sharded_pipeline_train_fn(
                self.spec, self.plan, cfg, mesh, axis, td_kernel)
        else:
            self.ts = train_init(*args, seed=cfg.seed, device=self.device,
                                 lanes=None if lanes == 1 else lanes)
            self._train_fn = make_pipeline_train_fn(
                self.spec, self.plan, cfg, batched=lanes > 1,
                td_kernel=td_kernel)
        self._sched_fn = make_pipeline_schedule_fn(self.spec, self.plan,
                                                   cfg.backlog_scale)
        self._lanes_fn = make_pipeline_schedule_fn(
            self.spec, self.plan, cfg.backlog_scale, batched=True)
        self.losses: list[float] = []
        self.best_eval_stm: float | None = None
        self._best_stm: float = -1.0
        self._best_params: DQNParams | None = None

    @property
    def _population(self) -> bool:
        return not self.dp and self.lanes > 1

    @staticmethod
    def _as_arrays(tasks) -> TaskArrays:
        return tasks if isinstance(tasks, TaskArrays) else \
            tasks_to_arrays(tasks)

    def _lane_summaries(self, plat, recs) -> list:
        plat = type(plat)(*[f.cpu() for f in plat])
        recs = type(recs)(*[f.cpu() for f in recs])
        return [pipeline_summarize(self.spec, route(plat, i), route(recs, i))
                for i in range(recs.action.shape[0])]

    def train_episode(self, tasks, draws: Draws | None = None) -> dict:
        """One episode on one route (single lane) or one route a lane.
        Every summary carries ``update_steps``: the flat steps with a TD
        update (any lane's, for a population), one launch each with
        ``td_kernel``."""
        if self.lanes > 1 or self.dp:
            ta = tasks if isinstance(tasks, TaskArrays) else \
                stack_task_arrays([self._as_arrays(q) for q in tasks])
            if self.dp and ta.arrival.dim() == 1:
                ta = TaskArrays(*[f[None] for f in ta])
        else:
            ta = self._as_arrays(tasks)
        self.ts, plat, recs, losses, upd = self._train_fn(self.ts, ta,
                                                          draws)
        losses, upd = losses.cpu(), upd.bool()
        self.losses.extend(losses[upd].tolist())
        steps = int(upd.reshape(-1, upd.shape[-1]).any(0).sum())
        if not self.dp and self.lanes == 1:
            s = pipeline_summarize(self.spec, plat, recs)
            s["mean_loss"] = float(losses[upd].mean()) if upd.any() else None
            s["update_steps"] = steps
            return s
        summ = self._lane_summaries(plat, recs)
        if self.dp:
            mean_loss = float(losses[upd].mean()) if upd.any() else None
            if self.lanes == 1:
                return {**summ[0], "mean_loss": mean_loss,
                        "update_steps": steps}
            return {"lanes": summ, "mean_loss": mean_loss,
                    "update_steps": steps}
        for i, lane in enumerate(summ):
            m = upd[i]
            lane["mean_loss"] = (float(losses[i][m].mean()) if m.any()
                                 else None)
        return {"lanes": summ, "update_steps": steps}

    def train(self, queues: list, episodes: int, eval_queue=None,
              eval_every: int = 5) -> list:
        """Cycle the queue pool with ``ScanFlexAI.train``'s cadence and
        model selection (the best-eval EvalNet restored at the end)."""
        routes = [self._as_arrays(q) for q in queues]
        if self.lanes > 1 or self.dp:
            t_max = max(r.num_tasks for r in routes)
            routes = [pad_task_arrays(r, t_max) for r in routes]
        ta_eval = (self._as_arrays(eval_queue) if eval_queue is not None
                   else None)
        history = []
        self._best_stm, self._best_params = -1.0, None
        per_lane = 1 if (self.lanes == 1 and not self.dp) else self.lanes
        for ep in range(episodes):
            if per_lane == 1:
                history.append(self.train_episode(routes[ep % len(routes)]))
            else:
                history.append(self.train_episode(
                    [routes[(ep * per_lane + i) % len(routes)]
                     for i in range(per_lane)]))
            if ta_eval is not None and (ep + 1) % eval_every == 0:
                stms = self._eval_stms(ta_eval)
                history[-1]["eval_stm"] = stms[0] if len(stms) == 1 else stms
                lane = int(np.argmax(stms))
                if stms[lane] > self._best_stm:
                    self._best_stm = stms[lane]
                    self._best_params = self.eval_params(lane)
        if self._best_params is not None:
            self.set_params(self._best_params)
            self.best_eval_stm = self._best_stm
        return history

    def _eval_stms(self, ta_eval: TaskArrays) -> list[float]:
        """Greedy STM on the held-out queue: one entry for the shared
        agent, one a lane for a population (each lane's net on the same
        queue, one batched run)."""
        if not self._population:
            return [self.schedule(ta_eval)["stm_rate"]]
        batch = TaskArrays(*[f[None].expand(self.lanes, -1)
                             for f in ta_eval.to(self.device)])
        final, _, recs = self._lanes_fn(self.ts.eval_p, batch)
        return [s["stm_rate"] for s in self._lane_summaries(final, recs)]

    def eval_params(self, lane: int = 0) -> DQNParams:
        if not self._population:
            return self.ts.eval_p
        return DQNParams(*[p[lane] for p in self.ts.eval_p])

    def set_params(self, params: DQNParams) -> None:
        """Install EvalNet weights (TargNet synced, Adam reset); a
        population gets them in every lane."""
        params = DQNParams(*[p.to(self.device, torch.float32)
                             for p in params])
        if self._population:
            params = DQNParams(*[p.expand(self.lanes, *p.shape).clone()
                                 for p in params])
        self.ts = self.ts._replace(eval_p=params, targ_p=params,
                                   opt=adam_init(params))

    def save_weights(self, path: str, lane: int = 0) -> None:
        """The shared p0..p5 npz (readable by the JAX package)."""
        save_dqn_npz(path, self.eval_params(lane))

    def load_weights(self, path: str) -> None:
        self.set_params(load_dqn_npz(path, self.device))

    def schedule(self, tasks, lane: int = 0, health=None) -> dict:
        ta = self._as_arrays(tasks).to(self.device)
        t0 = time.perf_counter()
        final, _, recs = self._sched_fn(self.eval_params(lane), ta,
                                        health=health)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        summ = pipeline_summarize(self.spec, final, recs)
        summ["schedule_time_s"] = dt
        summ["schedule_time_per_task_s"] = dt / max(ta.num_tasks, 1)
        summ["placements"] = recs.action.cpu().numpy()      # [T, S]
        return summ
