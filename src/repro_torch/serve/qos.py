"""Deadline-aware QoS serving of FlexAI placement requests (the port of
``repro.serve.qos``).

* Every request carries an absolute deadline derived from the Table-5
  period requirements (``tasks.route_deadline_budget``).
* Admission is EDF within a length bucket with a cross-bucket aging
  credit: each wave a queued request is passed over lowers its effective
  deadline by ``aging_credit``, so a long-route bucket cannot be starved
  by a stream of tight short routes.
* A running wave is preemptible: between service segments its batched
  ``PlatformState`` is the checkpoint, and it yields when a waiter is
  tighter by more than ``laxity_s``; it resumes through the greedy
  scheduler's ``state0=`` seam.
* Queued requests whose deadline can no longer be met are shed to a
  dead-letter log instead of burning wave slots on doomed work.

Time is a virtual clock: a segment of ``chunk`` lockstep task slots is
charged ``chunk * svc`` seconds, padding included, so every admission,
preemption and shed decision is deterministic and equals the JAX
engine's.  With ``measured_svc`` the clock advances by each segment's
measured wall time instead (the card's work waited for), and a
per-bucket EMA of it replaces the constant in shed and preempt
decisions.

Placements are real: a segment runs the batched greedy scheduler
(``flexai.engine.make_schedule_fn(batched=True)``, Q-net forward,
alive-masked argmax, ``platform_step``; plain torch ops, as the JAX
package's XLA path) on the engine's device.  With ``mesh=`` the lane axis
is split over a ``repro_torch.distributed`` mesh, lanes padded to the
mesh size with invalid rows and fresh states and trimmed back; lanes are
independent, so placements equal the unsharded path's.  The ``"stub"``
executor passes the state through, for tests of the queueing discipline
alone.  ``continuous=True`` refills a freed lane (completed, or shed
mid-flight) at the next segment boundary from the backlog instead of
draining the wave.

With ``stages > 1`` a wave serves pipeline placements
(``repro_torch.core.pipeline``): each lane's route is flattened into the
wavefront stream at admission, a segment is ``chunk`` flat (task, stage)
steps through the stage-FlexAI policy, and the preemption checkpoint
widens to ``(state, ring)``, the ring [slots, S] holding each stage's
last finish.  A flat step is charged ``svc / stages``, so a pipelined
wave costs its unpipelined twin's service time up to the (S-1)-column
drain bubble.  Params must be a stage agent's (``PipelineFlexAI``).
Pipeline waves drain: continuous batching, a mesh (pipeline waves have
their own 2-D stage mesh), the stub executor and the durability layer
refuse them, as in the reference.

The durability layer (``repro_torch.serve.durability``: snapshots, crash
replay, fault injection) overrides the wave loop's seams
(``_dispatch_segment``, ``_charge_segment``, ``_after_segment``,
``_on_complete``) and stops serving through ``_halt``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import distributed as pdist
from repro_torch.core.flexai.dqn import DQNParams
from repro_torch.core.flexai.engine import (make_schedule_fn,
                                            make_sharded_schedule_fn)
from repro_torch.core.platform import (PlatformState, StepRecord,
                                       platform_init, route,
                                       spec_from_platform, summarize)
from repro_torch.core.tasks import (TaskArrays, invalid_task_arrays,
                                    kind_period_table, pad_route_batch,
                                    pad_task_arrays, route_deadline_budget,
                                    stack_task_arrays, tasks_to_arrays)
from repro_torch.kernels.protocol import resolve_device, synchronize
from repro_torch.serve.policy import (QoSPolicy, effective_deadline,
                                      power_of_two_bucket)

QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"
COMPLETED = "completed"
SHED = "shed"

# preemptions a wave may take (livelock guard)
MAX_PREEMPTIONS = 4
# EMA weight of a new measured segment time (``measured_svc``)
SVC_EMA = 0.25


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Knobs of the deadline-aware serving layer.  ``policy="fifo"`` is
    the pre-QoS engine: oldest-head bucket admission, no aging, shedding
    or preemption."""
    policy: str = "edf"              # "edf" | "fifo"
    deadline_scale: float = 1.0      # scales the Table-5 budget
    aging_credit: float = 0.002      # s of effective-deadline credit a wave
    laxity_s: float = 0.005          # preempt when a waiter is tighter by >
    preempt: bool = True
    shed: bool = True
    slots: int = 4                   # requests per wave
    chunk: int = 16                  # tasks per service segment (the
                                     # preemption granularity)
    min_bucket: int = 16             # power of two, a multiple of chunk
    stages: int = 1                  # > 1: pipeline waves (core.pipeline)
    continuous: bool = False         # refill freed lanes at segment
                                     # boundaries instead of draining
    measured_svc: bool = False       # clock by measured segment time

    def __post_init__(self):
        if self.policy not in ("edf", "fifo"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.min_bucket < 1:
            raise ValueError(
                f"min_bucket must be >= 1, got {self.min_bucket}")
        if self.min_bucket & (self.min_bucket - 1):
            raise ValueError(
                f"min_bucket must be a power of two, got {self.min_bucket}")
        if self.min_bucket % self.chunk:
            raise ValueError("min_bucket must be a multiple of chunk")
        if self.stages < 1:
            raise ValueError("stages must be >= 1")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.continuous and self.stages > 1:
            raise ValueError(
                "continuous batching refills lockstep lanes; pipeline "
                "waves (stages > 1) drain — pick one")


@dataclasses.dataclass
class RouteRequest:
    """One vehicle's placement request plus its QoS bookkeeping."""
    uid: int
    tasks: TaskArrays        # padded to ``bucket``, on the engine's device
    n_tasks: int             # real (pre-padding) length
    arrival: float           # virtual submit time
    deadline: float          # absolute virtual deadline
    bucket: int
    submit_order: int = 0
    waves_waited: int = 0    # admission rounds passed over (aging input)
    status: str = QUEUED
    finish: Optional[float] = None
    slack: Optional[float] = None
    summary: Optional[dict] = None


@dataclasses.dataclass
class Wave:
    """An admitted (and possibly checkpointed) lockstep wave.  Records
    stay on the device, one entry a segment, until a request completes.
    A pipeline wave holds the flat wavefront stream in ``batch`` ([slots,
    flat_len]), the stage of each flat slot in ``s_seq`` and each lane's
    ring of stage finishes: ``(state, ring)`` is its checkpoint."""
    requests: list           # lane-aligned RouteRequests (may be < slots)
    batch: TaskArrays        # [slots, bucket] (or [slots, flat_len])
    state: PlatformState     # [slots, ...]: the preemption checkpoint
    bucket: int
    progress: int = 0        # lockstep task slots already served
    preemptions: int = 0
    waves_waited: int = 0
    recs: list = dataclasses.field(default_factory=list)
    s_seq: Optional[np.ndarray] = None    # [flat_len] stage a flat slot
    ring: Optional[torch.Tensor] = None   # [slots, S]: checkpoint half 2
    flat_len: Optional[int] = None        # padded wavefront length
    # continuous batching: per-lane occupancy, cursors and record chunks
    # (the checkpoint widens to (state, lane cursors) on the Wave)
    lane_requests: Optional[list] = None  # [slots] RouteRequest | None
    lane_progress: Optional[list] = None  # [slots] slots served per lane
    lane_recs: Optional[list] = None      # [slots] per-lane record chunks

    def min_deadline(self, aging_credit: float) -> float:
        return min(effective_deadline(r.deadline, self.waves_waited,
                                      aging_credit)
                   for r in self.requests)


def _stub_executor(params, tasks: TaskArrays, state: PlatformState):
    """State pass-through executor: the scheduler's output shapes (records
    [lanes, chunk], all invalid) and no placement work, for tests of the
    queueing discipline alone."""
    z = torch.zeros(tasks.arrival.shape, device=tasks.arrival.device)
    f = torch.zeros_like(z, dtype=torch.bool)
    rec = StepRecord(action=z.long(), start=z, finish=z, wait=z,
                     exec_time=z, response=z, ms=z, energy=z, met=f,
                     valid=f)
    return state, rec


def _cat_records(chunks: list, dim: int) -> StepRecord:
    """Segment records concatenated along the task axis, on the host."""
    return StepRecord(*[torch.cat(f, dim=dim).cpu() for f in zip(*chunks)])


class QoSPlacementEngine:
    """Deadline-aware wave serving of FlexAI placement requests.

    One wave runs at a time; a wave is up to ``slots`` same-bucket
    requests scheduled in lockstep segments of ``chunk`` tasks.  Between
    segments the engine may preempt: the batched ``PlatformState`` is the
    checkpoint, and the wave re-enters admission as a resumable unit.
    Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, platform, params: DQNParams,
                 cfg: QoSConfig = QoSConfig(), *,
                 backlog_scale: float = 1.0,
                 executor: Optional[str] = None, mesh=None, device=None):
        if executor not in (None, "stub"):
            raise ValueError(f"unknown executor {executor!r}: None (the "
                             f"greedy scheduler) or 'stub'")
        if mesh is not None and cfg.stages > 1:
            raise ValueError("sharded waves are single-stage; pipeline "
                             "waves have their own 2-D mesh path")
        if mesh is not None and executor is not None:
            raise ValueError("mesh sharding requires the device scan "
                             "executor; the stub executor is a host "
                             "function")
        if executor is not None and cfg.stages > 1:
            raise ValueError(
                "pipeline waves (stages > 1) require the device scan "
                "executor; the stub executor is single-stage")
        self.device = resolve_device(device)
        self.spec = spec_from_platform(platform, self.device)
        self.params = DQNParams(*[p.to(self.device, torch.float32)
                                  for p in params])
        self.cfg = cfg
        self.qpolicy = QoSPolicy(policy=cfg.policy,
                                 aging_credit=cfg.aging_credit,
                                 shed=cfg.shed)
        self.mesh = mesh
        self.shards = 1 if mesh is None else pdist.mesh_size(mesh)
        # virtual s a lockstep task slot: half the mean Table-5 period; a
        # flat pipeline slot is one (task, stage) step, charged svc/stages
        self.base_svc = self.svc = 0.5 * float(kind_period_table().mean())
        self.svc_step = self.svc / cfg.stages
        self.svc_scale = 1.0
        self.plan = None
        if cfg.stages > 1:
            from repro_torch.core.pipeline import (_pipeline_segment_run,
                                                   build_stage_plan)
            self.plan = build_stage_plan(platform, cfg.stages,
                                         device=self.device)
            self._seg_fn = _pipeline_segment_run(self.spec, self.plan,
                                                 backlog_scale)
        elif executor == "stub":
            self._seg_fn = _stub_executor
        elif mesh is None:
            self._seg_fn = make_schedule_fn(self.spec, backlog_scale,
                                            batched=True)
        else:
            self._seg_fn = make_sharded_schedule_fn(self.spec, mesh,
                                                    backlog_scale)
        # measured service: per-bucket EMA of the wall time a lockstep
        # slot takes (cfg.measured_svc); an uncalibrated bucket uses svc
        self._svc_measured: dict = {}
        self._seg_elapsed: Optional[float] = None
        self.now = 0.0
        self._halt = False  # set by a durability hook to stop serving
        self._order = 0
        self.pending: list[RouteRequest] = []    # arrival > now
        self.backlog: list[RouteRequest] = []    # eligible, never started
        self.preempted: list[Wave] = []
        self.completed: list[RouteRequest] = []
        self.dead_letter: list[dict] = []
        self.wave_log: list[list[int]] = []
        self.dispatches = 0
        self.preemption_count = 0
        self.refills = 0

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        return power_of_two_bucket(n, max(self.cfg.min_bucket,
                                          self.cfg.chunk))

    def _flat_len(self, bucket: int) -> int:
        """Wavefront stream length of a bucket, padded to a chunk multiple
        (segment cuts stay aligned)."""
        n = (bucket + self.cfg.stages - 1) * self.cfg.stages
        return n + (-n) % self.cfg.chunk

    def _service_need(self, bucket: int) -> float:
        """Service time a bucket is charged end to end, what shed and
        preempt decisions compare with deadlines (``bucket * svc`` at one
        stage, its flat length times ``svc / stages`` for pipeline
        waves).  ``set_health`` stretches ``svc``; under ``measured_svc``
        the bucket's EMA of measured slot time replaces it once calibrated
        (still scaled by the health stretch)."""
        length = (self._flat_len(bucket) if self.cfg.stages > 1
                  else bucket)
        if self.cfg.measured_svc:
            m = self._svc_measured.get(bucket)
            if m is not None:
                return length * m * self.svc_scale
        if self.cfg.stages > 1:
            return length * self.svc_step
        return bucket * self.svc

    def set_health(self, health) -> None:
        """Degradation-aware admission: install a per-core health row
        (``core.faults`` semantics: 0 dead, (0, 1] capacity fraction) and
        stretch the service cost by total / health-weighted capacity, so
        shedding fires before a doomed dispatch.  An all-ones row
        restores the healthy cost exactly."""
        et = self.spec.exec_time.cpu().numpy().astype(np.float64)
        cap = 1.0 / et.mean(axis=1)          # per-core healthy throughput
        eff = float((cap * np.asarray(health, np.float64)).sum())
        self.svc_scale = float(cap.sum()) / max(eff, 1e-12)
        self.svc = self.base_svc * self.svc_scale
        self.svc_step = self.svc / self.cfg.stages

    def submit(self, tasks, arrival: float = 0.0,
               deadline: Optional[float] = None) -> RouteRequest:
        """Queue one route (a ``Task`` list or ``TaskArrays`` [T]).
        ``deadline`` defaults to arrival + the route's Table-5 period
        budget scaled by ``cfg.deadline_scale``."""
        ta = tasks if isinstance(tasks, TaskArrays) else tasks_to_arrays(tasks)
        n = ta.num_tasks
        bucket = self._bucket(n)
        if deadline is None:
            deadline = arrival + route_deadline_budget(
                ta, self.cfg.deadline_scale)
        req = RouteRequest(uid=self._order,
                           tasks=pad_task_arrays(ta, bucket).to(self.device),
                           n_tasks=n, arrival=float(arrival),
                           deadline=float(deadline), bucket=bucket,
                           submit_order=self._order)
        self._order += 1
        if req.arrival <= self.now:
            self.backlog.append(req)
        else:
            self.pending.append(req)
            self.pending.sort(key=lambda r: (r.arrival, r.submit_order))
        return req

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _promote_arrivals(self) -> None:
        while self.pending and self.pending[0].arrival <= self.now:
            self.backlog.append(self.pending.pop(0))

    def _eff_deadline(self, req: RouteRequest) -> float:
        return self.qpolicy.eff_deadline(req.deadline, req.waves_waited)

    def _shed_request(self, r: RouteRequest, reason: str,
                      needed_s: float) -> None:
        """Move one request to the dead-letter log (queued shed and the
        continuous mode's mid-flight overrun shed)."""
        r.status = SHED
        r.finish = self.now
        r.slack = r.deadline - self.now
        self.dead_letter.append({
            "uid": r.uid, "n_tasks": r.n_tasks,
            "deadline": r.deadline, "shed_at": self.now,
            "reason": reason, "needed_s": needed_s,
            "had_s": r.deadline - self.now})

    def _shed_infeasible(self) -> None:
        """Timeout shedding: a queued request whose full service no longer
        fits before its deadline goes to the dead-letter log."""
        keep = []
        for r in self.backlog:
            need = self._service_need(r.bucket)
            if self.qpolicy.should_shed(self.now, need, r.deadline):
                self._shed_request(r, "infeasible", need)
            else:
                keep.append(r)
        self.backlog = keep

    def _fresh_states(self, lanes: int) -> PlatformState:
        return platform_init(self.spec.n, lanes, self.device)

    def _pack_wave(self, head: RouteRequest) -> Wave:
        """The head picks the bucket; the wave fills with that bucket's
        eligible requests in EDF (or submit) order.  Everyone left behind
        ages one wave."""
        peers = [r for r in self.backlog if r.bucket == head.bucket]
        peers.sort(key=self.qpolicy.request_key)
        wave_reqs = peers[: self.cfg.slots]
        taken = {r.uid for r in wave_reqs}
        self.backlog = [r for r in self.backlog if r.uid not in taken]
        self.qpolicy.age(self.backlog)
        self.qpolicy.age(self.preempted)
        for r in wave_reqs:
            r.status = RUNNING
        idle = invalid_task_arrays(head.bucket).to(self.device)
        rows = [r.tasks for r in wave_reqs]
        rows += [idle] * (self.cfg.slots - len(rows))
        self.wave_log.append([r.uid for r in wave_reqs])
        batch = stack_task_arrays(rows)
        s_seq = ring = flat_len = None
        if self.plan is not None:
            batch, s_seq, flat_len = self._flatten_batch(batch, head.bucket)
            ring = torch.zeros(self.cfg.slots, self.cfg.stages,
                               device=self.device)
        # the wave inherits its members' earned aging credit, so a request
        # preempted right after admission keeps its anti-starvation clock
        return Wave(requests=wave_reqs, batch=batch,
                    state=self._fresh_states(self.cfg.slots),
                    bucket=head.bucket,
                    waves_waited=max(r.waves_waited for r in wave_reqs),
                    s_seq=s_seq, ring=ring, flat_len=flat_len)

    def _flatten_batch(self, batch: TaskArrays, bucket: int):
        """[slots, bucket] lockstep batch -> [slots, flat_len] wavefront
        stream (``core.pipeline._wavefront_stream``; the stage sequence
        depends only on (bucket, stages), so lanes share it), right-padded
        with invalid rows to a chunk multiple."""
        from repro_torch.core.pipeline import _wavefront_stream
        flat_len = self._flat_len(bucket)
        rows, s_seq = _wavefront_stream(batch, self.cfg.stages)
        pad = flat_len - rows.arrival.shape[1]
        tail = invalid_task_arrays(pad).to(self.device)
        rows = TaskArrays(*[torch.cat([f, t.expand(f.shape[0], pad)], dim=1)
                            for f, t in zip(rows, tail)])
        return rows, np.concatenate([s_seq, np.zeros(pad, s_seq.dtype)]), \
            flat_len

    def _next_wave(self) -> Optional[Wave]:
        while True:
            self._promote_arrivals()
            if not self.backlog and not self.preempted:
                if not self.pending:
                    return None
                self.now = max(self.now, self.pending[0].arrival)
                self._promote_arrivals()
            if self.cfg.policy == "edf" and self.cfg.shed:
                self._shed_infeasible()
            if self.backlog or self.preempted:
                break
            if not self.pending:  # everything left was shed
                return None
            # an all-infeasible arrival group was shed; advance to the next
        if self.cfg.policy == "fifo":
            if self.preempted:      # only reachable by external injection:
                # _should_preempt gates on "edf", but resume consistently
                return self._resume(self.preempted[0])
            head = min(self.backlog, key=lambda r: r.submit_order)
            return self._pack_wave(head)
        # EDF: fresh requests and preempted waves compete on effective
        # deadline; a resumed wave re-enters at its checkpoint
        best_req = min(self.backlog, default=None,
                       key=self.qpolicy.request_key)
        best_wave = min(self.preempted, default=None,
                        key=lambda w: w.min_deadline(self.cfg.aging_credit))
        if best_wave is not None and (
                best_req is None
                or best_wave.min_deadline(self.cfg.aging_credit)
                <= self._eff_deadline(best_req)):
            return self._resume(best_wave)
        return self._pack_wave(best_req)

    def _resume(self, wave: Wave) -> Wave:
        """Re-admit a preempted wave at its checkpoint, with the aging and
        wave-log bookkeeping of a fresh admission."""
        self.preempted.remove(wave)
        self.qpolicy.age(self.backlog)
        self.qpolicy.age(self.preempted)
        for r in wave.requests:
            r.status = RUNNING
        self.wave_log.append([r.uid for r in wave.requests])
        return wave

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _should_preempt(self, wave: Wave) -> bool:
        if (self.cfg.policy != "edf" or not self.cfg.preempt
                or wave.preemptions >= MAX_PREEMPTIONS):
            return False
        # a waiter that can no longer make its deadline (it will be shed
        # at the next admission) is not worth a checkpoint
        waiters = [self._eff_deadline(r) for r in self.backlog
                   if not self.qpolicy.should_shed(
                       self.now, self._service_need(r.bucket), r.deadline)]
        waiters += [w.min_deadline(self.cfg.aging_credit)
                    for w in self.preempted]
        if not waiters:
            return False
        return min(waiters) < (wave.min_deadline(self.cfg.aging_credit)
                               - self.cfg.laxity_s)

    # ---- seams of the wave loop (the durability layer overrides them) --

    def _dispatch_segment(self, wave: Wave, seg: TaskArrays):
        """Serve one chunk [slots, chunk]: returns ``(new_state,
        records)``.  With a mesh the lane axis is padded to the mesh size
        (invalid rows, fresh states) and trimmed back; lanes are
        independent, so sharding leaves placements as they are."""
        pad = (-self.cfg.slots) % self.shards
        if not pad:
            return self._seg_fn(self.params, seg, wave.state)
        state = PlatformState(*[torch.cat([a, b]) for a, b in zip(
            wave.state, self._fresh_states(pad))])
        st, recs = self._seg_fn(self.params,
                                pad_route_batch(seg, self.shards), state)
        slots = self.cfg.slots
        return (PlatformState(*[f[:slots] for f in st]),
                StepRecord(*[f[:slots] for f in recs]))

    def _timed_dispatch(self, wave: Wave, seg: TaskArrays):
        """Dispatch one segment: ``(new_state, records)``.  A pipeline
        wave's segment runs the stage policy from its ``(state, ring)``
        checkpoint and moves ``wave.ring`` on.  Under ``measured_svc`` the
        segment's wall time, the device's work waited for, feeds the
        bucket's EMA and is what ``_charge_segment`` advances the clock
        by."""
        t0 = time.perf_counter() if self.cfg.measured_svc else None
        if wave.ring is None:
            out = self._dispatch_segment(wave, seg)
        else:
            p = wave.progress
            state, wave.ring, recs = self._seg_fn(
                self.params, seg, wave.s_seq[p: p + self.cfg.chunk],
                wave.state, wave.ring)
            out = (state, recs)
        if t0 is None:
            return out
        synchronize(self.device)
        self._seg_elapsed = time.perf_counter() - t0
        self._observe_service(wave.bucket, self._seg_elapsed)
        return out

    def _observe_service(self, bucket: int, elapsed: float) -> None:
        per_slot = elapsed / self.cfg.chunk
        prev = self._svc_measured.get(bucket)
        self._svc_measured[bucket] = (
            per_slot if prev is None
            else (1.0 - SVC_EMA) * prev + SVC_EMA * per_slot)

    def _charge_segment(self, wave: Wave, recs) -> None:
        """Advance the clock for one served segment: its measured wall
        time, or ``chunk * svc / stages`` (a pipeline segment is ``chunk``
        flat (task, stage) steps)."""
        if self._seg_elapsed is not None:
            self.now += self._seg_elapsed
            self._seg_elapsed = None
        else:
            self.now += self.cfg.chunk * self.svc_step

    def _after_segment(self, wave: Wave) -> None:
        """Segment-boundary hook: fault firing, heartbeats, snapshot
        cadence, preemption-guard checks (no-op in this engine)."""

    def _on_complete(self, req: RouteRequest, lane_final, lane_recs) -> None:
        """Per-request completion hook (durability: final-state capture
        for the recovery digest; no-op in this engine)."""

    def _finish(self, req: RouteRequest, bucket: int, lane_final,
                lane_recs) -> None:
        """Summarize a completed lane (state and records on the host) and
        resolve its request at the current clock.  A pipeline lane's flat
        records come back task-major ([bucket, S]) and its end-to-end
        verdicts are the final stage's; placements [n_tasks, S]."""
        if self.plan is not None:
            from repro_torch.core.pipeline import (_record_order,
                                                   pipeline_summarize)
            order = torch.as_tensor(_record_order(bucket, self.cfg.stages))
            lane_recs = StepRecord(*[f[order] for f in lane_recs])
            summ = pipeline_summarize(self.spec, lane_final, lane_recs)
        else:
            summ = summarize(self.spec, lane_final, lane_recs)
        summ["placements"] = lane_recs.action[: req.n_tasks].numpy()
        summ["bucket"] = bucket
        req.summary = summ
        req.status = COMPLETED
        req.finish = self.now
        req.slack = req.deadline - self.now
        self._on_complete(req, lane_final, lane_recs)
        self.completed.append(req)

    def _preempt(self, wave: Wave) -> None:
        wave.preemptions += 1
        self.preemption_count += 1
        for r in wave.requests:
            r.status = PREEMPTED
        self.preempted.append(wave)

    def _run_wave(self, wave: Wave) -> None:
        if self.cfg.continuous:
            return self._run_wave_continuous(wave)
        chunk = self.cfg.chunk
        total = wave.bucket if wave.flat_len is None else wave.flat_len
        while wave.progress < total:
            p = wave.progress
            seg = TaskArrays(*[f[:, p: p + chunk] for f in wave.batch])
            state, recs = self._timed_dispatch(wave, seg)
            self.dispatches += 1
            wave.state = state
            wave.recs.append(recs)
            wave.progress += chunk
            self._charge_segment(wave, recs)
            self._promote_arrivals()
            self._after_segment(wave)
            if self._halt:
                return  # durability stop: the wave was snapshotted in flight
            if wave.progress < total and self._should_preempt(wave):
                return self._preempt(wave)
        # wave drained: every live lane completes at the current clock;
        # its records come to the host in one transfer
        recs = _cat_records(wave.recs, dim=1)
        final = PlatformState(*[f.cpu() for f in wave.state])
        for lane, req in enumerate(wave.requests):
            self._finish(req, wave.bucket, route(final, lane),
                         route(recs, lane))

    # ---- continuous batching (cfg.continuous) --------------------------

    def _run_wave_continuous(self, wave: Wave) -> None:
        """Continuous-batching wave loop: lanes carry their own cursors,
        and at every segment boundary a freed lane (completed, or shed
        mid-flight once its remaining service cannot meet its deadline)
        is refilled from the backlog with a fresh ``PlatformState`` row.
        ``(state, lane cursors)`` lives on the Wave, so preempt and
        resume re-enter here unchanged."""
        chunk, slots = self.cfg.chunk, self.cfg.slots
        if wave.lane_requests is None:
            wave.lane_requests = (list(wave.requests)
                                  + [None] * (slots - len(wave.requests)))
            wave.lane_progress = [0] * slots
            wave.lane_recs = [[] for _ in range(slots)]
        idle = invalid_task_arrays(chunk).to(self.device)
        while True:
            rows = []
            for r, p in zip(wave.lane_requests, wave.lane_progress):
                rows.append(idle if r is None else
                            TaskArrays(*[f[p: p + chunk] for f in r.tasks]))
            state, recs = self._timed_dispatch(wave,
                                               stack_task_arrays(rows))
            self.dispatches += 1
            wave.state = state
            for lane in range(slots):
                if wave.lane_requests[lane] is not None:
                    wave.lane_recs[lane].append(route(recs, lane))
                    wave.lane_progress[lane] += chunk
            wave.progress += chunk
            self._charge_segment(wave, recs)
            self._promote_arrivals()
            self._after_segment(wave)
            if self._halt:
                wave.requests = [r for r in wave.lane_requests
                                 if r is not None]
                return
            for lane in range(slots):
                if (wave.lane_requests[lane] is not None
                        and wave.lane_progress[lane] >= wave.bucket):
                    self._complete_lane(wave, lane)
            self._shed_overrun_lanes(wave)
            self._refill(wave)
            wave.requests = [r for r in wave.lane_requests if r is not None]
            if not wave.requests:
                return
            if self._should_preempt(wave):
                return self._preempt(wave)

    def _free_lane(self, wave: Wave, lane: int) -> None:
        wave.lane_requests[lane] = None
        wave.lane_progress[lane] = 0
        wave.lane_recs[lane] = []

    def _complete_lane(self, wave: Wave, lane: int) -> None:
        """One lane reached its bucket: summarize it as a drained wave's
        lane and free the slot for refill."""
        self._finish(wave.lane_requests[lane], wave.bucket,
                     PlatformState(*[f[lane].cpu() for f in wave.state]),
                     _cat_records(wave.lane_recs[lane], dim=0))
        self._free_lane(wave, lane)

    def _shed_overrun_lanes(self, wave: Wave) -> None:
        """Mid-flight shed: a lane whose remaining service can no longer
        meet its deadline is cut loose so it can serve a feasible
        request."""
        if not self.qpolicy.is_edf or not self.cfg.shed:
            return
        per_slot = self._service_need(wave.bucket) / wave.bucket
        for lane, r in enumerate(wave.lane_requests):
            if r is None:
                continue
            need = (wave.bucket - wave.lane_progress[lane]) * per_slot
            if self.qpolicy.should_shed(self.now, need, r.deadline):
                self._shed_request(r, "overrun", need)
                self._free_lane(wave, lane)

    def _refill_head(self) -> Optional[RouteRequest]:
        """The request global admission would run next, or None if a
        checkpointed wave (or nothing) goes first: refill must not
        overtake the cross-bucket order, or aging's starvation bound
        dies."""
        if not self.backlog:
            return None
        if not self.qpolicy.is_edf:
            if self.preempted:
                return None
            return min(self.backlog, key=lambda r: r.submit_order)
        best_req = min(self.backlog, key=self.qpolicy.request_key)
        best_wave = min(self.preempted, default=None,
                        key=lambda w: w.min_deadline(self.cfg.aging_credit))
        if best_wave is not None and (
                best_wave.min_deadline(self.cfg.aging_credit)
                <= self._eff_deadline(best_req)):
            return None
        return best_req

    def _refill(self, wave: Wave) -> None:
        """Admit backlog into freed lanes at a segment boundary: only the
        global admission head, and only while it shares the wave's
        bucket.  A refill round that admits anyone ages everyone passed
        over, as ``_pack_wave`` does; the refilled lane's state row is
        reset in place."""
        free = [lane for lane in range(self.cfg.slots)
                if wave.lane_requests[lane] is None]
        if not free:
            return
        if self.qpolicy.is_edf and self.cfg.shed:
            self._shed_infeasible()
        fresh = self._fresh_states(1)
        admitted = []
        for lane in free:
            head = self._refill_head()
            if head is None or head.bucket != wave.bucket:
                break
            self.backlog.remove(head)
            head.status = RUNNING
            wave.lane_requests[lane] = head
            wave.lane_progress[lane] = 0
            wave.lane_recs[lane] = []
            for f, init in zip(wave.state, fresh):
                f[lane] = init[0]
            admitted.append(head)
        if admitted:
            self.refills += len(admitted)
            self.wave_log.append([r.uid for r in admitted])
            self.qpolicy.age(self.backlog)
            self.qpolicy.age(self.preempted)
            wave.waves_waited = max(
                [wave.waves_waited] + [r.waves_waited for r in admitted])

    def run_until_done(self, max_waves: int = 100_000) -> None:
        for _ in range(max_waves):
            if self._halt:
                return
            wave = self._next_wave()
            if wave is None:
                return
            self._run_wave(wave)
        raise RuntimeError(f"serving did not drain in {max_waves} waves")

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Serving-boundary QoS summary.  Miss and slack rates count
        resolved requests only (completed + shed); queued and in-flight
        work is reported beside them."""
        submitted = self._order
        shed = len(self.dead_letter)
        ms = self.qpolicy.miss_stats(
            [r.slack for r in self.completed], shed)
        queued = len(self.backlog) + len(self.pending)
        in_flight = submitted - ms["resolved"] - queued
        stm = [r.summary["stm_rate"] for r in self.completed
               if r.summary is not None and r.summary["tasks"] > 0]
        # task-weighted STM over the whole submitted workload: a shed
        # route's tasks were never processed, so they count as unmet
        met_tasks = sum(r.summary["stm_rate"] * r.summary["tasks"]
                        for r in self.completed if r.summary is not None)
        total_tasks = (sum(r.n_tasks for r in self.completed)
                       + sum(d["n_tasks"] for d in self.dead_letter))
        return {
            "policy": self.cfg.policy,
            "submitted": submitted,
            "resolved": ms["resolved"],
            "in_flight": in_flight,
            "queued": queued,
            "completed": ms["completed"],
            "shed": shed,
            "missed_deadline": ms["missed_deadline"],
            "miss_rate": ms["miss_rate"],
            "p50_slack_s": ms["p50_slack"],
            "p99_slack_s": ms["p99_slack"],
            "mean_stm_rate": float(np.mean(stm)) if stm else 0.0,
            "stm_rate_incl_shed": (met_tasks / total_tasks) if total_tasks
            else 0.0,
            "waves": len(self.wave_log),
            "preemptions": self.preemption_count,
            "dispatches": self.dispatches,
            "refills": self.refills,
            "virtual_time_s": self.now,
        }
