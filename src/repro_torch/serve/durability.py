"""Durability and failure recovery of the port's QoS serving layer (the
port of ``repro.serve.durability``).

The paper's "basically 100 % of tasks within their period" claim has to
survive failures: a killed serving process, a re-meshed device count, a
dead or throttled accelerator mid-route.  ``DurableQoSEngine`` rides on
the wave loop's four seams (``_dispatch_segment``, ``_charge_segment``,
``_after_segment``, ``_on_complete``) and its ``_halt`` flag:

* **Snapshots**: on a segment cadence the whole serving state (the
  wave's ``PlatformState`` and partial records, the queues, the wave and
  dead-letter logs, the virtual clock, the fault and detector state, the
  policy weights) is packed into a flat array list plus a JSON meta blob
  (``pack_engine``; every device array in one transfer) and handed to
  ``AsyncCheckpointer`` as two leaves, the bytes and the meta.  The
  format, meta keys included, is the JAX package's, so a snapshot either
  package wrote restores in the other.
* **Crash recovery**: ``restore`` rebuilds the engine from the latest
  snapshot, mid-wave if it was taken there.  Every admission, preemption
  and shed decision is a function of the virtual clock and the queues,
  both in the snapshot, so the finished run equals an uninterrupted one
  bit for bit (``serving_digest``).
* **Elastic resume**: with ``mesh=`` a wave's lanes are padded to the
  mesh size, split over its ranks and trimmed back; snapshots hold whole
  arrays, so a one-device snapshot resumes on a mesh.
* **Fault injection and graceful degradation**: at a virtual instant an
  accelerator's exec and energy rows scale by ``factor``
  (``FaultInjection``).  A handled fault stops the core's heartbeats (or
  inflates them, below ``DEAD_CORE_FACTOR``), the ``StragglerDetector`` on
  the virtual clock flags it, and mitigation masks it out of the Q argmax
  and stretches admission's service cost through ``set_health``, so
  shedding drops what no longer fits.  An unhandled fault keeps the
  placements and pays the overrun in each segment's charge.

The fault charge runs in NumPy float64 on the host records, and the
degraded tables are multiplied on the host in float32, as the JAX engine
does, so the virtual clock keeps its bits.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import distributed as pdist
from repro_torch.core.flexai.dqn import DQNParams
from repro_torch.core.flexai.engine import (_schedule_run_masked,
                                            make_sharded_masked_fn)
from repro_torch.core.platform import (HEALTH_FLOOR, PlatformSpec,
                                       PlatformState, StepRecord)
from repro_torch.core.tasks import TaskArrays
from repro_torch.serve.qos import (MAX_PREEMPTIONS, SVC_EMA, QoSConfig,
                                   QoSPlacementEngine, RouteRequest, Wave)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault_tolerance import (HeartbeatRecord,
                                               StragglerDetector)

SNAPSHOT_VERSION = 2

# exec-time multiplier at or above which an injected fault is a dead core:
# its heartbeats stop and the detector's dead-host arm fires.  Below it the
# core is a straggler: it heartbeats with an inflated step time and the
# detector's threshold arm flags it.
DEAD_CORE_FACTOR = 8.0

# snapshots the engine keeps on disk
SNAPSHOT_KEEP = 3

# segments of heartbeat silence, on the virtual clock, before a core is
# declared dead
DEAD_AFTER_SEGMENTS = 4

# the JAX package's QoSConfig fields, in its order; the port keeps three
# of them as constants, and a snapshot's config must hold them at these
# values
_CFG_FIELDS = ("policy", "deadline_scale", "aging_credit", "laxity_s",
               "preempt", "shed", "slots", "chunk", "svc_per_task",
               "min_bucket", "max_preemptions", "stages", "continuous",
               "measured_svc", "svc_ema")
_CFG_CONSTANTS = {"svc_per_task": None, "max_preemptions": MAX_PREEMPTIONS,
                  "svc_ema": SVC_EMA}

# fields whose port dtype differs from the JAX package's (int32 there)
_PORT_DTYPES = {TaskArrays: {"kind": torch.int64, "group": torch.int64},
                StepRecord: {"action": torch.int64}}


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """One accelerator failing (or degrading) at a virtual-clock instant.

    ``factor`` multiplies the core's exec-time and energy rows from
    ``at_time`` on (a large factor is a dead core).  ``handled`` lets the
    serving layer react (heartbeat silence, detector flag, alive-mask
    reroute, capacity-scaled shedding); unhandled, the scheduler keeps
    placing onto the faulty core (the no-mitigation baseline)."""
    at_time: float
    core: int
    factor: float = 50.0
    handled: bool = True


def injections_from_fault_events(events, svc_per_task: float
                                 ) -> list[FaultInjection]:
    """Serving-time injections from a ``core.faults`` schedule, so one
    seeded trace drives both the scan engines and the serving layer.

    Task step ``s`` maps to virtual time ``s * svc_per_task``.  A trace
    factor is a capacity (0 dead, (0, 1] a fraction) and an injection
    factor a cumulative exec-time multiplier, so each event emits the
    relative multiplier from the core's previous capacity to its new one
    (a recovery divides the earlier slowdown back out).  A dead core lands
    at the ``HEALTH_FLOOR`` multiplier (1000x), past ``DEAD_CORE_FACTOR``."""
    cur: dict[int, float] = {}
    out = []
    for ev in sorted(events, key=lambda e: (e.step, e.core)):
        prev = cur.get(ev.core, 1.0)
        new = max(float(ev.factor), HEALTH_FLOOR)
        cur[ev.core] = new
        out.append(FaultInjection(at_time=ev.step * svc_per_task,
                                  core=ev.core, factor=prev / new))
    return out


def degrade_spec(healthy: PlatformSpec,
                 core_factor: np.ndarray) -> PlatformSpec:
    """Execution-truth spec: each core's exec and energy rows scaled by
    its cumulative degradation (energy scales with busy time at fixed
    power), multiplied on the host in float32.  The Gvalue scales keep
    their healthy values: the metric's normalization must not move."""
    f = np.asarray(core_factor, np.float32)[:, None]

    def scaled(table):
        return torch.as_tensor(table.cpu().numpy() * f, device=table.device)
    return PlatformSpec(exec_time=scaled(healthy.exec_time),
                        energy=scaled(healthy.energy),
                        gvalue_e_scale=healthy.gvalue_e_scale,
                        gvalue_t_scale=healthy.gvalue_t_scale)


def _py(v):
    return v.item() if isinstance(v, (np.floating, np.integer,
                                      np.bool_)) else v


def _sanitize(d: dict) -> dict:
    return {k: _py(v) for k, v in d.items()}


def _cfg_meta(cfg: QoSConfig) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: d[k] if k in d else _CFG_CONSTANTS[k] for k in _CFG_FIELDS}


def _cfg_from_meta(meta: dict) -> QoSConfig:
    """The port's ``QoSConfig`` of a snapshot's config; a field the port
    keeps constant must hold that constant."""
    meta = dict(meta)
    for k, want in _CFG_CONSTANTS.items():
        got = meta.pop(k, want)
        if got != want:
            raise ValueError(f"snapshot config sets {k}={got!r}; the port "
                             f"serves only {k}={want!r}")
    return QoSConfig(**meta)


# ---------------------------------------------------------------------------
# snapshot pack / unpack
# ---------------------------------------------------------------------------

def pack_engine(eng: "DurableQoSEngine",
                inflight: Optional[Wave] = None) -> tuple[list, dict]:
    """The whole serving state as ``(arrays, meta)``: host NumPy arrays
    (every device tensor in one transfer) and a JSON-serializable meta
    whose ``[start, count]`` refs index the array list.  ``inflight`` is
    the wave inside ``_run_wave`` (it lives in no queue)."""
    arrays: list = []

    def ref(tree):
        leaves = list(tree) if isinstance(tree, tuple) else [tree]
        start = len(arrays)
        arrays.extend(leaves)
        return [start, len(leaves)]

    def req_meta(r: RouteRequest) -> dict:
        m = {"uid": r.uid, "n_tasks": r.n_tasks, "arrival": _py(r.arrival),
             "deadline": _py(r.deadline), "bucket": r.bucket,
             "submit_order": r.submit_order, "waves_waited": r.waves_waited,
             "status": r.status, "finish": _py(r.finish),
             "slack": _py(r.slack), "tasks": ref(r.tasks)}
        if r.summary is not None:
            m["summary"] = {
                "scalars": _sanitize({k: v for k, v in r.summary.items()
                                      if not isinstance(v, np.ndarray)}),
                "arrays": {k: ref(v) for k, v in r.summary.items()
                           if isinstance(v, np.ndarray)}}
        return m

    def wave_meta(w: Wave) -> dict:
        # the records first: the JAX package's array order
        recs = [ref(p) for p in w.recs] if w.recs else None
        return {"requests": [req_meta(r) for r in w.requests],
                "batch": ref(w.batch), "state": ref(w.state),
                "bucket": w.bucket, "progress": w.progress,
                "preemptions": w.preemptions,
                "waves_waited": w.waves_waited, "recs": recs}

    meta = {
        "version": SNAPSHOT_VERSION,
        "now": eng.now,
        "order": eng._order,
        "dispatches": eng.dispatches,
        "preemption_count": eng.preemption_count,
        "segments_done": eng.segments_done,
        "svc": eng.svc, "base_svc": eng.base_svc,
        "svc_scale": eng.svc_scale,
        "snapshot_every": eng.snapshot_every,
        "snapshots_written": eng.snapshots_written,
        "cfg": _cfg_meta(eng.cfg),
        "wave_log": eng.wave_log,
        "dead_letter": [_sanitize(d) for d in eng.dead_letter],
        "pending": [req_meta(r) for r in eng.pending],
        "backlog": [req_meta(r) for r in eng.backlog],
        "preempted": [wave_meta(w) for w in eng.preempted],
        "completed": [req_meta(r) for r in eng.completed],
        "inflight": wave_meta(inflight) if inflight is not None else None,
        "alive": [bool(a) for a in eng.alive],
        "health": [float(h) for h in eng.health],
        "core_factor": [float(f) for f in eng.core_factor],
        "fired": [_sanitize(ev) for ev in eng.fired],
        "pending_faults": [dataclasses.asdict(f)
                           for f in eng.pending_faults],
        "detector_last_seen": {str(h): float(t) for h, t
                               in eng.detector._last_seen.items()},
        "detector_times": {str(h): [float(x) for x in ts] for h, ts
                           in eng.detector._times.items()},
        "final_states": {str(uid): ref(st)
                         for uid, st in eng.final_states.items()},
        "params": ref(eng.params),
        "exec_time": ref(eng.healthy_spec.exec_time),
    }
    return ckpt_lib.host_arrays(arrays), meta


def _slice(arrays: list, ref_: list) -> list:
    start, n = ref_
    return arrays[start: start + n]


def encode_snapshot(arrays: list, meta: dict) -> list:
    """On-disk form of a packed snapshot: one byte blob holding every
    array back to back, and the JSON meta with each array's dtype and
    shape in ``meta["leaves"]``: two files a snapshot instead of one an
    array.  Runs synchronously, so the meta freezes the live containers
    it references (``wave_log`` and the like)."""
    meta = dict(meta)
    meta["leaves"] = [[str(a.dtype), list(a.shape)] for a in arrays]
    return [np.frombuffer(b"".join(a.tobytes() for a in arrays), np.uint8),
            np.frombuffer(json.dumps(meta).encode(), np.uint8)]


def decode_snapshot(leaves: list) -> tuple[list, dict]:
    """Inverse of :func:`encode_snapshot` -> ``(arrays, meta)``."""
    blob, meta_arr = leaves
    meta = json.loads(bytes(meta_arr).decode())
    buf, off, arrays = blob.tobytes(), 0, []
    for dt, shape in meta.pop("leaves"):
        count = int(np.prod(shape))
        arrays.append(np.frombuffer(buf, np.dtype(dt), count=count,
                                    offset=off).reshape(shape).copy())
        off += count * np.dtype(dt).itemsize
    return arrays, meta


def unpack_into(eng: "DurableQoSEngine", arrays: list, meta: dict) -> None:
    """Inverse of :func:`pack_engine`: fill a freshly built engine with a
    snapshot's serving state.  Every leaf takes the port's dtype for its
    field; tasks and states go to the engine's device, a wave's records
    where ``_charge_segment`` keeps them (the host with a saver)."""
    recs_dev = (torch.device("cpu") if eng.saver is not None
                and not eng._stub else eng.device)

    def tree_from(cls, ref_, device):
        casts = _PORT_DTYPES.get(cls, {})
        return cls(*[torch.from_numpy(np.array(x)).to(
            device=device, dtype=casts.get(f)) for f, x in
            zip(cls._fields, _slice(arrays, ref_))])

    def req_from(m: dict) -> RouteRequest:
        r = RouteRequest(
            uid=m["uid"], tasks=tree_from(TaskArrays, m["tasks"], eng.device),
            n_tasks=m["n_tasks"], arrival=m["arrival"],
            deadline=m["deadline"], bucket=m["bucket"],
            submit_order=m["submit_order"],
            waves_waited=m["waves_waited"], status=m["status"],
            finish=m["finish"], slack=m["slack"])
        if m.get("summary") is not None:
            s = dict(m["summary"]["scalars"])
            for k, rr in m["summary"]["arrays"].items():
                # the only array is the placements: the port's int64
                s[k] = np.asarray(_slice(arrays, rr)[0], np.int64)
            r.summary = s
        return r

    def wave_from(m: dict) -> Wave:
        w = Wave(requests=[req_from(x) for x in m["requests"]],
                 batch=tree_from(TaskArrays, m["batch"], eng.device),
                 state=tree_from(PlatformState, m["state"], eng.device),
                 bucket=m["bucket"], progress=m["progress"],
                 preemptions=m["preemptions"],
                 waves_waited=m["waves_waited"])
        if m["recs"] is not None:
            w.recs = [tree_from(StepRecord, r, recs_dev) for r in m["recs"]]
        return w

    eng.now = meta["now"]
    eng._order = meta["order"]
    eng.dispatches = meta["dispatches"]
    eng.preemption_count = meta["preemption_count"]
    eng.segments_done = meta["segments_done"]
    eng.svc = meta["svc"]
    eng.base_svc = meta["base_svc"]
    eng.svc_scale = meta["svc_scale"]
    eng.snapshots_written = meta["snapshots_written"]
    eng.wave_log = [list(w) for w in meta["wave_log"]]
    eng.dead_letter = [dict(d) for d in meta["dead_letter"]]
    eng.pending = [req_from(m) for m in meta["pending"]]
    eng.backlog = [req_from(m) for m in meta["backlog"]]
    eng.preempted = [wave_from(m) for m in meta["preempted"]]
    eng.completed = [req_from(m) for m in meta["completed"]]
    eng._inflight = (wave_from(meta["inflight"])
                     if meta["inflight"] is not None else None)
    eng.alive = np.asarray(meta["alive"], bool)
    eng.health = np.asarray(meta["health"], np.float64)
    eng.core_factor = np.asarray(meta["core_factor"], np.float64)
    eng.fired = [dict(ev) for ev in meta["fired"]]
    eng.pending_faults = [FaultInjection(**f)
                          for f in meta["pending_faults"]]
    eng.detector._last_seen = {int(h): t for h, t
                               in meta["detector_last_seen"].items()}
    eng.detector._times = {int(h): list(ts) for h, ts
                           in meta["detector_times"].items()}
    eng.final_states = {
        int(uid): tuple(_slice(arrays, rr))
        for uid, rr in meta["final_states"].items()}
    if (eng.core_factor != 1.0).any():
        eng.cur_spec = degrade_spec(eng.healthy_spec, eng.core_factor)
    if eng.fired or eng.pending_faults:
        eng._arm_masked()


def serving_digest(eng: QoSPlacementEngine) -> dict:
    """Order-canonical arrays of a QoS engine's outcome, the bit-exactness
    contract of crash recovery and of the port against the JAX engine:
    completed uids with finish and slack, each completed request's
    placements and (durable engines) final ``PlatformState``, shed uids,
    the wave log (waves separated by -1) and the virtual clock."""
    comp = sorted(eng.completed, key=lambda r: r.uid)
    flat_log = []
    for w in eng.wave_log:
        flat_log.extend(w)
        flat_log.append(-1)
    out = {
        "completed_uids": np.asarray([r.uid for r in comp], np.int64),
        "finish": np.asarray([r.finish for r in comp], np.float64),
        "slack": np.asarray([r.slack for r in comp], np.float64),
        "shed_uids": np.sort(np.asarray(
            [d["uid"] for d in eng.dead_letter], np.int64)),
        "wave_log": np.asarray(flat_log, np.int64),
        "virtual_time": np.asarray(eng.now, np.float64),
    }
    for r in comp:
        out[f"placements_{r.uid}"] = np.asarray(
            r.summary["placements"], np.int32)
    for uid, st in sorted(getattr(eng, "final_states", {}).items()):
        for fname, a in zip(PlatformState._fields, st):
            out[f"state_{uid}_{fname}"] = np.asarray(a)
    return out


def digests_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in a)


# ---------------------------------------------------------------------------
# the durable engine
# ---------------------------------------------------------------------------

class DurableQoSEngine(QoSPlacementEngine):
    """``QoSPlacementEngine`` with snapshots, crash recovery, elastic mesh
    resume, and fault injection with graceful degradation.  With no
    snapshot dir, no faults and no mesh it serves exactly as the base
    engine.  Runs on the card unless ``device="cpu"``.

    ``mesh`` splits a wave's lanes over a ``repro_torch.distributed``
    mesh through the alive-masked scheduler
    (``flexai.engine.make_sharded_masked_fn``); faults also switch the
    dispatch to the masked scheduler, rebuilt each time a fault changes
    the execution tables."""

    def __init__(self, platform, params, cfg: QoSConfig = QoSConfig(), *,
                 backlog_scale: float = 1.0, executor: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0,       # segments; 0 = off
                 faults: Optional[list] = None, mesh=None, guard=None,
                 trace: bool = False, segment_sleep: float = 0.0,
                 device=None):
        if cfg.stages > 1:
            raise ValueError(
                "durability does not support pipeline waves (stages > 1): "
                "snapshots and fault-masked executors cover the lockstep "
                "(state)-only checkpoint, not (state, ring)")
        if cfg.continuous:
            raise ValueError(
                "durability does not support continuous batching: the "
                "snapshot format packs whole-wave checkpoints, not per-lane "
                "cursors")
        if cfg.measured_svc:
            raise ValueError(
                "durability requires the virtual clock: measured service "
                "times would break bit-exact crash replay")
        super().__init__(platform, params, cfg, backlog_scale=backlog_scale,
                         executor=executor, device=device)
        self.backlog_scale = backlog_scale
        self._stub = executor is not None
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.saver = (ckpt_lib.AsyncCheckpointer(snapshot_dir,
                                                 keep=SNAPSHOT_KEEP)
                      if snapshot_dir else None)
        self.mesh = mesh
        self.guard = guard
        self.trace = trace
        self.segment_sleep = segment_sleep
        self.interrupted = False
        self.healthy_spec = self.cur_spec = self.spec
        n = self.spec.n
        self.alive = np.ones(n, bool)              # scheduler's belief
        self.health = np.ones(n, np.float64)       # admission's belief
        self.core_factor = np.ones(n, np.float64)  # execution truth
        self.pending_faults = sorted(faults or [], key=lambda f: f.at_time)
        self.fired: list[dict] = []
        self.segments_done = 0
        self.snapshots_written = 0
        self.snapshot_time_s = 0.0  # serving time lost to pack and save
        self._inflight: Optional[Wave] = None
        self._masked_fn = None
        if self.pending_faults or mesh is not None:
            self._arm_masked()
        # heartbeat detection runs on the serving virtual clock, so the
        # whole fault story is deterministic and replayable
        self.detector = StragglerDetector(
            n, dead_after_s=DEAD_AFTER_SEGMENTS * cfg.chunk * self.svc,
            clock=lambda: self.now)
        self.final_states: dict[int, tuple] = {}

    # ---- the alive-masked dispatch --------------------------------------

    def _arm_masked(self) -> None:
        """Serve segments through the alive-masked scheduler (the stub
        executor stays as it is); the base engine's dispatch pads the
        lanes to the mesh."""
        if self._stub:
            return
        self._seg_fn = self._masked_segment
        self.shards = 1 if self.mesh is None else pdist.mesh_size(self.mesh)

    def _masked_segment(self, params, tasks: TaskArrays,
                        state: PlatformState):
        if self._masked_fn is None:   # built for the current tables
            self._masked_fn = (
                _schedule_run_masked(self.cur_spec, self.backlog_scale)
                if self.mesh is None else make_sharded_masked_fn(
                    self.cur_spec, self.mesh, self.backlog_scale))
        alive = torch.as_tensor(self.alive, device=self.device)
        return self._masked_fn(params, tasks, state, alive)

    def set_health(self, health) -> None:
        self.health = np.asarray(health, np.float64)
        super().set_health(self.health)

    # ---- fault machinery ------------------------------------------------

    def _fire_due_faults(self) -> None:
        while (self.pending_faults
               and self.pending_faults[0].at_time <= self.now):
            f = self.pending_faults.pop(0)
            self.core_factor[f.core] *= f.factor
            self.cur_spec = degrade_spec(self.healthy_spec,
                                         self.core_factor)
            self._masked_fn = None
            self.fired.append({
                "at_time": f.at_time, "core": f.core, "factor": f.factor,
                "handled": f.handled, "fired_at": self.now,
                "detected_at": None})
            if self.trace:
                print(f"FAULT core={f.core} factor={f.factor} "
                      f"at={self.now:.4f} handled={f.handled}", flush=True)

    def _heartbeat_and_detect(self) -> None:
        seg_cost = self.cfg.chunk * self.svc
        for core in range(self.spec.n):
            f = self.core_factor[core]
            if f == 1.0:
                self.detector.record(HeartbeatRecord(
                    core, self.segments_done, seg_cost, self.now))
            elif f < DEAD_CORE_FACTOR:
                # a throttled core still makes progress: it heartbeats
                # with its step time inflated, and the threshold
                # (straggler) arm fires instead of the dead-host timeout
                self.detector.record(HeartbeatRecord(
                    core, self.segments_done, seg_cost * f, self.now))
            # else: a dead core goes silent -> dead_hosts() after timeout
        dead = set(self.detector.dead_hosts())
        slow = set(self.detector.stragglers())
        for ev in self.fired:
            if ev["detected_at"] is not None:
                continue
            core = ev["core"]
            if core in dead:
                ev["detected_at"] = self.now
                if self.trace:
                    print(f"DETECTED core={core} at={self.now:.4f}",
                          flush=True)
                if ev["handled"]:
                    self._mitigate(core)
            elif core in slow and 1.0 < self.core_factor[core]:
                ev["detected_at"] = self.now
                if self.trace:
                    print(f"STRAGGLER core={core} at={self.now:.4f}",
                          flush=True)
                if ev["handled"]:
                    self._mitigate_degraded(core, self.core_factor[core])

    def _mitigate(self, core: int) -> None:
        """Dead core: drop it from the placement argmax and shrink
        admission capacity through ``set_health``, so shedding drops what
        no longer fits."""
        self.alive[core] = False
        h = np.array(self.health, np.float64)
        h[core] = 0.0
        self.set_health(h)
        if self.trace:
            print(f"MITIGATE core={core} svc_scale={self.svc_scale:.4f}",
                  flush=True)

    def _mitigate_degraded(self, core: int, factor: float) -> None:
        """Straggler: the core stays in the argmax (it still makes
        progress) but admission sees its shrunken capacity, so the
        stretched service cost sheds marginal routes instead of letting
        the slow core turn them into deadline misses."""
        h = np.array(self.health, np.float64)
        h[core] = min(h[core], 1.0 / max(float(factor), 1.0))
        self.set_health(h)
        if self.trace:
            print(f"MITIGATE-DEGRADED core={core} health={h[core]:.3f} "
                  f"svc_scale={self.svc_scale:.4f}", flush=True)

    # ---- durability seams ----------------------------------------------

    def _dispatch_segment(self, wave: Wave, seg: TaskArrays):
        self._fire_due_faults()
        return super()._dispatch_segment(wave, seg)

    def _charge_segment(self, wave: Wave, recs) -> None:
        cost = self.cfg.chunk * self.svc
        if self._stub or (self.saver is None and not self.fired):
            self.now += cost
            return
        # this segment's records to the host in one transfer; with a saver
        # they stay there (the wave's completion pays the transfer anyway,
        # and a snapshot then packs host arrays)
        host = StepRecord(*ckpt_lib.host_arrays(recs))
        if self.saver is not None:
            wave.recs[-1] = StepRecord(*[torch.from_numpy(a) for a in host])
        if self.fired:
            # honest lockstep cost: accelerator-seconds consumed over what
            # the healthy platform would have spent on the same
            # placements, in float64 on the host
            v = host.valid
            if v.any():
                act = host.action[v]
                ex = host.exec_time.astype(np.float64)[v]
                healthy = (ex / self.core_factor[act]).sum()
                if healthy > 0.0:
                    cost *= max(float(ex.sum() / healthy), 1.0)
        self.now += cost

    def _after_segment(self, wave: Wave) -> None:
        self.segments_done += 1
        self._heartbeat_and_detect()
        if self.segment_sleep:
            time.sleep(self.segment_sleep)
        if self.trace:
            print(f"SEG {self.segments_done} now={self.now:.4f} "
                  f"progress={wave.progress}/{wave.bucket}", flush=True)
        due = (self.saver is not None and self.snapshot_every > 0
               and self.segments_done % self.snapshot_every == 0)
        stop = self.guard is not None and self.guard.preempted
        if due or stop:
            self.snapshot(inflight=wave)
        if stop:
            if self.saver is not None:
                self.saver.wait()
            self.interrupted = True
            self._halt = True

    def _on_complete(self, req: RouteRequest, lane_final,
                     lane_recs) -> None:
        self.final_states[req.uid] = tuple(np.array(x) for x in lane_final)

    # ---- snapshot / restore --------------------------------------------

    def snapshot(self, inflight: Optional[Wave] = None) -> None:
        """Pack and encode the serving state synchronously (a consistent
        cut), then hand it to the saver; only the disk write is async.
        The snapshot step is its own counter, packed with the state, so a
        restored engine's snapshots continue the crashed one's."""
        if self.saver is None:
            return
        t0 = time.perf_counter()
        self.snapshots_written += 1
        arrays, meta = pack_engine(self, inflight=inflight)
        self.saver.save(self.snapshots_written,
                        encode_snapshot(arrays, meta))
        self.snapshot_time_s += time.perf_counter() - t0
        if self.trace:
            print(f"SNAPSHOT step={self.segments_done} "
                  f"now={self.now:.4f}", flush=True)

    @classmethod
    def from_packed(cls, arrays: list, meta: dict, platform, *,
                    backlog_scale: float = 1.0, executor=None, mesh=None,
                    guard=None, snapshot_dir=None, snapshot_every=None,
                    trace=False, segment_sleep=0.0,
                    device=None) -> "DurableQoSEngine":
        params = DQNParams(*[torch.from_numpy(np.array(x))
                             for x in _slice(arrays, meta["params"])])
        eng = cls(platform, params, _cfg_from_meta(meta["cfg"]),
                  backlog_scale=backlog_scale, executor=executor,
                  snapshot_dir=snapshot_dir,
                  snapshot_every=(meta["snapshot_every"]
                                  if snapshot_every is None
                                  else snapshot_every),
                  mesh=mesh, guard=guard, trace=trace,
                  segment_sleep=segment_sleep, device=device)
        snap_et = _slice(arrays, meta["exec_time"])[0]
        if not np.array_equal(eng.healthy_spec.exec_time.cpu().numpy(),
                              snap_et):
            raise ValueError(
                "snapshot was taken on a different platform "
                "(exec-time tables disagree)")
        unpack_into(eng, arrays, meta)
        return eng

    @classmethod
    def restore(cls, snapshot_dir: str, platform,
                **kwargs) -> "DurableQoSEngine":
        """Rebuild the engine from the latest snapshot in
        ``snapshot_dir``.  The snapshot is self-describing; ``platform``
        only provides the spec tables, checked against the snapshot's."""
        path = ckpt_lib.latest_checkpoint(snapshot_dir)
        if path is None:
            raise FileNotFoundError(f"no snapshot under {snapshot_dir!r}")
        _, leaves, _ = ckpt_lib.load_checkpoint_arrays(path)
        arrays, meta = decode_snapshot(leaves)
        if meta["version"] != SNAPSHOT_VERSION:
            raise ValueError(f"snapshot version {meta['version']} != "
                             f"{SNAPSHOT_VERSION}")
        kwargs.setdefault("snapshot_dir", snapshot_dir)
        return cls.from_packed(arrays, meta, platform, **kwargs)

    # ---- serving loop --------------------------------------------------

    def _resume_inflight(self) -> None:
        """Continue the wave that was inside ``_run_wave`` at snapshot
        time.  The snapshot is taken in ``_after_segment``, before the
        loop's preemption check, so replay applies that check first (a
        function of the clock and the queues: the uninterrupted run's
        verdict)."""
        w, self._inflight = self._inflight, None
        if w.progress < w.bucket and self._should_preempt(w):
            return self._preempt(w)
        self._run_wave(w)

    def run_until_done(self, max_waves: int = 100_000) -> None:
        if self._inflight is not None:
            self._resume_inflight()
        super().run_until_done(max_waves)

    def serve_waves(self, k: int) -> int:
        """Serve up to ``k`` admission rounds (the crash point of the
        recovery tests and benchmark).  Returns the rounds served."""
        served = 0
        if self._inflight is not None and k > 0:
            self._resume_inflight()
            served += 1
        while served < k and not self._halt:
            wave = self._next_wave()
            if wave is None:
                break
            self._run_wave(wave)
            served += 1
        return served

    def stats(self) -> dict:
        s = super().stats()
        s.update({
            "snapshots_written": self.snapshots_written,
            "snapshot_time_s": self.snapshot_time_s,
            "segments_done": self.segments_done,
            "faults_fired": len(self.fired),
            "cores_masked": int((~self.alive).sum()),
            "svc_scale": self.svc_scale,
            "interrupted": self.interrupted,
        })
        return s
