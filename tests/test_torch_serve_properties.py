"""The serving contract of ``tests/test_serve_properties.py`` on the
port's QoS engine, each case served by the JAX engine too:

* conservation: every submitted request ends once, completed or shed,
  with nothing left queued (drain, continuous and adversarial streams);
* no starvation: under EDF with aging a request waits at most
  ``ceil(spread/credit) + 3`` admission rounds against an endless
  tighter stream, and the same stream starves it without the credit;
* EDF dominance: on equal-service workloads EDF misses no more
  deadlines than bucket FIFO;
* preemption round trip: a preempted wave resumes from its
  ``PlatformState`` checkpoint with the placements of an uninterrupted
  run, bit for bit;
* crash-replay conservation: a durable engine killed after any number
  of admission rounds and replayed from its packed snapshot still ends
  every uid once, the dead letters from before the crash kept;
* fault-shed conservation: a mid-stream dead core sheds through
  ``set_health``, and every uid still ends once;
* the deterministic spot checks (honest mid-drain stats, in-flight
  lanes, refilled lanes' fresh state, aging through refill and
  admission, degraded-pool shedding, FIFO and EDF orders).

The JAX package drives its properties with ``hypothesis``; the twins
run the JAX file's fixed-seed sweeps (the same seeds and draws), each
case a parametrised test, so the run is deterministic and writes no
example database.  Every case also holds the port's serving outcome to
the JAX engine's (``test_torch_qos.assert_same_serving``); the durable
cases serve the JAX durable engine and the port's.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.serve import durability as dur_jax
from repro.serve.qos import QoSConfig as QoSConfigJax
from repro_torch.core.flexai.engine import make_schedule_fn
from repro_torch.core.tasks import pad_task_arrays
from repro_torch.serve import durability as dur
from repro_torch.serve.qos import COMPLETED, SHED, QoSConfig
from test_torch_qos import (AGENT, BACKLOG, PARAMS, PLATFORM, PLATFORM_JAX,
                            assert_same_serving, engine_pair, route_pair,
                            submit_pair)

SEEDS = list(range(20))


def _random_jobs(rng):
    """(n_tasks, arrival, budget) jobs as the JAX file's sweeps draw
    them."""
    return [(int(rng.integers(1, 41)), float(rng.uniform(0, 0.5)),
             float(rng.uniform(0.005, 0.6)))
            for _ in range(int(rng.integers(1, 13)))]


def _adversarial_jobs(kind, n_jobs, seed):
    """The JAX file's adversarial streams: ``bursty`` collapses arrivals
    onto a few instants, ``duplicate`` repeats one submission, and
    ``inverted`` gives later arrivals earlier deadlines."""
    rng = np.random.default_rng(seed)
    if kind == "bursty":
        instants = rng.uniform(0.0, 0.2, max(1, n_jobs // 4))
        return [(int(rng.integers(1, 41)), float(rng.choice(instants)),
                 float(rng.uniform(0.005, 0.6))) for _ in range(n_jobs)]
    if kind == "duplicate":
        job = (int(rng.integers(1, 41)), float(rng.uniform(0.0, 0.1)),
               float(rng.uniform(0.005, 0.6)))
        return [job] * n_jobs
    arrivals = np.sort(rng.uniform(0.0, 0.4, n_jobs))
    latest = float(arrivals[-1])
    return [(int(rng.integers(1, 41)), float(a),
             float(2.2 * (latest - a) + 0.01)) for a in arrivals]


ADVERSARIAL_KINDS = ("bursty", "duplicate", "inverted")


def _serve(jobs, seed, executor="stub", **cfg):
    """Serve (n_tasks, arrival, budget) jobs on both engines and hold the
    port to the JAX engine; returns the port's engine and handles."""
    engines = engine_pair(executor, **cfg)
    handles = submit_pair(engines, [(n, a, a + b) for n, a, b in jobs],
                          seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    return engines[1], [t for _, t in handles]


def _assert_conserved(eng, n_jobs):
    assert not eng.backlog and not eng.pending and not eng.preempted
    done = [r.uid for r in eng.completed]
    shed = [d["uid"] for d in eng.dead_letter]
    assert sorted(done + shed) == list(range(n_jobs))
    assert all(r.status == COMPLETED for r in eng.completed)
    s = eng.stats()
    assert s["submitted"] == n_jobs
    assert s["completed"] + s["shed"] == n_jobs
    assert s["in_flight"] == 0 and s["queued"] == 0


# ---------------------------------------------------------------------------
# conservation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_conservation_seeded(seed):
    rng = np.random.default_rng(seed)
    jobs = _random_jobs(rng)
    eng, _ = _serve(jobs, seed, policy=("edf", "fifo")[seed % 2],
                    slots=int(rng.integers(1, 4)), preempt=bool(seed % 3),
                    shed=bool((seed // 2) % 2), chunk=16, min_bucket=16)
    _assert_conserved(eng, len(jobs))


@pytest.mark.parametrize("seed", SEEDS)
def test_continuous_conservation_seeded(seed):
    rng = np.random.default_rng(7000 + seed)
    jobs = _random_jobs(rng)
    eng, _ = _serve(jobs, seed, policy="edf",
                    slots=int(rng.integers(1, 4)), preempt=bool(seed % 3),
                    shed=bool((seed // 2) % 2), chunk=16, min_bucket=16,
                    continuous=True)
    _assert_conserved(eng, len(jobs))


@pytest.mark.parametrize("seed", SEEDS)
def test_adversarial_conservation_seeded(seed):
    rng = np.random.default_rng(5000 + seed)
    slots, n_jobs = int(rng.integers(1, 4)), int(rng.integers(2, 13))
    jobs = _adversarial_jobs(ADVERSARIAL_KINDS[seed % 3], n_jobs, seed)
    eng, _ = _serve(jobs, seed, policy=("edf", "fifo")[seed % 2],
                    slots=slots, preempt=True, shed=True, chunk=16,
                    min_bucket=16)
    _assert_conserved(eng, n_jobs)


def _durable_pair(cfg, faults=None, **kw):
    """The JAX durable engine and the port's on the stub executor
    (``kw`` for the JAX one: the port's detection delay is a constant)."""
    return (dur_jax.DurableQoSEngine(
                PLATFORM_JAX, AGENT.learner.eval_p, QoSConfigJax(**cfg),
                backlog_scale=BACKLOG, executor="stub",
                faults=faults and [dur_jax.FaultInjection(
                    **dataclasses.asdict(f)) for f in faults], **kw),
            dur.DurableQoSEngine(PLATFORM, PARAMS, QoSConfig(**cfg),
                                 backlog_scale=BACKLOG, executor="stub",
                                 faults=faults, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_crash_replay_conservation_seeded(seed):
    """Kill a durable engine after ``kill_after`` admission rounds, replay
    from its in-memory snapshot, and require conservation on the combined
    history, the dead letters from before the crash kept; the JAX engine
    killed and replayed at the same point serves the same."""
    rng = np.random.default_rng(4000 + seed)
    jobs = _random_jobs(rng)
    cfg = dict(policy=("edf", "fifo")[seed % 2],
               slots=int(rng.integers(1, 4)), chunk=16, min_bucket=16)
    kill_after = int(rng.integers(0, 9))
    engines = _durable_pair(cfg)
    submit_pair(engines, [(n, a, a + b) for n, a, b in jobs], seed)
    resumed = []
    for pkg, eng, plat, kw in zip((dur_jax, dur), engines,
                                  (PLATFORM_JAX, PLATFORM),
                                  ({}, {"device": "cpu"})):
        eng.serve_waves(kill_after)
        shed_before = [d["uid"] for d in eng.dead_letter]
        res = pkg.DurableQoSEngine.from_packed(
            *pkg.pack_engine(eng), plat, backlog_scale=BACKLOG,
            executor="stub", **kw)
        res.run_until_done()
        assert [d["uid"] for d in res.dead_letter][:len(shed_before)] \
            == shed_before
        resumed.append(res)
    assert_same_serving(*resumed)
    _assert_conserved(resumed[1], len(jobs))


@pytest.mark.parametrize("seed", SEEDS[:10])
def test_fault_shed_conservation_seeded(seed, monkeypatch):
    """A dead core mid-stream stretches the service cost and sheds
    marginal routes: every uid still ends once, every shed is
    "infeasible", and the fault fired or is still pending."""
    rng = np.random.default_rng(6000 + seed)
    kind = ADVERSARIAL_KINDS[seed % 3]
    n_jobs = int(rng.integers(2, 11))
    core = int(rng.integers(0, PLATFORM.n))
    at = float(rng.uniform(0.0, 1.0)) * 0.2
    monkeypatch.setattr(dur, "DEAD_AFTER_SEGMENTS", 1)
    engines = _durable_pair(
        dict(policy="edf", slots=2, chunk=16, min_bucket=16),
        faults=[dur.FaultInjection(at_time=at, core=core)],
        dead_after_segments=1)
    jobs = _adversarial_jobs(kind, n_jobs, seed)
    submit_pair(engines, [(n, a, a + b) for n, a, b in jobs], seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    eng = engines[1]
    _assert_conserved(eng, n_jobs)
    assert all(d["reason"] == "infeasible" for d in eng.dead_letter)
    assert eng.stats()["faults_fired"] + len(eng.pending_faults) == 1


# ---------------------------------------------------------------------------
# no starvation
# ---------------------------------------------------------------------------

def _serve_stream(credit, long_deadline, tight_deadline, n_stream, seed):
    """One loose long-bucket request against a stream of tight
    short-bucket newcomers, one arrival a service round, on both engines;
    returns the JAX and the port's handle of the long request."""
    engines = engine_pair(policy="edf", aging_credit=credit, slots=1,
                          preempt=False, shed=False, chunk=16, min_bucket=16)
    gap = 0.9 * 16 * engines[1].svc  # the tight backlog never runs dry
    jobs = [(60, 0.0, long_deadline)] + [
        (12, i * gap, tight_deadline) for i in range(n_stream)]
    (long_j, long_t), *_ = submit_pair(engines, jobs, seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    assert long_t.waves_waited == long_j.waves_waited
    return long_j, long_t


def _starvation_case(long_budget, credit, seed):
    tight = 0.01
    k = math.ceil((long_budget - tight) / credit) + 3
    n_stream = k + 10  # the stream strictly outlasts the bound
    long_j, long_t = _serve_stream(credit, long_budget, tight, n_stream,
                                   seed)
    _, starved = _serve_stream(0.0, long_budget, tight, n_stream, seed)
    return k, n_stream, long_j, long_t, starved


@pytest.mark.parametrize("seed", SEEDS[:10])
def test_no_starvation_bound_seeded(seed):
    rng = np.random.default_rng(1000 + seed)
    k, n_stream, _, long_r, starved = _starvation_case(
        float(rng.uniform(0.05, 0.5)), float(rng.uniform(0.01, 0.05)), seed)
    assert long_r.status == COMPLETED
    assert long_r.waves_waited <= k, (long_r.waves_waited, k)
    assert starved.waves_waited >= n_stream - 3


def test_reference_starvation_counterexample():
    """The example at which the JAX test fails (long_budget 0.5, credit
    0.01171875, seed 0): the JAX engine admits the long request after 46
    waves, one past the bound of 45.  The port makes the same decisions,
    so it waits as long: the bound fails for the port there too."""
    k, n_stream, long_j, long_t, starved = _starvation_case(
        0.5, 0.01171875, 0)
    assert long_t.status == long_j.status == COMPLETED
    assert (long_t.waves_waited, k) == (long_j.waves_waited, 45)
    assert starved.waves_waited >= n_stream - 3


def test_continuous_starvation_bound_survives_refill(fixed_seed):
    """Refill admission does not bypass aging: through one continuously
    refilled wave the long request is still admitted within the bound."""
    credit, long_deadline, tight = 0.02, 0.3, 0.01
    k = math.ceil((long_deadline - tight) / credit) + 3
    engines = engine_pair(policy="edf", aging_credit=credit, slots=1,
                          preempt=False, shed=False, chunk=16,
                          min_bucket=16, continuous=True)
    gap = 0.9 * 16 * engines[1].svc
    jobs = [(60, 0.0, long_deadline)] + [
        (12, i * gap, tight) for i in range(k + 10)]
    (_, long_r), *_ = submit_pair(engines, jobs, fixed_seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    assert engines[1].stats()["refills"] >= 1
    assert long_r.status == COMPLETED
    assert long_r.waves_waited <= k, (long_r.waves_waited, k)


# ---------------------------------------------------------------------------
# EDF dominance
# ---------------------------------------------------------------------------

def _miss_count(eng) -> int:
    return (len(eng.dead_letter)
            + sum(1 for r in eng.completed if r.slack < 0.0))


@pytest.mark.parametrize("seed", SEEDS)
def test_edf_dominates_fifo_seeded(seed):
    rng = np.random.default_rng(2000 + seed)
    n_jobs, slots = int(rng.integers(2, 13)), int(rng.integers(1, 3))
    budgets = [float(rng.uniform(0.005, 0.25)) for _ in range(12)]
    # one length, so one bucket and equal service; common arrival
    jobs = [(16, 0.0, budgets[i % 12]) for i in range(n_jobs)]
    miss = {policy: _miss_count(_serve(
        jobs, seed, policy=policy, slots=slots, preempt=False,
        shed=(policy == "edf"), chunk=16, min_bucket=16)[0])
        for policy in ("edf", "fifo")}
    assert miss["edf"] <= miss["fifo"]


# ---------------------------------------------------------------------------
# preemption round trip (the greedy scheduler)
# ---------------------------------------------------------------------------

def _roundtrip(n_long, n_short, arrive_frac, seed):
    """A long route runs; a short one arrives mid-wave, tight enough to
    preempt it and loose enough not to be shed.  The long route's
    placements equal an uninterrupted run of the port's scheduler."""
    engines = engine_pair(None, policy="edf", slots=2, chunk=8,
                          min_bucket=16, laxity_s=1e-4, aging_credit=0.0)
    eng = engines[1]
    service_long = eng._bucket(n_long) * eng.svc
    arrive = arrive_frac * service_long
    jobs = [(n_long, 0.0, 10.0 + service_long),
            (n_short, arrive, arrive + eng._bucket(n_short) * eng.svc
             + 3 * eng.cfg.chunk * eng.svc)]
    (_, r_long), (_, r_short) = submit_pair(engines, jobs, seed)
    for e in engines:
        e.run_until_done()
    assert r_long.status == COMPLETED and r_short.status == COMPLETED
    assert_same_serving(*engines, {0: route_pair(n_long, seed)[0],
                                   1: route_pair(n_short, seed + 1)[0]})
    run = make_schedule_fn(eng.spec, BACKLOG)
    _, recs = run(PARAMS, pad_task_arrays(route_pair(n_long, seed)[1],
                                          r_long.bucket))
    np.testing.assert_array_equal(r_long.summary["placements"],
                                  recs.action[:n_long].numpy())
    assert r_long.summary["stm_rate"] == \
        recs.met[:n_long].sum().item() / n_long
    return eng.preemption_count


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_preemption_roundtrip_bit_exact_seeded(seed):
    rng = np.random.default_rng(3000 + seed)
    _roundtrip(n_long=int(rng.integers(33, 65)),
               n_short=int(rng.integers(4, 17)),
               arrive_frac=float(rng.uniform(0.1, 0.6)), seed=seed)


def test_preemption_actually_fires():
    assert _roundtrip(n_long=64, n_short=8, arrive_frac=0.3, seed=0) >= 1


# ---------------------------------------------------------------------------
# deterministic spot checks
# ---------------------------------------------------------------------------

def test_stats_mid_drain_honest(fixed_seed):
    """Mid-drain ``stats()`` counts resolved requests only: queued and
    in-flight work is reported beside them."""
    engines = engine_pair(policy="edf", slots=1, chunk=16, min_bucket=16,
                          preempt=False, shed=False)
    svc = engines[1].svc
    (_, tight), *_ = submit_pair(
        engines, [(16, 0.0, 0.5 * 16 * svc)] + [(16, 0.0, 100.0)] * 3,
        fixed_seed)
    for eng in engines:
        eng._run_wave(eng._next_wave())  # serve only the tight head
    assert tight.status == COMPLETED and tight.slack < 0.0
    s = engines[1].stats()
    assert s == engines[0].stats()
    assert (s["submitted"], s["resolved"], s["completed"]) == (4, 1, 1)
    assert (s["queued"], s["in_flight"], s["miss_rate"]) == (3, 0, 1.0)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    done = engines[1].stats()
    assert done["resolved"] == 4 and done["queued"] == 0
    assert done["miss_rate"] == pytest.approx(1 / 4)


def test_stats_counts_in_flight_lanes(fixed_seed):
    """A continuous wave halted after one segment (the durability
    layer's ``_halt``): its occupants are in flight, neither resolved
    nor queued."""
    kw = dict(policy="edf", slots=2, chunk=16, min_bucket=16,
              preempt=False, shed=False, continuous=True)
    engines = engine_pair(**kw)
    submit_pair(engines, [(60, 0.0, 100.0)] * 3, fixed_seed)
    for eng in engines:
        wave = eng._next_wave()
        eng._after_segment = lambda w, e=eng: setattr(e, "_halt", True)
        eng._run_wave(wave)   # one segment, then the halt
        assert eng._halt and wave.requests == [r for r in wave.lane_requests
                                               if r is not None]
    s = engines[1].stats()
    assert s == engines[0].stats()
    assert s["in_flight"] == 2 and s["queued"] == 1
    assert s["resolved"] == 0 and s["miss_rate"] == 0.0
    for eng in engines:
        eng.run_until_done()   # a halted engine serves no further round
    assert engines[1].stats() == s == engines[0].stats()


def test_refilled_lane_state_is_reinitialized(fixed_seed):
    """A request admitted by refill gets a fresh state row: its
    placements equal serving it alone on a fresh engine."""
    kw = dict(policy="edf", slots=1, chunk=8, min_bucket=16, preempt=False,
              shed=False, continuous=True)
    engines = engine_pair(None, **kw)
    handles = submit_pair(engines, [(16, 0.0, 100.0)] * 2, fixed_seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines, {i: route_pair(16, fixed_seed + i)[0]
                                   for i in range(2)})
    assert engines[1].stats()["refills"] >= 1  # b rode a's wave by refill
    for i, (_, req) in enumerate(handles):
        assert req.status == COMPLETED
        solo = engine_pair(None, **kw)[1]
        ref = solo.submit(route_pair(16, fixed_seed + i)[1], arrival=0.0,
                          deadline=100.0)
        solo.run_until_done()
        np.testing.assert_array_equal(req.summary["placements"],
                                      ref.summary["placements"])
        assert req.summary["stm_rate"] == ref.summary["stm_rate"]


def test_wave_inherits_aging_credit(fixed_seed):
    """A passed-over request keeps its earned aging credit when packed:
    the wave's counter starts at the member's."""
    engines = engine_pair(policy="edf", slots=1, chunk=16, min_bucket=16,
                          preempt=False, shed=False)
    handles = submit_pair(engines, [(10, 0.0, 1.0), (10, 0.0, 2.0),
                                    (10, 0.0, 5.0)], fixed_seed)
    waves = []
    for eng in engines:
        eng._run_wave(eng._next_wave())
        eng._run_wave(eng._next_wave())
        waves.append(eng._next_wave())
    loose = handles[2][1]
    assert [r.uid for r in waves[1].requests] == [loose.uid] == \
        [r.uid for r in waves[0].requests]
    assert waves[1].waves_waited == loose.waves_waited == 2 == \
        waves[0].waves_waited


def test_set_health_shrinks_admission(fixed_seed):
    """A route that fits the healthy pool is shed, before any dispatch,
    once ``set_health`` leaves one core; an all-ones row restores the
    healthy cost exactly."""
    engines = engine_pair(policy="edf", chunk=16, min_bucket=16)
    eng = engines[1]
    deadline = 2.0 * 16 * eng.svc
    healthy_need = eng._service_need(16)
    assert healthy_need < deadline
    h = np.zeros(eng.spec.n)
    h[0] = 1.0                    # one survivor carries the whole pool
    for e in engines:
        e.set_health(h)
    assert eng.svc_scale == engines[0].svc_scale > 1.0
    assert eng._service_need(16) > healthy_need
    ((_, doomed),) = submit_pair(engines, [(16, 0.0, deadline)], fixed_seed)
    for e in engines:
        e.run_until_done()
    assert_same_serving(*engines)
    assert doomed.status == SHED
    assert eng.dead_letter == engines[0].dead_letter
    assert eng.dead_letter[0]["reason"] == "infeasible"
    assert eng.dispatches == 0
    eng.set_health(np.ones(eng.spec.n))
    assert eng.svc == eng.base_svc
    assert eng._service_need(16) == healthy_need


def test_shed_goes_to_dead_letter(fixed_seed):
    engines = engine_pair(policy="edf", chunk=16, min_bucket=16)
    svc = engines[1].svc
    (_, doomed), (_, ok) = submit_pair(
        engines, [(16, 0.0, 0.25 * 16 * svc), (16, 0.0, 10.0)], fixed_seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    eng = engines[1]
    assert doomed.status == SHED and ok.status == COMPLETED
    assert [d["uid"] for d in eng.dead_letter] == [doomed.uid]
    assert eng.dead_letter == engines[0].dead_letter
    assert eng.dead_letter[0]["reason"] == "infeasible"


@pytest.mark.parametrize("policy,want", [
    ("fifo", [[0, 3], [1, 2]]),   # submit order; the head picks the bucket
    ("edf", [[3, 0], [1, 2]])])   # the tight bucket-64 head goes first
def test_admission_order(policy, want, fixed_seed):
    engines = engine_pair(policy=policy, slots=2, chunk=16, min_bucket=16,
                          **({} if policy == "fifo" else
                             dict(preempt=False, shed=False)))
    submit_pair(engines, [(60, 0.0, 100.0), (10, 0.0, 1.0), (12, 0.0, 2.0),
                          (50, 0.0, 0.5)], fixed_seed)
    for eng in engines:
        eng.run_until_done()
    assert_same_serving(*engines)
    assert engines[1].wave_log == want
