"""The port's heuristic scans (worst, ATA, Min-Min) and its copies of the
NumPy loop schedulers, against the JAX package's.

The scans are deterministic, so placements and every record field must
equal the JAX scans' exactly, single route and batched, with ``state0``,
an ``alive`` mask, a ``health`` trace and padding.  The one exception is
the running ``R_Balance`` (and the summary's ``r_balance`` and
``gvalue`` built from it): the JAX scans run under ``jit``, where XLA
contracts ``a * b + c`` into an FMA and moves its last bit, so it is
held at rtol 1e-6.  Min-Min's incremental completion-time carry must
equal its rebuild exactly, and the loop copies must equal the originals
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import hmai as hmai_jax
from repro.core import platform_jax as pj
from repro.core.schedulers import get_scheduler as get_scheduler_jax
from repro.core.schedulers import scan as scan_jax
from repro.core.tasks import Task as TaskJax
from repro.core.tasks import TaskKind as KindJax
from repro.core.tasks import pad_task_arrays as pad_jax
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro_torch.core import environment as env_t
from repro_torch.core import hmai as hmai_t
from repro_torch.core import platform as pt
from repro_torch.core.schedulers import (SCAN_SCHEDULERS, get_scan_scheduler,
                                         get_scheduler, scan_schedule)
from repro_torch.core.tasks import (Task, TaskKind, stack_task_arrays,
                                    tasks_to_arrays)

RATE = 0.012
SMALL = dict(route_km=0.01, rate_scale=RATE, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)
NAMES = ["worst", "ata", "minmin"]
LAST_BIT = ("R_Balance",)


def _queue_pair(seed):
    return (env_jax.build_task_queue(
                env_jax.EnvironmentParams(seed=seed, **SMALL)),
            env_t.build_task_queue(env_t.EnvironmentParams(seed=seed,
                                                           **SMALL)))


def _specs():
    return (pj.spec_from_platform(hmai_jax.HMAIPlatform(capacity_scale=RATE)),
            pt.spec_from_platform(hmai_t.HMAIPlatform(capacity_scale=RATE)))


def _trace(t, n, seed):
    """A trace with a dead core, a throttled one and a recovery."""
    rng = np.random.default_rng(seed)
    h = np.ones((t, n), np.float32)
    a, b = sorted(rng.integers(1, t, 2))
    h[a:b, rng.integers(0, n)] = 0.0
    h[b // 2:, rng.integers(0, n)] = np.float32(rng.uniform(0.25, 0.75))
    return h


def _jax_scan(name, window=8, **kw):
    fn = scan_jax.SCAN_SCHEDULERS[name]
    if name == "minmin":
        kw["window"] = window
    return jax.jit(lambda spec, ta, state0, alive, health: fn(
        spec, ta, state0=state0, alive=alive, health=health, **kw))


def _port_kw(name, window=8):
    return {"window": window} if name == "minmin" else {}


def _assert_same(final_t, recs_t, final_j, recs_j, spec_t, spec_j):
    for f in recs_j._fields:
        np.testing.assert_array_equal(getattr(recs_t, f).cpu().numpy(),
                                      np.asarray(getattr(recs_j, f)),
                                      err_msg=f"record {f}")
    for f in final_j._fields:
        got, want = getattr(final_t, f).cpu().numpy(), \
            np.asarray(getattr(final_j, f))
        if f in LAST_BIT:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"state {f}")
    s_t = pt.summarize(spec_t, final_t, recs_t)
    s_j = pj.summarize(spec_j, final_j, recs_j)
    for k in s_j:
        if k in ("r_balance", "gvalue"):
            assert s_t[k] == pytest.approx(s_j[k], rel=1e-6), k
        else:
            assert s_t[k] == s_j[k], k


@pytest.mark.parametrize("faulty", [False, True], ids=["healthy", "trace"])
@pytest.mark.parametrize("name", NAMES)
def test_scan_matches_jax_single_route(name, faulty):
    qj, qt = _queue_pair(3)
    spec_j, spec_t = _specs()
    h = _trace(len(qt), spec_t.n, 4) if faulty else None
    final_j, recs_j = _jax_scan(name)(
        spec_j, arrays_jax(qj), None, None,
        None if h is None else jnp.asarray(h))
    final_t, recs_t = get_scan_scheduler(name)(
        spec_t, tasks_to_arrays(qt), health=h, **_port_kw(name))
    assert len(qt) > 60
    _assert_same(final_t, recs_t, final_j, recs_j, spec_t, spec_j)


@pytest.mark.parametrize("name", NAMES)
def test_batched_scan_with_state0_alive_health_and_padding(name):
    """Two routes of different lengths in one batch (the shorter padded),
    each resumed from a state0, under an alive mask and its own trace:
    each route equals the JAX scan of that padded route alone."""
    spec_j, spec_t = _specs()
    n = spec_t.n
    pairs = [_queue_pair(s) for s in (5, 6)]
    tas_j = [arrays_jax(qj) for qj, _ in pairs]
    t_max = max(ta.num_tasks for ta in tas_j)
    alive = np.ones(n, bool)
    alive[[1, 7]] = False
    # state0: each route's first 20 tasks scheduled by ATA
    pre_j = [scan_jax.get_scan_scheduler("ata")(
        spec_j, arrays_jax(qj[:20]))[0] for qj, _ in pairs]
    pre_t = pt.stack_states([get_scan_scheduler("ata")(
        spec_t, tasks_to_arrays(qt[:20]))[0] for _, qt in pairs])
    traces = [_trace(t_max, n, s) for s in (7, 8)]
    batch = stack_task_arrays([tasks_to_arrays(qt) for _, qt in pairs])
    assert batch.arrival.shape == (2, t_max)
    finals, recs = SCAN_SCHEDULERS[name](
        spec_t, batch, state0=pre_t, alive=torch.as_tensor(alive),
        health=np.stack(traces), **_port_kw(name))
    fn_j = _jax_scan(name)
    for r, ta_j in enumerate(tas_j):
        final_j, recs_j = fn_j(spec_j, pad_jax(ta_j, t_max), pre_j[r],
                               jnp.asarray(alive), jnp.asarray(traces[r]))
        _assert_same(pt.route(finals, r), pt.route(recs, r), final_j,
                     recs_j, spec_t, spec_j)
        placed = pt.route(recs, r).action.numpy()
        assert not np.isin(placed, [1, 7]).any()


def _identical_tasks(mod, kind, n):
    return [mod(uid=i, kind=kind, camera_group="FC", camera_id=0,
                arrival_time=0.0, safety_time=0.05) for i in range(n)]


@pytest.mark.parametrize("name", ["ata", "minmin"])
def test_all_equal_completion_time_tiebreak(name):
    """45 identical tasks tie on completion time across every row: the
    flat argmin must take the first occurrence (row-major), like the
    loop's strict-< first hit and the JAX scan."""
    q_t = _identical_tasks(Task, TaskKind.YOLO, 45)
    q_j = _identical_tasks(TaskJax, KindJax.YOLO, 45)
    plat = hmai_t.HMAIPlatform()
    loop = get_scheduler(name).schedule(plat, q_t)
    loop_actions = np.asarray([r.accel_index for r in plat.records])
    scan = scan_schedule(name, hmai_t.HMAIPlatform(), q_t, device="cpu")
    want = scan_jax.scan_schedule(name, hmai_jax.HMAIPlatform(), q_j)
    np.testing.assert_array_equal(scan["placements"], loop_actions)
    np.testing.assert_array_equal(scan["placements"], want["placements"])
    assert scan["stm_rate"] == want["stm_rate"] == loop["stm_rate"]
    assert scan["makespan_s"] == want["makespan_s"]


@pytest.mark.parametrize("window", [8, 30])
def test_minmin_incremental_matches_rebuild(window):
    _, qt = _queue_pair(9)
    _, spec_t = _specs()
    h = _trace(len(qt), spec_t.n, 10)
    ta = tasks_to_arrays(qt)
    runs = [get_scan_scheduler("minmin")(spec_t, ta, window=window,
                                         incremental=inc, health=h)
            for inc in (True, False)]
    (fa, ra), (fb, rb) = runs
    for a, b in zip((*fa, *ra), (*fb, *rb)):
        assert torch.equal(a, b)


def test_minmin_all_scheduled_window_is_a_noop():
    """A route padded by whole windows: the padding windows' steps are
    masked no-ops, so the state equals the unpadded route's."""
    _, qt = _queue_pair(11)
    _, spec_t = _specs()
    ta = tasks_to_arrays(qt)
    batch = stack_task_arrays([ta, tasks_to_arrays(qt[:10])])
    finals, recs = SCAN_SCHEDULERS["minmin"](spec_t, batch, window=8)
    short, _ = get_scan_scheduler("minmin")(spec_t, tasks_to_arrays(qt[:10]),
                                            window=8)
    for a, b in zip(pt.route(finals, 1), short):
        assert torch.equal(a, b)
    assert int(recs.valid[1].sum()) == 10


@pytest.mark.parametrize("name", ["ata", "minmin", "ga", "sa"])
def test_loop_scheduler_copies_match_the_originals(name):
    qj, qt = _queue_pair(12)
    p_j = hmai_jax.HMAIPlatform(capacity_scale=RATE)
    p_t = hmai_t.HMAIPlatform(capacity_scale=RATE)
    kw = {"ga": dict(generations=3), "sa": dict(iters=20)}.get(name, {})
    s_j = get_scheduler_jax(name, **kw).schedule(p_j, qj)
    s_t = get_scheduler(name, **kw).schedule(p_t, qt)
    assert ([r.accel_index for r in p_t.records]
            == [r.accel_index for r in p_j.records])
    for k in s_j:
        if not k.startswith("schedule_time"):
            assert s_t[k] == s_j[k], k


def test_registry_and_scan_schedule_surface():
    from repro_torch.core import schedulers
    for name in ("worst", "ata", "minmin", "ga", "sa", "ga_scan",
                 "sa_scan"):
        assert name in schedulers.SCHEDULERS
    assert set(SCAN_SCHEDULERS) == {"worst", "ata", "minmin"}
    qj, qt = _queue_pair(13)
    got = scan_schedule("ata", hmai_t.HMAIPlatform(capacity_scale=RATE), qt,
                        device="cpu")
    want = scan_jax.scan_schedule(
        "ata", hmai_jax.HMAIPlatform(capacity_scale=RATE), qj)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["placements"], want["placements"])
    assert got["stm_rate"] == want["stm_rate"]


@pytest.mark.parametrize("window", [8, 30, 200])
def test_task_helpers_match_jax(window):
    from repro.core import tasks as tasks_jax
    from repro_torch.core import tasks as tasks_t
    qj, qt = _queue_pair(14)
    ta_j, ta_t = arrays_jax(qj), tasks_to_arrays(qt)
    got = tasks_t.window_task_arrays(ta_t, window)
    want = tasks_jax.window_task_arrays(ta_j, window)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    both = tasks_t.window_task_arrays(stack_task_arrays([ta_t, ta_t]),
                                      window)
    assert torch.equal(both.arrival[1], got.arrival)
    assert {k.value: v for k, v in tasks_t.TABLE5_FPS.items()} == \
        {k.value: v for k, v in tasks_jax.TABLE5_FPS.items()}
    for k in TaskKind:
        assert tasks_t.kind_period_s(k) == tasks_jax.kind_period_s(
            KindJax(k.value))
    np.testing.assert_array_equal(tasks_t.kind_period_table(),
                                  tasks_jax.kind_period_table())
    for scale in (1.0, 0.5):
        assert tasks_t.route_deadline_budget(ta_t, scale) == \
            tasks_jax.route_deadline_budget(ta_j, scale)


def test_platform_snapshot_helpers_match_jax():
    qj, qt = _queue_pair(15)
    p_j = hmai_jax.HMAIPlatform(capacity_scale=RATE)
    p_t = hmai_t.HMAIPlatform(capacity_scale=RATE)
    get_scheduler_jax("ata").schedule(p_j, qj)
    get_scheduler("ata").schedule(p_t, qt)
    s_t, s_j = pt.state_from_platform(p_t), pj.state_from_platform(p_j)
    for f in s_j._fields:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s_j, f)), f)
    # the snapshot resumes the scan where the loop left off, and restores
    fresh = hmai_t.HMAIPlatform(capacity_scale=RATE)
    pt.state_to_platform(s_t, fresh)
    for f in ("avail", "busy", "E", "T", "MS", "R_Balance", "num_tasks"):
        np.testing.assert_array_equal(getattr(fresh, f),
                                      getattr(s_t, f).numpy(), f)
    assert fresh._e_scale == float(s_t.e_scale) == np.float32(p_t._e_scale)
    stacked = pt.stack_states([s_t, s_t])
    assert stacked.avail.shape == (2, p_t.n) and stacked.e_scale.shape == (2,)
    _, spec_t = _specs()
    final, _ = SCAN_SCHEDULERS["ata"](spec_t, stack_task_arrays(
        [tasks_to_arrays(qt[:5])] * 2), state0=stacked)
    assert torch.equal(final.avail[0], final.avail[1])
    assert (final.num_tasks.sum(-1) == len(qt) + 5).all()
    tab_t = pt.spec_from_tables(p_t.exec_time_table, p_t.energy_table)
    tab_j = pj.spec_from_tables(p_j.exec_time_table, p_j.energy_table)
    for f in tab_j._fields:
        np.testing.assert_array_equal(getattr(tab_t, f).numpy(),
                                      np.asarray(getattr(tab_j, f)), f)
