"""The port's fault model (``core/faults.py``) and the health-aware FlexAI
engine, against the JAX package's.

Traces, random schedules and per-window rows are equal exactly.  The
replay is deterministic: records equal exactly, the state's running
``R_Balance`` at rtol 1e-6 (the JAX replay runs under ``jit``, where XLA
contracts ``a * b + c`` into an FMA).  Greedy placements under a trace
follow ``tests/test_torch_engine.py``'s rule: equal, or at a first
difference JAX's Q margin between the two alive choices is below 1e-5.
The degradation trainer is held to the JAX trainer's trajectory with the
JAX trainer's own draws injected, at that file's trainer tolerances.
A ``health=None`` call must equal an all-ones trace bit for bit, in
every engine, also from a ``state0`` with dead and throttled cores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import faults as faults_jax
from repro.core import hmai as hmai_jax
from repro.core import platform_jax as pj
from repro.core.flexai import FlexAIConfig as ConfigJax
from repro.core.flexai import dqn as dqn_jax
from repro.core.flexai import engine as engine_jax
from repro.core.tasks import pad_task_arrays as pad_jax
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro_torch.core import environment as env_t
from repro_torch.core import faults
from repro_torch.core import hmai as hmai_t
from repro_torch.core import platform as pt
from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai import engine as engine_t
from repro_torch.core.schedulers import (SCAN_SCHEDULERS, GAConfig,
                                         SAConfig, make_metaheuristic_fn)
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays

RATE = 0.012
SMALL = dict(route_km=0.01, rate_scale=RATE, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)
MARGIN = 1e-5
N = 11


def _queue_pair(seed):
    return (env_jax.build_task_queue(
                env_jax.EnvironmentParams(seed=seed, **SMALL)),
            env_t.build_task_queue(env_t.EnvironmentParams(seed=seed,
                                                           **SMALL)))


def _platforms():
    return (hmai_jax.HMAIPlatform(capacity_scale=RATE),
            hmai_t.HMAIPlatform(capacity_scale=RATE))


def _events_tuple(events):
    return [(e.step, e.core, e.factor) for e in events]


@pytest.mark.parametrize("seed,n_steps,n_faults,recover", [
    (0, 200, 2, True), (1, 60, 3, False), (7, 1000, 10, True),
    (13, 5, 1, True), (3, 120, 20, True)])
def test_random_fault_events_and_trace_match_jax(seed, n_steps, n_faults,
                                                 recover):
    got = faults.random_fault_events(seed, n_steps, N, n_faults=n_faults,
                                     recover=recover)
    want = faults_jax.random_fault_events(seed, n_steps, N,
                                          n_faults=n_faults, recover=recover)
    assert _events_tuple(got) == _events_tuple(want)
    np.testing.assert_array_equal(
        faults.build_health_trace(n_steps, N, got),
        faults_jax.build_health_trace(n_steps, N, want))
    np.testing.assert_array_equal(faults.healthy_trace(n_steps, N),
                                  faults_jax.healthy_trace(n_steps, N))


def test_build_health_trace_carries_forward_and_rejects_bad_cores():
    ev = [faults.FaultEvent(5, 2, 0.0), faults.FaultEvent(3, 1, 0.5),
          faults.FaultEvent(8, 2, 1.0), faults.FaultEvent(12, 0, 0.0)]
    tr = faults.build_health_trace(10, 4, ev)
    assert tr[:5, 2].tolist() == [1.0] * 5 and tr[5:8, 2].tolist() == [0.0] * 3
    assert tr[8:, 2].tolist() == [1.0, 1.0] and tr[3:, 1].min() == 0.5
    assert (tr[:, 0] == 1.0).all()          # step 12 lies past the route
    np.testing.assert_array_equal(
        tr, faults_jax.build_health_trace(
            10, 4, [faults_jax.FaultEvent(*e) for e in ev]))
    with pytest.raises(ValueError, match="out of range"):
        faults.build_health_trace(10, 4, [faults.FaultEvent(1, 4, 0.0)])


@pytest.mark.parametrize("t,window", [(30, 8), (32, 8), (7, 30), (61, 30)])
def test_window_health_matches_jax(t, window):
    tr = faults.build_health_trace(
        t, N, faults.random_fault_events(t, t, N, n_faults=4))
    got = faults.window_health(torch.from_numpy(tr), window)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(faults_jax.window_health(tr, window)))
    batched = faults.window_health(torch.from_numpy(np.stack([tr, tr])),
                                   window)
    assert torch.equal(batched[1], got)


def _trace(t, seed):
    return faults.build_health_trace(
        t, N, faults.random_fault_events(seed, t, N, n_faults=3))


def test_replay_actions_matches_jax_single_and_batched():
    pairs = [_queue_pair(s) for s in (21, 22)]
    plat_j, plat_t = _platforms()
    spec_j, spec_t = pj.spec_from_platform(plat_j), pt.spec_from_platform(
        plat_t)
    t_max = max(len(qt) for _, qt in pairs)
    rng = np.random.default_rng(0)
    actions = rng.integers(0, N, (2, t_max))
    traces = np.stack([_trace(t_max, s) for s in (1, 2)])
    batch = stack_task_arrays([tasks_to_arrays(qt) for _, qt in pairs])
    finals, recs = faults.replay_actions(spec_t, batch, actions, traces)
    for r, (qj, qt) in enumerate(pairs):
        t = len(qt)
        single = faults.replay_actions(spec_t, tasks_to_arrays(qt),
                                       actions[r, :t], traces[r, :t])
        for ta_j, t_j, got_f, got_r in (
                (pad_jax(arrays_jax(qj), t_max), t_max, pt.route(finals, r),
                 pt.route(recs, r)),
                (arrays_jax(qj), t, *single)):
            final_j, recs_j = faults_jax.replay_actions(
                spec_j, ta_j, jnp.asarray(actions[r, :t_j]),
                jnp.asarray(traces[r, :t_j]))
            for f in recs_j._fields:
                np.testing.assert_array_equal(
                    getattr(got_r, f).numpy(),
                    np.asarray(getattr(recs_j, f)), err_msg=f)
            for f in final_j._fields:
                got = getattr(got_f, f).numpy()
                want = np.asarray(getattr(final_j, f))
                if f == "R_Balance":
                    np.testing.assert_allclose(got, want, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=f)
    # a dead-core pick pays the HEALTH_FLOOR penalty
    dead = np.asarray(traces[0, np.arange(t_max), actions[0]] == 0.0)
    dead &= batch.valid[0].numpy()
    assert dead.any()
    table = spec_t.exec_time.numpy()[actions[0], batch.kind[0].numpy()]
    np.testing.assert_allclose(recs.exec_time[0].numpy()[dead],
                               table[dead] / pt.HEALTH_FLOOR, rtol=1e-6)


def _weights(seed=0):
    return dqn_jax.init_qnet(jax.random.PRNGKey(seed), 3 + 5 * N, N)


def _assert_same_placements(got, want, params_j, spec_j, ta_j, health):
    """Equal placements, or a first difference where JAX's own Q values
    of the two (alive) choices are within MARGIN."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)[0]
    if len(diff) == 0:
        return
    k = int(diff[0])
    sched = engine_jax.make_schedule_fn(spec_j)
    state = (pj.platform_init(spec_j.n) if k == 0 else sched(
        params_j, type(ta_j)(*[jnp.asarray(f)[:k] for f in ta_j]), None,
        jnp.asarray(health[:k]))[0])
    state = pj.with_health(state, jnp.asarray(health[k]))
    sv = pj.state_vector(spec_j, jnp.asarray(pj.kind_feature_table()), 1.0,
                         state, type(ta_j)(*[jnp.asarray(f)[k]
                                             for f in ta_j]))
    q = np.asarray(dqn_jax.qnet_apply(params_j, sv))
    assert health[k, got[k]] > 0, f"placement {k} on a dead core"
    margin = q[want[k]] - q[got[k]]
    assert margin < MARGIN, (
        f"placement {k} differs ({got[k]} vs JAX {want[k]}) with a JAX Q "
        f"margin of {margin}")


def test_health_aware_greedy_schedule_matches_jax_single_and_batched():
    params_j = _weights(0)
    params_t = dqn_t.params_from_numpy(params_j)
    plat_j, plat_t = _platforms()
    spec_j, spec_t = pj.spec_from_platform(plat_j), pt.spec_from_platform(
        plat_t)
    pairs = [_queue_pair(s) for s in (8, 12)]
    t_max = max(len(qt) for _, qt in pairs)
    traces = [_trace(t_max, s) for s in (3, 4)]
    single_j = engine_jax.make_schedule_fn(spec_j)
    single_t = engine_t.make_schedule_fn(spec_t)
    batch = stack_task_arrays([tasks_to_arrays(qt) for _, qt in pairs])
    _, recs_b = engine_t.make_schedule_fn(spec_t, batched=True)(
        params_t, batch, health=np.stack(traces))
    for r, ((qj, qt), h) in enumerate(zip(pairs, traces)):
        ta_j = pad_jax(arrays_jax(qj), t_max)
        _, recs_j = single_j(params_j, ta_j, None, jnp.asarray(h))
        want = np.asarray(recs_j.action)
        _, recs_t = single_t(params_t, tasks_to_arrays(qt),
                             health=h[:len(qt)])
        _assert_same_placements(recs_t.action.numpy(), want[:len(qt)],
                                params_j, spec_j, ta_j, h)
        _assert_same_placements(recs_b.action[r].numpy(), want, params_j,
                                spec_j, ta_j, h)
        assert (h[np.arange(t_max), recs_b.action[r].numpy()] > 0).all()


def test_masked_greedy_run_matches_jax():
    params_j = _weights(2)
    params_t = dqn_t.params_from_numpy(params_j)
    plat_j, plat_t = _platforms()
    spec_j, spec_t = pj.spec_from_platform(plat_j), pt.spec_from_platform(
        plat_t)
    qj, qt = _queue_pair(14)
    alive = np.ones(N, bool)
    alive[[0, 4, 9]] = False
    _, recs_j = jax.jit(engine_jax._schedule_run_masked(spec_j, 1.0))(
        params_j, arrays_jax(qj), None, jnp.asarray(alive))
    run = engine_t._schedule_run_masked(spec_t)
    ta = stack_task_arrays([tasks_to_arrays(qt)])
    _, recs_t = run(params_t, ta, alive=torch.as_tensor(alive))
    trace = np.broadcast_to(alive.astype(np.float32), (len(qt), N))
    _assert_same_placements(recs_t.action[0].numpy(),
                            np.asarray(recs_j.action), params_j, spec_j,
                            arrays_jax(qj), trace)
    _, recs_all = run(params_t, ta)
    _, recs_plain = engine_t.make_schedule_fn(spec_t, batched=True)(
        params_t, ta)
    assert torch.equal(recs_all.action, recs_plain.action)


def _jax_draws(key, t_len, n_actions, batch, sizes):
    """The JAX trainer's per-step draws (engine.py: split(key, 4) each
    step), regenerated outside the engine."""
    def step(key, size):
        key, k_eps, k_act, k_smp = jax.random.split(key, 4)
        return key, (jax.random.uniform(k_eps),
                     jax.random.randint(k_act, (), 0, n_actions),
                     jax.random.randint(k_smp, (batch,), 0,
                                        jnp.maximum(size, 1)))

    _, (u, act, idx) = jax.jit(lambda k, s: jax.lax.scan(step, k, s))(
        key, jnp.asarray(sizes, jnp.int32))
    return engine_t.Draws(*[torch.from_numpy(np.array(x))
                            for x in (u, act, idx)])


def test_degradation_trainer_matches_jax_trajectory_with_injected_draws():
    kw = dict(min_replay=16, batch_size=16, update_every=1,
              target_sync_every=8, replay_capacity=512, seed=5,
              eps_start=0.5)
    cfg_j, cfg_t = ConfigJax(**kw), FlexAIConfig(**kw)
    qj, qt = _queue_pair(2)
    plat_j, plat_t = _platforms()
    spec_j = pj.spec_from_platform(plat_j)
    t_len = len(qt)
    health = faults.build_health_trace(t_len, N, [
        faults.FaultEvent(10, 3, 0.0), faults.FaultEvent(20, 6, 0.4),
        faults.FaultEvent(30, 0, 0.0), faults.FaultEvent(70, 3, 1.0)])
    d = 3 + 5 * N
    ts_j = engine_jax.train_init(jax.random.PRNGKey(cfg_j.seed), d, N,
                                 cfg_j.replay_capacity)
    ts_jf, plat_jf, recs_j, losses_j, upd_j = engine_jax.make_train_fn(
        spec_j, cfg_j)(ts_j, arrays_jax(qj), health=jnp.asarray(health))
    sizes = np.minimum(np.arange(1, t_len + 1), cfg_t.replay_capacity)
    draws = _jax_draws(ts_j.key, t_len, N, cfg_t.batch_size, sizes)

    run = engine_t.make_train_fn(pt.spec_from_platform(plat_t), cfg_t)
    ts_t = engine_t.train_init(d, N, cfg_t.replay_capacity, device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p, opt=dqn_t.adam_init(p))
    ts_tf, plat_tf, recs_t, losses_t, upd_t = run(
        ts_t, tasks_to_arrays(qt), draws, health)

    upd_j = np.asarray(upd_j)
    assert ts_tf.updates == int(upd_j.sum()) > 50
    np.testing.assert_array_equal(recs_t.action.numpy(),
                                  np.asarray(recs_j.action))
    np.testing.assert_array_equal(upd_t.numpy(), upd_j)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-4, atol=1e-7)
    for got, want in zip(ts_tf.eval_p, ts_jf.eval_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert pt.summarize(pt.spec_from_platform(plat_t), plat_tf, recs_t)[
        "stm_rate"] == pj.summarize(spec_j, plat_jf, recs_j)["stm_rate"]
    # the greedy arm never picks a dead core: every dead pick is a draw
    acts = recs_t.action.numpy()
    on_dead = health[np.arange(t_len), acts] == 0.0
    explored = draws.explore_u.numpy() < np.asarray(
        engine_t._cadence(cfg_t, np.ones(t_len, bool), ts_t).eps)
    assert not (on_dead & ~explored).any()


def test_health_none_is_bit_identical_to_an_all_ones_trace():
    """``health=None`` runs no health op a step; an all-ones trace divides
    by exactly 1.0 and masks nothing, so both give the same bits."""
    kw = dict(min_replay=16, batch_size=16, update_every=2,
              target_sync_every=8, replay_capacity=256, seed=1)
    cfg = FlexAIConfig(**kw)
    _, plat_t = _platforms()
    spec = pt.spec_from_platform(plat_t)
    _, qt = _queue_pair(31)
    ones = np.ones((len(qt), N), np.float32)
    out = []
    for h in (None, ones):
        trainer = ScanFlexAI(plat_t, cfg, device="cpu")
        summ = trainer.train_episode(qt, health=h)
        out.append((summ, trainer.ts, trainer.schedule(qt, health=h)))
    (s0, ts0, g0), (s1, ts1, g1) = out
    assert s0 == s1 and g0["placements"].tolist() == g1["placements"].tolist()
    for a, b in zip(ts0.eval_p, ts1.eval_p):
        assert torch.equal(a, b)
    batch = stack_task_arrays([tasks_to_arrays(qt)] * 2)
    fn = engine_t.make_schedule_fn(spec, batched=True)
    (fa, ra), (fb, rb) = (fn(ts0.eval_p, batch, health=h) for h in
                          (None, np.stack([ones, ones])))
    for a, b in zip((*fa, *ra), (*fb, *rb)):
        assert torch.equal(a, b)


def _batched_engine(name, spec):
    """``run(tasks [R, T], state0, health)`` of one engine of the port."""
    if name in SCAN_SCHEDULERS:
        kw = {"window": 8} if name == "minmin" else {}
        return lambda ta, s0, h: SCAN_SCHEDULERS[name](
            spec, ta, state0=s0, health=h, **kw)
    if name in ("ga", "sa"):
        cfg = (GAConfig(window=8, population=6, generations=3) if name == "ga"
               else SAConfig(window=8, iters=12, chains=4))
        fn = make_metaheuristic_fn(spec, name, cfg, batched=True)
        return lambda ta, s0, h: fn(0, ta, s0, h)
    if name == "flexai":
        params = dqn_t.init_qnet(3 + 5 * N, N, torch.Generator().manual_seed(0))
        fn = engine_t.make_schedule_fn(spec, batched=True)
        return lambda ta, s0, h: fn(params, ta, s0, h)
    acts = torch.as_tensor(np.random.default_rng(0).integers(0, N, (2, 400)))
    return lambda ta, s0, h: faults.replay_actions(
        spec, ta, acts[:, :ta.arrival.shape[1]], h, s0)


@pytest.mark.parametrize("name", ["worst", "ata", "minmin", "ga", "sa",
                                  "flexai", "replay"])
def test_no_trace_equals_an_all_ones_trace_from_a_faulty_state0(name):
    """Without a trace an engine makes ``state0``'s cores healthy once
    (``faults.start_trace``) and runs no health op a step; that must give
    the bits of the JAX package's default, an all-ones row installed
    before every step, even when ``state0`` carries a dead core and a
    throttled one."""
    _, plat_t = _platforms()
    spec = pt.spec_from_platform(plat_t)
    _, qt = _queue_pair(33)
    pre = stack_task_arrays([tasks_to_arrays(qt[:20])] * 2)
    hrow = torch.ones(2, N)
    hrow[0, 3], hrow[1, 5] = 0.0, 0.5
    state0 = pt.with_health(SCAN_SCHEDULERS["ata"](spec, pre)[0], hrow)
    batch = stack_task_arrays([tasks_to_arrays(qt[20:])] * 2)
    assert batch.arrival.shape[1] > 60 and not state0.alive.all()
    ones = np.ones((*batch.arrival.shape, N), np.float32)
    run = _batched_engine(name, spec)
    (fa, ra), (fb, rb) = (run(batch, state0, h) for h in (None, ones))
    assert fa.alive.all() and (fa.cap == 1.0).all()
    for a, b in zip((*fa, *ra), (*fb, *rb)):
        assert torch.equal(a, b)
