"""The port's population trainer (``make_train_fn(..., batched=True)``,
``ScanFlexAI(lanes=L)``) against the JAX package's, with and without a
fault trace per lane, and its per-lane greedy evaluation (``_eval_stms``).

The JAX population is ``jax.vmap`` of the single-lane episode over
``train_init(k)`` for k in ``split(key, lanes)``: lane l draws from
``fold_in(split(key, lanes)[l], 1)`` with ``split(key, 4)`` a step.  The
test regenerates each lane's draws and injects them; weights come across
through ``params_from_numpy``.  Placements and update masks must be
equal; losses at rtol 1e-4 and final params within atol 1e-4, as the
single-lane trajectory test (``test_torch_engine.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import platform_jax as pj
from repro.core.flexai import FlexAIConfig as ConfigJax
from repro.core.flexai import ScanFlexAI as ScanJax
from repro.core.flexai import engine as engine_jax
from repro.core.tasks import stack_task_arrays as stack_jax
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro_torch.core import faults
from repro_torch.core import hmai as hmai_t
from repro_torch.core.flexai import FlexAIAgent, FlexAIConfig, ScanFlexAI
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai import engine as engine_t
from repro_torch.core.platform import spec_from_platform
from repro_torch.core.scenarios import scenario_batch, scenario_lane_batches
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
from test_torch_dp_trainer import A, D, RS, _platforms, _queue_pair
from test_torch_engine import _jax_draws
from test_torch_pipeline import one_torch_thread  # noqa: F401

KW = dict(min_replay=24, batch_size=16, update_every=2, eps_decay_steps=400,
          target_sync_every=16, replay_capacity=1024, eps_start=0.6)
SEEDS = (21, 22, 23)


def _population_pair(seed, health=None):
    """The JAX population's run and the port's inputs for the same run."""
    kw = dict(KW, seed=seed)
    cfg_j, cfg_t = ConfigJax(**kw), FlexAIConfig(**kw)
    pairs = [_queue_pair(s) for s in SEEDS]
    plat_j, plat_t = _platforms()
    lanes = len(SEEDS)
    ts_j = jax.vmap(lambda k: engine_jax.train_init(
        k, D, A, cfg_j.replay_capacity))(
        jax.random.split(jax.random.PRNGKey(seed), lanes))
    batch_j = stack_jax([arrays_jax(qj) for qj, _ in pairs])
    run_j = engine_jax.make_train_fn(pj.spec_from_platform(plat_j), cfg_j,
                                     batched=True)
    out_j = (run_j(ts_j, batch_j) if health is None else
             run_j(ts_j, batch_j, health=jnp.asarray(health)))
    batch_t = stack_task_arrays([tasks_to_arrays(qt) for _, qt in pairs])
    sizes = np.minimum(np.cumsum(batch_t.valid.numpy(), axis=1),
                       cfg_t.replay_capacity)
    per_lane = [_jax_draws(ts_j.key[i], batch_t.num_tasks, A,
                           cfg_t.batch_size, sizes[i]) for i in range(lanes)]
    draws = engine_t.Draws(*[torch.stack(d) for d in zip(*per_lane)])
    ts_t = engine_t.train_init(D, A, cfg_t.replay_capacity, lanes=lanes,
                               device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p)
    return out_j, (cfg_t, plat_t, ts_t, batch_t, draws)


def _health(batch_t):
    """A fault trace a lane (cores fail, degrade and recover at
    different steps on each lane; padding rows healthy)."""
    lanes, t_len = batch_t.arrival.shape
    return np.stack([faults.build_health_trace(
        t_len, A, faults.random_fault_events(7 + i, t_len, A))
        for i in range(lanes)]).astype(np.float32)


@pytest.mark.parametrize("with_health", [False, True],
                         ids=["clean", "fault-trace"])
def test_population_matches_jax_population(with_health):
    health = None
    if with_health:
        pairs = [_queue_pair(s) for s in SEEDS]
        health = _health(stack_task_arrays([tasks_to_arrays(qt)
                                            for _, qt in pairs]))
    (ts_jf, _, recs_j, loss_j, upd_j), (cfg, plat, ts_t, batch_t, draws) = \
        _population_pair(5, health)
    run = engine_t.make_train_fn(spec_from_platform(plat), cfg, batched=True,
                                 td_kernel=True)
    ts_tf, plat_tf, recs_t, loss_t, upd_t = run(ts_t, batch_t, draws, health)
    np.testing.assert_array_equal(recs_t.action.numpy(),
                                  np.asarray(recs_j.action))
    np.testing.assert_array_equal(upd_t.numpy(), np.asarray(upd_j))
    updates = np.asarray(ts_jf.updates)
    np.testing.assert_array_equal(ts_tf.updates, updates)
    assert (updates >= 50).all() and len(set(updates.tolist())) > 1
    np.testing.assert_array_equal(ts_tf.env_steps,
                                  np.asarray(ts_jf.env_steps))
    np.testing.assert_array_equal(ts_tf.opt.step.numpy(),
                                  np.asarray(ts_jf.opt.step))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4, atol=1e-7)
    for got, want in zip((*ts_tf.eval_p, *ts_tf.targ_p),
                         (*ts_jf.eval_p, *ts_jf.targ_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if with_health:   # the greedy arm never picks a dead core
        acts = recs_t.action.numpy()
        lane, t = np.indices(acts.shape)
        dead = health[lane, t, acts] == 0.0
        explored = draws.explore_u.numpy() < 0.6
        assert (health == 0.0).any() and not (dead & ~explored).any()


def test_population_lanes_do_not_interact():
    """Each lane of a population equals that lane trained alone (its
    net, draws and route on a population of one)."""
    _, (cfg, plat, ts_t, batch_t, draws) = _population_pair(9)
    run = engine_t.make_train_fn(spec_from_platform(plat), cfg, batched=True)
    ts_all, _, recs_all, loss_all, _ = run(ts_t, batch_t, draws)
    for i in (0, 2):
        sl = slice(i, i + 1)
        one = engine_t._lanes_of(ts_t._replace(generator=None), sl)
        ts_one, _, recs_one, loss_one, _ = run(
            one._replace(generator=ts_t.generator),
            type(batch_t)(*[f[sl] for f in batch_t]),
            engine_t.Draws(*[d[sl] for d in draws]))
        assert torch.equal(recs_one.action[0], recs_all.action[i])
        assert torch.equal(loss_one[0], loss_all[i])
        for a, b in zip(ts_one.eval_p, ts_all.eval_p):
            assert torch.equal(a[0], b[i])


def test_eval_stms_match_jax_per_lane():
    """One batched greedy run with each lane's net on the held-out queue:
    the JAX per-lane STMs."""
    lanes = 3
    qj, qt = _queue_pair(31)
    plat_j, plat_t = _platforms()
    cfg = dict(KW, seed=1)
    scan_j = ScanJax(plat_j, ConfigJax(**cfg), lanes=lanes)
    scan_t = ScanFlexAI(plat_t, FlexAIConfig(**cfg), lanes=lanes,
                        device="cpu")
    p = dqn_t.params_from_numpy(scan_j.ts.eval_p)
    scan_t.ts = scan_t.ts._replace(eval_p=p, targ_p=p)
    want = scan_j._eval_stms(arrays_jax(qj))
    got = scan_t._eval_stms(tasks_to_arrays(qt))
    assert len(got) == lanes and len(set(want)) > 1
    np.testing.assert_array_equal(got, want)
    for lane in range(lanes):
        assert scan_t.schedule(qt, lane=lane)["stm_rate"] == got[lane]


def test_population_wrapper_trains_and_selects_the_best_lane():
    """``ScanFlexAI(lanes=2)``: one summary a lane, eval STMs a lane, and
    the best lane's weights installed in every lane at the end."""
    queues = [_queue_pair(s)[1] for s in (21, 22, 23, 24)]
    trainer = ScanFlexAI(hmai_t.HMAIPlatform(capacity_scale=RS),
                         FlexAIConfig(**dict(KW, seed=3)), lanes=2,
                         device="cpu")
    hist = trainer.train(queues, episodes=2, eval_queue=_queue_pair(31)[1],
                         eval_every=2)
    assert [len(h["lanes"]) for h in hist] == [2, 2]
    assert len(hist[1]["eval_stm"]) == 2
    assert trainer.best_eval_stm == max(hist[1]["eval_stm"])
    w = trainer.ts.eval_p.w1
    assert torch.equal(w[0], w[1]) and torch.equal(w, trainer.ts.targ_p.w1)
    assert trainer.ts.opt.step.tolist() == [0, 0]


def test_degradation_fine_tune_over_scenario_lanes():
    """The JAX package's degradation fine-tune (``benchmarks/scenarios.py``):
    population lanes from an agent's weights, trained over the scenario
    fleet's lane batches with their health traces; the fleet's routes
    reach the trainer through ``scenario_lane_batches``."""
    plat = hmai_t.HMAIPlatform(capacity_scale=RS)
    agent = FlexAIAgent(plat, FlexAIConfig(**dict(KW, seed=4)),
                        device="cpu")
    base = tasks_to_arrays(_queue_pair(24)[1])
    fleet = scenario_batch(base, plat.n, seed=13, n_per_family=2)
    ft = FlexAIConfig(**dict(KW, eps_start=0.25, eps_end=0.02,
                             eps_decay_steps=200, min_replay=32, seed=47))
    trainer = ScanFlexAI.from_agent(agent, plat, lanes=4, cfg=ft,
                                    device="cpu")
    for a, b in zip(trainer.eval_params(3), agent.learner.eval_p):
        assert torch.equal(a, b)
    batches = list(scenario_lane_batches(fleet, 4))
    assert len(batches) == 2
    for tasks_l, health_l in batches:
        out = trainer.train_episode(tasks_l, health=health_l)
        assert len(out["lanes"]) == 4
    assert (trainer.ts.updates > 0).all()
    # a lane counts the valid tasks of its two scenarios (sensor dropout
    # removes some)
    np.testing.assert_array_equal(
        trainer.ts.env_steps,
        sum(t.valid.sum(1).numpy() for t, _ in batches))
    stms = trainer._eval_stms(base)
    assert len(stms) == 4 and all(0.0 <= s <= 1.0 for s in stms)
