"""The port's stage-level FlexAI trainers and ``PipelineFlexAI`` against
the JAX package's (``core/pipeline.py``), on ~100-task routes.

The JAX trainers draw from ``split(key, 4)`` at every flat step; the
random action is ``jax.random.choice`` over the step's stage group.  The
tests regenerate those draws outside the engines (DP lanes: lane 0 raw,
lane g ``fold_in(k, g)``; population lane l from its own key) and inject
them, and the weights come across through ``params_from_numpy``.  The
update masks and actions must be equal, the losses within rtol 1e-5 and
the final params within atol 1e-5.  The trainers run with
``td_kernel=True``, which on the CPU is the kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flexai import FlexAIConfig as ConfigJax
from repro.core.flexai import engine as engine_jax
from repro_torch.core.flexai import FlexAIConfig
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai import engine as engine_t
from test_torch_pipeline import (D, N, PLAT_J, PLAT_T, SPEC_J, SPEC_T,
                                 arrays_pair, assert_same_placements,
                                 pipe_jax, pipe_t, queue_pair, tasks_jax,
                                 tasks_t)
from test_torch_pipeline import one_torch_thread  # noqa: F401

KW = dict(min_replay=16, batch_size=16, update_every=2, eps_decay_steps=300,
          target_sync_every=8, replay_capacity=512, eps_start=0.6)
PLAN_J = pipe_jax.build_stage_plan(PLAT_J, 2)
PLAN_T = pipe_t.build_stage_plan(PLAT_T, 2)


def _flat_sizes(valid_flat, cap):
    return np.minimum(np.cumsum(valid_flat, axis=-1), cap)


def _step_draws(n_actions, batch, mask):
    maskf = jnp.asarray(mask, jnp.float32)

    def draw(k_eps, k_act, k_smp, size, s):
        mf = maskf[s]
        return (jax.random.uniform(k_eps),
                jax.random.choice(k_act, n_actions, p=mf / mf.sum()),
                jax.random.randint(k_smp, (batch,), 0,
                                   jnp.maximum(size, 1)))
    return draw


def jax_stage_draws(key, s_seq, sizes, batch, lanes=None):
    """The JAX stage trainers' draws: ``split(key, 4)`` a flat step, the
    action over the step's group.  With ``lanes`` the DP layout (lane 0
    raw, lane g ``fold_in(k, g)``; ``sizes`` [lanes, flat])."""
    draw = _step_draws(N, batch, np.asarray(PLAN_J.group_mask))
    gidx = jnp.arange(lanes or 1)

    def lane_keys(k):
        ks = jax.vmap(lambda g: jax.random.fold_in(k, g))(gidx)
        return jnp.where((gidx == 0)[:, None], k[None, :], ks)

    def step(key, x):
        size, s = x
        key, k_eps, k_act, k_smp = jax.random.split(key, 4)
        if lanes is None:
            return key, draw(k_eps, k_act, k_smp, size, s)
        return key, jax.vmap(draw, in_axes=(0, 0, 0, 0, None))(
            lane_keys(k_eps), lane_keys(k_act), lane_keys(k_smp), size, s)

    sizes = jnp.asarray(sizes if lanes is None else np.asarray(sizes).T,
                        jnp.int32)
    _, out = jax.jit(lambda k, x: jax.lax.scan(step, k, x))(
        key, (sizes, jnp.asarray(s_seq, jnp.int32)))
    if lanes is None:
        return engine_t.Draws(*[torch.from_numpy(np.array(x)) for x in out])
    u, act, idx = [np.array(x) for x in out]
    return engine_t.Draws(torch.from_numpy(u.T.copy()),
                          torch.from_numpy(act.T.copy()),
                          torch.from_numpy(idx.transpose(1, 0, 2).copy()))


def _flat_valid(ta_t):
    rows, s_seq = pipe_t._wavefront_stream(ta_t, 2)
    return rows.valid.numpy(), s_seq


def _assert_trajectory(out_t, out_j, updates):
    ts_t, _, recs_t, loss_t, upd_t = out_t
    ts_j, _, recs_j, loss_j, upd_j = out_j
    np.testing.assert_array_equal(recs_t.action.numpy(),
                                  np.asarray(recs_j.action))
    np.testing.assert_array_equal(upd_t.numpy(), np.asarray(upd_j))
    np.testing.assert_array_equal(np.asarray(ts_t.updates),
                                  np.asarray(ts_j.updates))
    assert (np.asarray(ts_t.updates) >= updates).all()
    np.testing.assert_array_equal(np.asarray(ts_t.env_steps),
                                  np.asarray(ts_j.env_steps))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-5, atol=1e-7)
    for got, want in zip((*ts_t.eval_p, *ts_t.targ_p),
                         (*ts_j.eval_p, *ts_j.targ_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(ts_t.replay.a.numpy(),
                                  np.asarray(ts_j.replay.a))


def test_single_lane_trainer_matches_jax():
    """One ~100-task route (202 flat steps): equal actions and update
    mask, ~90 updates through the fused entry point."""
    cfg_j, cfg_t = ConfigJax(**KW, seed=2), FlexAIConfig(**KW, seed=2)
    ta_j, ta_t = arrays_pair(30)
    ts_j = engine_jax.train_init(jax.random.PRNGKey(2), D, N,
                                 cfg_j.replay_capacity)
    out_j = pipe_jax.make_pipeline_train_fn(SPEC_J, PLAN_J, cfg_j)(ts_j,
                                                                   ta_j)
    valid, s_seq = _flat_valid(ta_t)
    draws = jax_stage_draws(ts_j.key, s_seq,
                            _flat_sizes(valid, cfg_t.replay_capacity),
                            cfg_t.batch_size)
    assert set(np.asarray(draws.action)[s_seq == 0].tolist()) <= set(
        np.nonzero(np.asarray(PLAN_J.group_mask[0]))[0].tolist())
    ts_t = engine_t.train_init(D, N, cfg_t.replay_capacity, device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p, opt=dqn_t.adam_init(p))
    run = pipe_t.make_pipeline_train_fn(SPEC_T, PLAN_T, cfg_t,
                                        td_kernel=True)
    out_t = run(ts_t, ta_t, draws)
    _assert_trajectory(out_t, out_j, 60)
    assert out_t[2].action.shape == (ta_t.num_tasks, 2)
    assert out_t[0].replay.size == int(valid.sum()) == out_t[0].env_steps


def test_population_trainer_matches_jax():
    """Three lanes on routes of different lengths (padded: the lanes'
    next valid steps sit at different stages near the end)."""
    seeds, lanes = (30, 34, 38), 3
    cfg_j, cfg_t = ConfigJax(**KW, seed=5), FlexAIConfig(**KW, seed=5)
    pairs = [arrays_pair(s) for s in seeds]
    ts_j = jax.vmap(lambda k: engine_jax.train_init(
        k, D, N, cfg_j.replay_capacity))(
        jax.random.split(jax.random.PRNGKey(5), lanes))
    batch_j = tasks_jax.stack_task_arrays([a for a, _ in pairs])
    out_j = pipe_jax.make_pipeline_train_fn(SPEC_J, PLAN_J, cfg_j,
                                            batched=True)(ts_j, batch_j)
    batch_t = tasks_t.stack_task_arrays([b for _, b in pairs])
    valid, s_seq = _flat_valid(batch_t)
    sizes = _flat_sizes(valid, cfg_t.replay_capacity)
    per_lane = [jax_stage_draws(ts_j.key[i], s_seq, sizes[i],
                                cfg_t.batch_size) for i in range(lanes)]
    draws = engine_t.Draws(*[torch.stack(d) for d in zip(*per_lane)])
    ts_t = engine_t.train_init(D, N, cfg_t.replay_capacity, lanes=lanes,
                               device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p)
    nv = pipe_t._next_valid_flat(valid)[0]
    assert len({tuple(s_seq[nv[:, i]]) for i in range(nv.shape[1])}) > 2
    out_t = pipe_t.make_pipeline_train_fn(SPEC_T, PLAN_T, cfg_t,
                                          batched=True,
                                          td_kernel=True)(ts_t, batch_t,
                                                          draws)
    _assert_trajectory(out_t, out_j, 50)
    np.testing.assert_array_equal(out_t[0].opt.step.numpy(),
                                  np.asarray(out_j[0].opt.step))


def test_dp_trainer_matches_jax():
    """One agent over three lanes: a grads launch for all lanes, the mean,
    one Adam step on the update-every crossing.  At ``update_every`` 6
    the episode makes ~90 updates, as the single-lane one does (at 2,
    three lanes cross a boundary almost every flat step: ~190 updates,
    and Adam grows the two packages' rounding to 6e-4 in the params by
    the end, the drift of ``scripts/dp_divergence.py``)."""
    seeds, lanes = (35, 48, 49), 3
    kw = dict(KW, update_every=6, seed=3)
    cfg_j, cfg_t = ConfigJax(**kw), FlexAIConfig(**kw)
    pairs = [arrays_pair(s) for s in seeds]
    ts_j = engine_jax.dp_train_init(jax.random.PRNGKey(3), D, N,
                                    cfg_j.replay_capacity, lanes)
    batch_j = tasks_jax.stack_task_arrays([a for a, _ in pairs])
    out_j = pipe_jax.make_pipeline_dp_train_fn(SPEC_J, PLAN_J, cfg_j,
                                               lanes)(ts_j, batch_j)
    batch_t = tasks_t.stack_task_arrays([b for _, b in pairs])
    valid, s_seq = _flat_valid(batch_t)
    draws = jax_stage_draws(ts_j.key, s_seq,
                            _flat_sizes(valid, cfg_t.replay_capacity),
                            cfg_t.batch_size, lanes=lanes)
    ts_t = engine_t.dp_train_init(D, N, cfg_t.replay_capacity, lanes,
                                  device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p, opt=dqn_t.adam_init(p))
    run = pipe_t.make_pipeline_dp_train_fn(SPEC_T, PLAN_T, cfg_t, lanes,
                                           td_kernel=True)
    out_t = run(ts_t, batch_t, draws)
    _assert_trajectory(out_t, out_j, 80)
    with pytest.raises(ValueError, match="route batch"):
        run(ts_t, tasks_t.stack_task_arrays([pairs[0][1]]), draws)


def test_default_draws_stay_inside_the_stage_group():
    """Without injected draws an episode draws from the trainer's
    generator: every explored action lies in its step's stage group, and
    the same seed gives the same episode."""
    # every step explores; no update is due (the draws are the subject)
    cfg = FlexAIConfig(**dict(KW, eps_start=1.0, eps_end=1.0,
                              min_replay=10_000), seed=1)
    ta = arrays_pair(34)[1]
    runs = []
    for _ in range(2):
        ts = engine_t.train_init(D, N, cfg.replay_capacity, seed=1,
                                 device="cpu")
        runs.append(pipe_t.make_pipeline_train_fn(SPEC_T, PLAN_T, cfg)(
            ts, ta))
    acts = runs[0][2].action.numpy()
    groups = PLAN_T.groups.numpy()
    assert (groups[acts] == np.arange(2)[None, :]).all()
    assert torch.equal(runs[0][2].action, runs[1][2].action)
    assert len(set(acts[:, 1].tolist())) > 1


@pytest.mark.parametrize("mode", ["single", "population", "dp"])
def test_pipeline_flexai_train_schedule_and_weights(mode, tmp_path):
    """``PipelineFlexAI`` in each mode trains (updates counted, one a flat
    step with any update), selects the best eval candidate, schedules
    [T, S] placements; weights saved by the port load into the JAX class
    and schedule the same placements (a Q tie's margin excepted), and the
    JAX class's weights load into the port."""
    lanes = 1 if mode == "single" else 2
    cfg = FlexAIConfig(**KW, seed=4)
    pipe = pipe_t.PipelineFlexAI(PLAT_T, cfg, n_stages=2, lanes=lanes,
                                 dp=mode == "dp", td_kernel=True,
                                 device="cpu")
    queues = [queue_pair(s)[1] for s in (30, 34, 38)]
    eval_j, eval_t = queue_pair(35)
    hist = pipe.train(queues, episodes=2, eval_queue=eval_t, eval_every=2)
    last = hist[-1]
    assert last["update_steps"] > 0 and len(pipe.losses) > 0
    assert pipe.best_eval_stm is not None
    if mode == "population":
        assert len(last["lanes"]) == lanes == len(last["eval_stm"])
        w = pipe.ts.eval_p.w1
        assert torch.equal(w[0], w[1])
    out = pipe.schedule(eval_t)
    assert out["placements"].shape == (len(eval_t), 2) and out["stages"] == 2
    path = str(tmp_path / "stage.npz")
    pipe.save_weights(path)
    pipe_j = pipe_jax.PipelineFlexAI(PLAT_J, ConfigJax(**KW, seed=4),
                                     n_stages=2)
    pipe_j.load_weights(path)
    want = pipe_j.schedule(eval_j)
    ta_j = tasks_jax.tasks_to_arrays(eval_j)
    assert_same_placements(PLAN_J, pipe_j.eval_params(), ta_j,
                           out["placements"], want["placements"])
    if np.array_equal(out["placements"], want["placements"]):
        assert out["stm_rate"] == want["stm_rate"]
    pipe_j.save_weights(str(tmp_path / "jax.npz"))
    back = pipe_t.PipelineFlexAI(PLAT_T, cfg, device="cpu")
    back.load_weights(str(tmp_path / "jax.npz"))
    for a, b in zip(back.eval_params(), pipe.eval_params()):
        assert torch.equal(a, b)
