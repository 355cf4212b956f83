"""The port's data-parallel trainer (``make_dp_train_fn``, ``ScanFlexAI(
dp=True)``, ``launch/train.py --dp``) against the JAX package's, and the
lane-batched TD entry points against ``jax.vmap`` of the JAX fused ones.

The JAX DP trainer draws from ``split(key, 4)`` at every step; lane 0
takes the step's keys raw and lane g > 0 ``fold_in(k, g)``.  The test
regenerates those draws outside the engine and injects them.  Weights
come across through ``params_from_numpy``.  Tolerances: placements and
update masks equal; losses and parameters within the JAX DP test's own
atol 1e-4 (``tests/test_dp_trainer.py``); the lane-batched TD entry
points at rtol 1e-5 / atol 1e-6, as the single-lane ones
(``test_torch_dqn_update.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import hmai as hmai_jax
from repro.core import platform_jax as pj
from repro.core.flexai import FlexAIConfig as ConfigJax
from repro.core.flexai import dqn as dqn_jax
from repro.core.flexai import engine as engine_jax
from repro.core.tasks import stack_task_arrays as stack_jax
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro.kernels.dqn_update import dqn_td_grads_fused as grads_pallas
from repro.kernels.dqn_update import dqn_td_update_fused as update_pallas
from repro_torch.core import environment as env_t
from repro_torch.core import hmai as hmai_t
from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai import engine as engine_t
from repro_torch.core.platform import spec_from_platform
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
from repro_torch.kernels.dqn_update import (dqn_td_grads_lanes,
                                            dqn_td_update_lanes)
from repro_torch.launch import train as train_launch
from test_torch_pipeline import one_torch_thread  # noqa: F401

RS = 0.05
ROUTE = dict(route_km=0.02, rate_scale=RS, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=6.0)
KW = dict(min_replay=32, batch_size=16, update_every=2, eps_decay_steps=500,
          replay_capacity=2048, seed=2)
D, A = 58, 11


def _queue_pair(seed):
    return (env_jax.build_task_queue(
                env_jax.EnvironmentParams(seed=seed, **ROUTE)),
            env_t.build_task_queue(
                env_t.EnvironmentParams(seed=seed, **ROUTE)))


def _platforms():
    return (hmai_jax.HMAIPlatform(capacity_scale=RS),
            hmai_t.HMAIPlatform(capacity_scale=RS))


def _sizes(valid, cap):
    return np.minimum(np.cumsum(valid, axis=-1), cap)


def jax_dp_draws(key, lanes, n_actions, batch, sizes):
    """The JAX DP trainer's per-step draws (engine.py ``lane_keys``):
    ``split(key, 4)`` a step, lane 0 raw, lane g ``fold_in(k, g)``;
    ``sizes`` [lanes, T] is each ring's fill after the step's write."""
    gidx = jnp.arange(lanes)

    def lane_keys(k):
        ks = jax.vmap(lambda g: jax.random.fold_in(k, g))(gidx)
        return jnp.where((gidx == 0)[:, None], k[None, :], ks)

    def step(key, size):
        key, k_eps, k_act, k_smp = jax.random.split(key, 4)
        u = jax.vmap(jax.random.uniform)(lane_keys(k_eps))
        act = jax.vmap(lambda k: jax.random.randint(k, (), 0, n_actions))(
            lane_keys(k_act))
        idx = jax.vmap(lambda k, s: jax.random.randint(
            k, (batch,), 0, jnp.maximum(s, 1)))(lane_keys(k_smp), size)
        return key, (u, act, idx)

    _, (u, act, idx) = jax.jit(lambda k, s: jax.lax.scan(step, k, s))(
        key, jnp.asarray(sizes.T, jnp.int32))
    return engine_t.Draws(torch.from_numpy(np.array(u).T.copy()),
                          torch.from_numpy(np.array(act).T.copy()),
                          torch.from_numpy(np.array(idx).transpose(1, 0, 2)
                                           .copy()))


def _dp_pair(seeds, cfg_kw=KW):
    """JAX DP over ``seeds`` and the port's inputs for the same run."""
    cfg_j, cfg_t = ConfigJax(**cfg_kw), FlexAIConfig(**cfg_kw)
    pairs = [_queue_pair(s) for s in seeds]
    plat_j, plat_t = _platforms()
    lanes = len(seeds)
    ts_j = engine_jax.dp_train_init(jax.random.PRNGKey(cfg_j.seed), D, A,
                                    cfg_j.replay_capacity, lanes)
    batch_j = stack_jax([arrays_jax(qj) for qj, _ in pairs])
    out_j = engine_jax.make_dp_train_fn(pj.spec_from_platform(plat_j), cfg_j,
                                        lanes)(ts_j, batch_j)
    batch_t = stack_task_arrays([tasks_to_arrays(qt) for _, qt in pairs])
    sizes = _sizes(batch_t.valid.numpy(), cfg_t.replay_capacity)
    draws = jax_dp_draws(ts_j.key, lanes, A, cfg_t.batch_size, sizes)
    ts_t = engine_t.dp_train_init(D, A, cfg_t.replay_capacity, lanes,
                                  device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p, opt=dqn_t.adam_init(p))
    return out_j, (cfg_t, plat_t, ts_t, batch_t, draws)


def test_dp_matches_jax_dp_trajectory():
    """Three lanes on three ~300-task routes: the same placements and
    update mask, losses and final params within atol 1e-4."""
    (ts_jf, _, recs_j, loss_j, upd_j), (cfg_t, plat_t, ts_t, batch_t,
                                        draws) = _dp_pair((21, 22, 23))
    run = engine_t.make_dp_train_fn(spec_from_platform(plat_t), cfg_t, 3)
    ts_tf, plat_tf, recs_t, loss_t, upd_t = run(ts_t, batch_t, draws)
    np.testing.assert_array_equal(recs_t.action.numpy(),
                                  np.asarray(recs_j.action))
    np.testing.assert_array_equal(upd_t.numpy(), np.asarray(upd_j))
    assert ts_tf.updates == int(ts_jf.updates) >= 50
    assert ts_tf.env_steps == int(ts_jf.env_steps) == \
        int(batch_t.valid.sum())
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               atol=1e-4)
    for got, want in zip(ts_tf.eval_p, ts_jf.eval_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(ts_tf.replay.a.numpy(),
                                  np.asarray(ts_jf.replay.a))


def test_dp_one_lane_equals_the_single_lane_trainer():
    """One lane on one route with the same draws: the single-lane
    trainer's trajectory, bit for bit (lane 0 takes the raw draws, and
    the crossing cadence reduces to the modulo)."""
    cfg = FlexAIConfig(**KW)
    _, qt = _queue_pair(21)
    plat = hmai_t.HMAIPlatform(capacity_scale=RS)
    spec = spec_from_platform(plat)
    ta = tasks_to_arrays(qt)
    rng = np.random.default_rng(0)
    t_len = ta.num_tasks
    sizes = _sizes(np.ones(t_len, bool), cfg.replay_capacity)
    draws = engine_t.Draws(
        torch.tensor(rng.random(t_len), dtype=torch.float32),
        torch.tensor(rng.integers(0, A, t_len)),
        torch.tensor(np.stack([rng.integers(0, s, cfg.batch_size)
                               for s in sizes])))
    ts_s, _, recs_s, loss_s, upd_s = engine_t.make_train_fn(spec, cfg)(
        engine_t.train_init(D, A, cfg.replay_capacity, device="cpu"), ta,
        draws)
    ts_d, _, recs_d, loss_d, upd_d = engine_t.make_dp_train_fn(
        spec, cfg, 1)(
        engine_t.dp_train_init(D, A, cfg.replay_capacity, 1, device="cpu"),
        type(ta)(*[f[None] for f in ta]),
        engine_t.Draws(*[d[None] for d in draws]))
    assert torch.equal(recs_s.action, recs_d.action[0])
    assert torch.equal(upd_s, upd_d) and int(upd_s.sum()) >= 50
    assert (ts_s.env_steps, ts_s.updates) == (ts_d.env_steps, ts_d.updates)
    assert torch.equal(loss_s, loss_d)
    for a, b in zip((*ts_s.eval_p, *ts_s.targ_p, *ts_s.opt.mu),
                    (*ts_d.eval_p, *ts_d.targ_p, *ts_d.opt.mu)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes,dp", [(1, False), (3, False), (3, True)])
def test_train_episode_counts_its_td_update_steps(monkeypatch, lanes, dp):
    """``train_episode``'s ``update_steps`` is the number of TD update
    calls the episode made: one a step where any lane updates (on the
    card, one kernel launch for all lanes), for the single-lane,
    population and DP trainers."""
    import repro_torch.kernels.dqn_update as td
    mod, name = ((engine_t, "dqn_td_update") if lanes == 1 else
                 (td, "dqn_td_grads_lanes_ref") if dp else
                 (td, "dqn_td_update_lanes_ref"))
    calls, fn = [], getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    trainer = ScanFlexAI(hmai_t.HMAIPlatform(capacity_scale=RS),
                         FlexAIConfig(**KW), lanes=lanes, dp=dp,
                         device="cpu")
    queues = [_queue_pair(s)[1] for s in (21, 22, 23)[:lanes]]
    summ = trainer.train_episode(queues if lanes > 1 else queues[0])
    assert summ["update_steps"] == len(calls) >= 50
    assert len(calls) == np.max(trainer.ts.updates)


def test_dp_cadence_crosses_update_boundaries():
    """Four lanes at ``update_every`` 3: an update whenever the global
    step count crosses a multiple of 3 (an exact-multiple test would
    update a third as often), gated on every ring's fill."""
    cfg = FlexAIConfig(min_replay=2, update_every=3, target_sync_every=2)
    ts = engine_t.dp_train_init(D, A, 64, 4, device="cpu")
    valid = np.ones((4, 6), bool)
    valid[3, 4:] = False
    cad = engine_t._dp_cadence(cfg, valid, ts, None)
    # env after each step: 4, 8, 12, 16, 19, 22; rings fill 1, 2, ...
    np.testing.assert_array_equal(cad.do_update,
                                  [False, True, True, True, True, True])
    np.testing.assert_array_equal(cad.sync,
                                  [False, False, True, False, True, False])
    assert (cad.env_steps, cad.updates) == (22, 5)


def test_dp_wrapper_trains_one_synchronized_agent():
    """``ScanFlexAI(dp=True)``: one parameter set over the route batch,
    counters over the global batch, losses, a greedy schedule; it
    refuses a fault trace."""
    _, qa = _queue_pair(21)
    _, qb = _queue_pair(24)
    trainer = ScanFlexAI(hmai_t.HMAIPlatform(capacity_scale=RS),
                         FlexAIConfig(**KW), lanes=2, dp=True, device="cpu")
    out = trainer.train([qa, qb], episodes=1)[0]
    assert len(out["lanes"]) == 2 and out["mean_loss"] is not None
    assert trainer.ts.eval_p.w1.dim() == 2
    assert trainer.ts.env_steps == len(qa) + len(qb)
    assert trainer.losses and np.isfinite(trainer.losses).all()
    assert trainer.schedule(qa)["tasks"] == len(qa)
    with pytest.raises(ValueError, match="fault-trace"):
        trainer.train_episode([qa, qb], health=np.ones((len(qa), A)))
    run = engine_t.make_dp_train_fn(trainer.spec, trainer.cfg, 2)
    with pytest.raises(ValueError, match="clean-only"):
        run(trainer.ts, stack_task_arrays([tasks_to_arrays(qa)] * 2),
            health=torch.ones(2, len(qa), A))


def test_dp_launcher_runs_on_cpu(tmp_path, capsys):
    weights = str(tmp_path / "dp.npz")
    assert train_launch.main([
        "--flexai", "--dp", "--dp-lanes", "2", "--td-kernel", "--device",
        "cpu", "--episodes", "1", "--routes", "2", "--rate-scale", "0.002",
        "--route-km", "0.02", "--weights", weights]) == 0
    out = capsys.readouterr().out
    assert "flexai dp lanes=2" in out and "env steps" in out
    dqn_jax.load_dqn_npz(weights)
    with pytest.raises(SystemExit):
        train_launch.main(["--flexai", "--shard", "--device", "cpu"])
    assert "--shard requires --dp" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the lane-batched TD entry points against jax.vmap of the JAX fused ones
# ---------------------------------------------------------------------------

SHAPES = [(D, 256), (256,), (256, 64), (64,), (64, A), (A,)]


def _nets(rng, lanes=None):
    lead = () if lanes is None else (lanes,)
    return [rng.uniform(-0.15, 0.15, lead + s).astype(np.float32)
            for s in SHAPES]


def _lane_batch(rng, lanes, b):
    return {"s": rng.normal(size=(lanes, b, D)).astype(np.float32),
            "a": rng.integers(0, A, (lanes, b)).astype(np.int32),
            "r": (rng.normal(size=(lanes, b)) * 3.0).astype(np.float32),
            "s_next": rng.normal(size=(lanes, b, D)).astype(np.float32),
            "done": (rng.random((lanes, b)) < 0.2).astype(np.float32)}


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} p{i}")


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-lane"])
def test_lane_td_grads_match_vmapped_jax_kernel(shared):
    rng = np.random.default_rng(3 + shared)
    lanes = 3
    ep, tp = (_nets(rng, None if shared else lanes) for _ in range(2))
    batch = _lane_batch(rng, lanes, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pe_j, pt_j = (dqn_jax.DQNParams(*map(jnp.asarray, n)) for n in (ep, tp))
    axes = None if shared else 0
    loss_j, g_j = jax.vmap(
        lambda e, t, b: grads_pallas(e, t, b, gamma=0.95, interpret=True),
        in_axes=(axes, axes, 0))(pe_j, pt_j, jb)
    loss, grads = dqn_td_grads_lanes(
        dqn_t.params_from_numpy(ep), dqn_t.params_from_numpy(tp),
        {k: torch.from_numpy(v) for k, v in batch.items()}, gamma=0.95)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5,
                               atol=1e-6)
    _close(grads, g_j, 1e-5, 1e-6, "grads")


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-lane"])
def test_lane_td_update_matches_vmapped_jax_kernel(shared):
    rng = np.random.default_rng(7 + shared)
    lanes = 3
    ep, tp = (_nets(rng, None if shared else lanes) for _ in range(2))
    mu = [(rng.normal(size=(lanes,) + s) * 1e-3).astype(np.float32)
          for s in SHAPES]
    nu = [(rng.random((lanes,) + s) * 1e-6).astype(np.float32)
          for s in SHAPES]
    step = np.array([0, 3, 6], np.int32)
    batch = _lane_batch(rng, lanes, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pe_j, pt_j = (dqn_jax.DQNParams(*map(jnp.asarray, n)) for n in (ep, tp))
    opt_j = dqn_jax.AdamState(jnp.asarray(step),
                              dqn_jax.DQNParams(*map(jnp.asarray, mu)),
                              dqn_jax.DQNParams(*map(jnp.asarray, nu)))
    axes = None if shared else 0
    new_j, opt_jf, loss_j = jax.vmap(
        lambda e, t, o, b: update_pallas(e, t, o, b, gamma=0.95, lr=1e-3,
                                         interpret=True),
        in_axes=(axes, axes, 0, 0))(pe_j, pt_j, opt_j, jb)
    opt_t = dqn_t.AdamState(torch.from_numpy(step),
                            dqn_t.params_from_numpy(mu),
                            dqn_t.params_from_numpy(nu))
    new_p, new_opt, loss = dqn_td_update_lanes(
        dqn_t.params_from_numpy(ep), dqn_t.params_from_numpy(tp), opt_t,
        {k: torch.from_numpy(v) for k, v in batch.items()}, gamma=0.95,
        lr=1e-3)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5,
                               atol=1e-6)
    # Adam's m_hat / sqrt(v_hat) amplifies rounding where |g| is near
    # eps: params at atol 1e-6 (about lr x 1e-3), as the single lane
    _close(new_p, new_j, 0, 1e-6, "params")
    _close(new_opt.mu, opt_jf.mu, 1e-5, 1e-7, "mu")
    _close(new_opt.nu, opt_jf.nu, 1e-5, 1e-12, "nu")
    np.testing.assert_array_equal(new_opt.step.numpy(), step + 1)


def test_qnet_apply_with_per_lane_params_matches_vmapped_jax():
    """Per-lane nets on one row a lane ([L, D]) and on a batch a lane
    ([L, B, D]): lane l's rows through lane l's net, no [L, L, ...]
    broadcast."""
    rng = np.random.default_rng(11)
    nets = _nets(rng, 4)
    p_j = dqn_jax.DQNParams(*map(jnp.asarray, nets))
    p_t = dqn_t.params_from_numpy(nets)
    for shape in ((4, D), (4, 5, D)):
        x = rng.normal(size=shape).astype(np.float32)
        want = jax.vmap(dqn_jax.qnet_apply)(p_j, jnp.asarray(x))
        got = dqn_t.qnet_apply(p_t, torch.from_numpy(x))
        assert got.shape == shape[:-1] + (A,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
