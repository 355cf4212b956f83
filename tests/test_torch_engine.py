"""The slice as a whole: the port's greedy scheduler, trainer, placement
service and launchers against the JAX package's.

Placements are compared for the same weights.  The Q-net's matrix
products sum in another order in XLA and in PyTorch, so a placement may
differ where two accelerators' Q values tie to within rounding; where one
differs, the test requires JAX's Q margin there to be below 1e-5 (and the
routes diverge from there on, so only the prefix is compared).

The trainer is held to the JAX trainer's trajectory by injecting the
JAX trainer's own random draws, regenerated from its key chain: the same
actions, losses at rtol 1e-4, final params at atol 1e-4 (about 100 Adam
steps of lr 1e-3 on gradients that agree to 1e-5).
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
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro.serve.engine import FlexAIPlacementService as ServiceJax
from repro_torch.core import environment as env_t
from repro_torch.core import hmai as hmai_t
from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai import engine as engine_t
from repro_torch.core.platform import spec_from_platform
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.serve.engine import FlexAIPlacementService
from test_torch_pipeline import one_torch_thread  # noqa: F401

RATE = 0.012
SMALL = dict(route_km=0.01, rate_scale=RATE, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)
MARGIN = 1e-5


def _queue_pair(seed):
    return (env_jax.build_task_queue(
                env_jax.EnvironmentParams(seed=seed, **SMALL)),
            env_t.build_task_queue(
                env_t.EnvironmentParams(seed=seed, **SMALL)))


def _platforms():
    return (hmai_jax.HMAIPlatform(capacity_scale=RATE),
            hmai_t.HMAIPlatform(capacity_scale=RATE))


def _weights(seed=0):
    plat = hmai_jax.HMAIPlatform()
    return dqn_jax.init_qnet(jax.random.PRNGKey(seed), 3 + 5 * plat.n, plat.n)


def _assert_same_placements(got, want, params_j, spec_j, ta_j):
    """Equal placements, or a first difference where JAX's own Q values
    of the two choices are within MARGIN (a rounding tie)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    if len(diff) == 0:
        return
    k = int(diff[0])
    prefix = type(ta_j)(*[jnp.asarray(f)[:k] for f in ta_j])
    state = (pj.platform_init(spec_j.n) if k == 0 else
             engine_jax.make_schedule_fn(spec_j)(params_j, prefix)[0])
    sv = pj.state_vector(spec_j, jnp.asarray(pj.kind_feature_table()), 1.0,
                         state, type(ta_j)(*[jnp.asarray(f)[k]
                                             for f in ta_j]))
    q = np.asarray(dqn_jax.qnet_apply(params_j, sv))
    margin = q[want[k]] - q[got[k]]
    assert margin < MARGIN, (
        f"placement {k} differs ({got[k]} vs JAX {want[k]}) with a JAX Q "
        f"margin of {margin}")


def test_greedy_schedule_matches_jax_single_and_batched():
    params_j = _weights(0)
    params_t = dqn_t.params_from_numpy(params_j)
    plat_j, plat_t = _platforms()
    spec_j = pj.spec_from_platform(plat_j)
    pairs = [_queue_pair(seed) for seed in (8, 11, 12)]
    tas_j = [arrays_jax(qj) for qj, _ in pairs]
    tas_t = [tasks_to_arrays(qt) for _, qt in pairs]

    single_j = engine_jax.make_schedule_fn(spec_j)
    spec_t = spec_from_platform(plat_t)
    single_t = engine_t.make_schedule_fn(spec_t)
    want = []
    for ta_j, ta_t in zip(tas_j, tas_t):
        final_j, recs_j = single_j(params_j, ta_j)
        final_t, recs_t = single_t(params_t, ta_t)
        want.append(np.asarray(recs_j.action))
        _assert_same_placements(recs_t.action.numpy(), want[-1], params_j,
                                spec_j, ta_j)

    batch_t = stack_task_arrays(tas_t)
    finals, recs = engine_t.make_schedule_fn(spec_t, batched=True)(
        params_t, batch_t)
    for i, (ta_j, w) in enumerate(zip(tas_j, want)):
        n = ta_j.num_tasks
        assert not recs.valid[i, n:].any()
        _assert_same_placements(recs.action[i, :n].numpy(), w, params_j,
                                spec_j, ta_j)


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


def test_trainer_matches_jax_trajectory_with_injected_draws():
    kw = dict(min_replay=16, batch_size=16, update_every=1,
              target_sync_every=8, replay_capacity=512, seed=3)
    cfg_j, cfg_t = ConfigJax(**kw), FlexAIConfig(**kw)
    qj, qt = _queue_pair(2)
    plat_j, plat_t = _platforms()
    spec_j = pj.spec_from_platform(plat_j)
    n, d = plat_j.n, 3 + 5 * plat_j.n
    ts_j = engine_jax.train_init(jax.random.PRNGKey(cfg_j.seed), d, n,
                                 cfg_j.replay_capacity)
    ts_jf, plat_jf, recs_j, losses_j, upd_j = engine_jax.make_train_fn(
        spec_j, cfg_j)(ts_j, arrays_jax(qj))

    t_len = len(qt)
    sizes = np.minimum(np.arange(1, t_len + 1), cfg_t.replay_capacity)
    draws = _jax_draws(ts_j.key, t_len, n, cfg_t.batch_size, sizes)
    trainer = ScanFlexAI(plat_t, cfg_t, device="cpu")
    trainer.set_params(dqn_t.params_from_numpy(ts_j.eval_p))
    summ = trainer.train_episode(qt, draws=draws)
    ts_t = trainer.ts

    upd_j = np.asarray(upd_j)
    assert ts_t.updates == int(upd_j.sum()) > 100
    assert ts_t.env_steps == t_len == summ["tasks"]
    np.testing.assert_allclose(np.asarray(trainer.losses),
                               np.asarray(losses_j)[upd_j], rtol=1e-4)
    for got, want in zip(ts_t.eval_p, ts_jf.eval_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert summ["stm_rate"] == \
        pj.summarize(spec_j, plat_jf, recs_j)["stm_rate"]


def test_trainer_actions_match_jax():
    """Action-by-action (records, not the summary) on the same setup, with
    the Q-net half-greedy from the start (eps_start 0.5)."""
    kw = dict(min_replay=16, batch_size=16, update_every=1,
              target_sync_every=8, replay_capacity=512, seed=4,
              eps_start=0.5)
    cfg_j, cfg_t = ConfigJax(**kw), FlexAIConfig(**kw)
    qj, qt = _queue_pair(39)
    plat_j, plat_t = _platforms()
    spec_j = pj.spec_from_platform(plat_j)
    n, d = plat_j.n, 3 + 5 * plat_j.n
    ts_j = engine_jax.train_init(jax.random.PRNGKey(cfg_j.seed), d, n,
                                 cfg_j.replay_capacity)
    _, _, recs_j, losses_j, upd_j = engine_jax.make_train_fn(
        spec_j, cfg_j)(ts_j, arrays_jax(qj))
    t_len = len(qt)
    sizes = np.minimum(np.arange(1, t_len + 1), cfg_t.replay_capacity)
    draws = _jax_draws(ts_j.key, t_len, n, cfg_t.batch_size, sizes)
    run = engine_t.make_train_fn(spec_from_platform(plat_t), cfg_t)
    ts_t = engine_t.train_init(d, n, cfg_t.replay_capacity, device="cpu")
    p = dqn_t.params_from_numpy(ts_j.eval_p)
    ts_t = ts_t._replace(eval_p=p, targ_p=p, opt=dqn_t.adam_init(p))
    _, _, recs_t, losses_t, upd_t = run(ts_t, tasks_to_arrays(qt), draws)
    np.testing.assert_array_equal(recs_t.action.numpy(),
                                  np.asarray(recs_j.action))
    np.testing.assert_array_equal(upd_t.numpy(), np.asarray(upd_j))
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-4, atol=1e-7)


def test_placement_service_matches_jax():
    params_j = _weights(1)
    plat_j, plat_t = _platforms()
    pairs = [_queue_pair(seed) for seed in (31, 32, 33)]
    deadlines = [0.01, None, 5.0]      # the first is tight: solo path
    svc_j = ServiceJax(plat_j, params_j, min_bucket=64, tight_slack_s=0.1)
    svc_t = FlexAIPlacementService(plat_t, dqn_t.params_from_numpy(params_j),
                                   min_bucket=64, tight_slack_s=0.1,
                                   device="cpu")
    res_j = svc_j.place([qj for qj, _ in pairs], deadlines=deadlines)
    res_t = svc_t.place([qt for _, qt in pairs], deadlines=deadlines)
    spec_j = pj.spec_from_platform(plat_j)
    for (qj, _), rj, rt in zip(pairs, res_j, res_t):
        assert (rt["path"], rt["bucket"]) == (rj["path"], rj["bucket"])
        _assert_same_placements(rt["placements"], rj["placements"],
                                params_j, spec_j, arrays_jax(qj))
        if np.array_equal(rt["placements"], rj["placements"]):
            assert rt["stm_rate"] == rj["stm_rate"]
    assert (svc_t.dispatches, svc_t.fused_dispatches) == \
        (svc_j.dispatches, svc_j.fused_dispatches)


def test_launchers_run_on_cpu(tmp_path, capsys):
    weights = str(tmp_path / "agent.npz")
    assert train_launch.main([
        "--flexai", "--td-kernel", "--device", "cpu", "--episodes", "1",
        "--routes", "1", "--rate-scale", "0.001",
        "--weights", weights]) == 0
    assert serve_launch.main([
        "--placement", "--device", "cpu", "--routes", "2",
        "--rate-scale", "0.001", "--weights", weights]) == 0
    out = capsys.readouterr().out
    assert "env steps" in out and "placed 2 routes" in out
    dqn_jax.load_dqn_npz(weights)      # the JAX package reads it


def test_entry_points_need_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    plat = hmai_t.HMAIPlatform()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScanFlexAI(plat, FlexAIConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlexAIPlacementService(plat, dqn_t.params_from_numpy(_weights()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--placement", "--routes", "1"])
