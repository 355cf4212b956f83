"""The port's loop trainer (``FlexAIAgent``, ``DQNLearner``,
``ReplayBuffer``, ``reward.snapshot`` / ``compute_reward``) against the
JAX package's, and the weight interop between the loop trainer and the
step-loop engine.

Both agents explore from ``np.random.default_rng(seed)`` and sample their
host replay rings from another, so from the same weights they take the
same random decisions; greedy steps agree while the Q-nets do.  Actions
must be equal, losses within 1e-4 (about 100 Adam steps of lr 1e-3 on
gradients that agree to 1e-5, as ``test_torch_engine.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import hmai as hmai_jax
from repro.core.flexai import FlexAIAgent as AgentJax
from repro.core.flexai import FlexAIConfig as ConfigJax
from repro.core.flexai import ScanFlexAI as ScanJax
from repro.core.flexai import replay as replay_jax
from repro.core.flexai import reward as reward_jax
from repro_torch.core import hmai as hmai_t
from repro_torch.core.flexai import (FlexAIAgent, FlexAIConfig, ReplayBuffer,
                                     ScanFlexAI)
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai import reward as reward_t
from test_torch_dp_trainer import RS, _queue_pair
from test_torch_pipeline import one_torch_thread  # noqa: F401

KW = dict(min_replay=16, batch_size=16, update_every=1, target_sync_every=8,
          replay_capacity=512, eps_decay_steps=300, seed=3, eps_start=0.7)


def _agents(kw=KW):
    cfg_j, cfg_t = ConfigJax(**kw), FlexAIConfig(**kw)
    agent_j = AgentJax(hmai_jax.HMAIPlatform(capacity_scale=RS), cfg_j)
    agent_t = FlexAIAgent(hmai_t.HMAIPlatform(capacity_scale=RS), cfg_t,
                          device="cpu")
    p = dqn_t.params_from_numpy(agent_j.learner.eval_p)
    agent_t.learner.eval_p = agent_t.learner.targ_p = p
    return agent_j, agent_t


def test_agent_matches_jax_agent_over_two_episodes():
    agent_j, agent_t = _agents()
    for seed in (21, 24):
        qj, qt = _queue_pair(seed)
        s_j = agent_j.train_episode(
            hmai_jax.HMAIPlatform(capacity_scale=RS), qj)
        s_t = agent_t.train_episode(
            hmai_t.HMAIPlatform(capacity_scale=RS), qt)
        assert s_t["tasks"] == s_j["tasks"] == len(qt)
        assert s_t["stm_rate"] == s_j["stm_rate"]
    n = agent_j.replay.size
    assert agent_t.replay.size == n and agent_t.env_steps == \
        agent_j.env_steps
    np.testing.assert_array_equal(agent_t.replay.a[:n], agent_j.replay.a[:n])
    np.testing.assert_allclose(agent_t.replay.r[:n], agent_j.replay.r[:n],
                               rtol=1e-6, atol=1e-9)
    assert len(agent_t.losses) == len(agent_j.losses) > 300
    np.testing.assert_allclose(agent_t.losses, agent_j.losses, rtol=1e-4,
                               atol=1e-4)
    assert agent_t.learner.updates == agent_j.learner.updates
    for got, want in zip(agent_t.learner.eval_p, agent_j.learner.eval_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_replay_buffer_is_the_jax_ring():
    """Same writes, same seed: the same ring and the same samples."""
    rb_j = replay_jax.ReplayBuffer(5, 3, seed=9)
    rb_t = ReplayBuffer(5, 3, seed=9)
    rng = np.random.default_rng(0)
    for i in range(8):
        s, sn = rng.normal(size=3), rng.normal(size=3)
        for rb in (rb_j, rb_t):
            rb.add(s, i % 4, float(i), sn, done=i == 7)
    assert (rb_t.ptr, rb_t.size) == (rb_j.ptr, rb_j.size) == (3, 5)
    for _ in range(3):
        got, want = rb_t.sample(4), rb_j.sample(4)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_reward_from_snapshots_matches_jax():
    tasks_j, tasks_t = _queue_pair(21)
    plat_j = hmai_jax.HMAIPlatform(capacity_scale=RS)
    plat_t = hmai_t.HMAIPlatform(capacity_scale=RS)
    for i, (tj, tt) in enumerate(zip(tasks_j[:40], tasks_t[:40])):
        b_j, b_t = reward_jax.snapshot(plat_j), reward_t.snapshot(plat_t)
        plat_j.execute(tj, i % plat_j.n)
        plat_t.execute(tt, i % plat_t.n)
        assert reward_t.compute_reward(b_t, plat_t) == \
            reward_jax.compute_reward(b_j, plat_j)


def test_greedy_schedule_and_scan_schedule_agree():
    """The loop's greedy placements equal the step-loop engine's for the
    agent's weights (``schedule`` and ``schedule_scan``)."""
    _, agent = _agents()
    _, q = _queue_pair(22)
    loop = agent.schedule(hmai_t.HMAIPlatform(capacity_scale=RS), q)
    scan = agent.schedule_scan(hmai_t.HMAIPlatform(capacity_scale=RS), q)
    assert scan["tasks"] == loop["tasks"] == len(q)
    assert scan["stm_rate"] == loop["stm_rate"]


@pytest.mark.parametrize("lanes,dp", [(1, False), (2, True), (2, False)],
                         ids=["single", "dp", "population"])
def test_agent_scan_agent_round_trip_is_bit_exact(lanes, dp):
    _, agent = _agents()
    agent.losses = [0.5, 0.25]
    plat = hmai_t.HMAIPlatform(capacity_scale=RS)
    trainer = ScanFlexAI.from_agent(agent, plat, lanes=lanes, dp=dp)
    assert trainer.losses == agent.losses
    for lane in range(lanes if not dp else 1):
        back = trainer.to_agent(plat, lane=lane)
        for a, b in zip(back.learner.eval_p, agent.learner.eval_p):
            assert torch.equal(a, b)
        for a, b in zip(back.learner.targ_p, agent.learner.eval_p):
            assert torch.equal(a, b)
    _, q = _queue_pair(22)
    np.testing.assert_array_equal(trainer.schedule(q)["placements"],
                                  agent.schedule_scan(plat, q)["placements"])


def test_npz_checkpoint_is_shared_with_the_jax_package(tmp_path):
    agent_j, agent_t = _agents()
    qj, qt = _queue_pair(21)
    agent_j.train_episode(hmai_jax.HMAIPlatform(capacity_scale=RS), qj)
    path_j = str(tmp_path / "jax.npz")
    agent_j.save_weights(path_j)
    agent_t.load_weights(path_j)
    for got, want in zip(agent_t.learner.eval_p, agent_j.learner.eval_p):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    agent_t.train_episode(hmai_t.HMAIPlatform(capacity_scale=RS), qt)
    path_t = str(tmp_path / "torch.npz")
    agent_t.save_weights(path_t)
    back = AgentJax(hmai_jax.HMAIPlatform(capacity_scale=RS),
                    ConfigJax(**KW))
    back.load_weights(path_t)
    for got, want in zip(back.learner.eval_p, agent_t.learner.eval_p):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    scan_j = ScanJax(hmai_jax.HMAIPlatform(capacity_scale=RS),
                     ConfigJax(**KW), lanes=2)
    scan_j.load_weights(path_t)
    for lane in range(2):
        for got, want in zip(scan_j.eval_params(lane),
                             agent_t.learner.eval_p):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_agent_train_keeps_the_best_eval_weights():
    _, agent = _agents(dict(KW, min_replay=32))
    queues = [_queue_pair(s)[1] for s in (21, 24)]
    hist = agent.train(hmai_t.HMAIPlatform(capacity_scale=RS), queues,
                       episodes=2, eval_queue=_queue_pair(22)[1],
                       eval_every=1)
    evals = [h["eval_stm"] for h in hist]
    assert len(evals) == 2 and all(0.0 <= e <= 1.0 for e in evals)
    assert agent.learner.targ_p is agent.learner.eval_p
