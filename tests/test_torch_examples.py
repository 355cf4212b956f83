"""The port's twins of the three examples (``examples/*_torch.py``) against
the JAX package on the CPU, each twin loaded from its path.

* The quickstart's LM: 60 steps from the JAX example's ``PRNGKey(0)``
  init carried across, every step's loss held to the jitted JAX step's
  (fp32 compute within 1e-5 relative; the example's bf16 compute by the
  bf16 rule below); both packages' ``ServeEngine`` give the same 8 greedy
  tokens from the same trained weights.
* The quickstart's FlexAI, its 3 episodes on the first 100 tasks of its
  queue (300 training actions, 237 TD updates), from the JAX agent's
  weights: actions equal, STM and R_Balance equal, losses within 1e-4
  (``test_torch_agent.py``'s rule).  On the first 300 tasks (837
  updates) the two runs part at a rounding tie: everything is held
  equal up to the first difference, and there JAX's own margin between
  the two choices must be a tie.
* The driving pipeline on one-frame pools and a 48-task queue: the
  placements on the real pools equal the JAX ``FlexAIAgent``'s, trained
  from the same weights on ``HMAIPlatform``s built from the port's
  measured specs.
* The fault-tolerance demo: restart == uninterrupted; from the JAX
  example's ``PRNGKey(0)`` init in fp32 compute, its uninterrupted run's
  final params against the jitted JAX step's 60 steps.
* Each twin's ``main`` raises without a GPU unless given ``--device cpu``.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import hmai as hmai_jax
from repro.core import taxonomy as taxonomy_jax
from repro.core.flexai import FlexAIAgent as AgentJax
from repro.core.flexai import FlexAIConfig as ConfigJax
from repro.core.schedulers import get_scheduler as get_scheduler_jax
from repro.models.api import model_api as jax_model_api
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding import unbox
from repro.train import data as jax_data
from repro.train import loop as JL
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_params_from_numpy
from repro_torch.train.checkpoint import tree_leaves
from test_torch_pipeline import one_torch_thread  # noqa: F401
from test_torch_virtual_platform import TINY_POOLS

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _load("quickstart_torch")
pipeline = _load("serve_driving_pipeline_torch")
failures = _load("train_with_failures_torch")

# examples/quickstart.py's LM and its training
QS_LM = dict(name="quickstart", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
             attention_impl="naive")
QS_STEPS = 60
QS_TASKS = 100
QS_LONG_TASKS = 300
# the first difference of the 300-task runs must be a tie: an acting
# choice within test_torch_engine.py's 1e-5 of JAX's; a double-DQN
# target choice within 1e-4, as the nets' Q values have by then come
# ~1e-4 apart (update 672 of 837: JAX margin 7.3e-5, the nets 1.4e-4
# apart on that batch, 1.4e-6 at update 600; Adam turns the rounding of
# near-zero gradient entries into whole steps from update ~650 on)
ACT_TIE = 1e-5
TARGET_TIE = 1e-4
FT_LM = dict(name="ft-demo", family="dense", num_layers=2, d_model=96,
             num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=256,
             attention_impl="naive")


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX example's LM trained its 60 steps by the jitted step, in a
    compute dtype: {dtype: (api, initial params on the host, final state,
    every step's loss)}, each dtype run once."""
    runs = {}

    def run(dtype):
        if dtype not in runs:
            api = jax_model_api(JaxModelConfig(**QS_LM, dtype=dtype))
            hyper = JL.TrainHyper(peak_lr=3e-3, warmup_steps=5,
                                  total_steps=60)
            state = JL.init_train_state(
                unbox(api.init(jax.random.PRNGKey(0))), hyper)
            init = jax.device_get(state.params)
            step = jax.jit(JL.make_train_step(api, hyper))
            bat = jax_data.batch_fn(api.cfg, jax_data.DataConfig(
                batch_size=4, seq_len=32))
            losses = []
            for i in range(QS_STEPS):
                state, metrics = step(state, bat(i))
                losses.append(float(metrics["loss"]))
            runs[dtype] = api, init, state, np.array(losses)
        return runs[dtype]
    return run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quickstart_lm_trains_as_the_jitted_jax_step(jax_lm, dtype,
                                                     monkeypatch):
    """fp32 compute: every loss within 1e-5 relative.  The example's own
    bf16 compute parts from JAX at step 0 (1.2e-4): ``jax.nn.silu`` rounds
    the sigmoid to bf16 before the product, PyTorch's ``silu`` rounds once
    (39 % of layer 0's MLP activations one bf16 step apart; every op
    before it bit-equal).  So in bf16 each loss is held within twice the
    JAX package's own bf16 distance from its fp32 run (the LM tests'
    rule for bf16)."""
    assert quickstart.CFG == ModelConfig(**QS_LM)
    monkeypatch.setattr(quickstart, "CFG",
                        ModelConfig(**QS_LM, dtype=dtype))
    _, init, _, want = jax_lm(dtype)
    state, got = quickstart.train_lm("cpu", params=init, log=_quiet)
    assert len(got) == QS_STEPS and int(state.opt.step) == QS_STEPS
    assert got[40] < got[0]
    rel = np.abs(np.array(got) - want) / np.abs(want)
    if dtype == "float32":
        assert rel.max() <= 1e-5, rel.max()
    else:
        fp32 = jax_lm("float32")[3]
        gate = 2 * (np.abs(want - fp32) / np.abs(fp32)).max()
        assert rel.max() <= gate, (rel.max(), gate)


def test_quickstart_serves_the_jax_engines_tokens(jax_lm):
    api, _, state, _ = jax_lm("bfloat16")
    eng = JaxServeEngine(api, state.params, slots=2, max_seq=48)
    eng.submit(JaxRequest(uid=0, prompt=np.array([5, 12, 19], np.int32),
                          max_new_tokens=8))
    eng.run_until_done()
    want = [int(t) for t in eng.finished[0].generated]
    got, eng_t = quickstart.serve(
        lm_params_from_numpy(jax.device_get(state.params), "cpu"), "cpu")
    assert len(got) == 8 and got == want
    assert eng_t.wave_log == eng.wave_log == [[0]]


def _quickstart_jax_agent(n_tasks):
    q_j = env_jax.build_task_queue(env_jax.EnvironmentParams(
        route_km=0.05, rate_scale=0.05))[:n_tasks]
    plat_j = hmai_jax.HMAIPlatform(capacity_scale=0.05)
    return q_j, plat_j, AgentJax(plat_j, ConfigJax(min_replay=64,
                                                   eps_decay_steps=4000))


def test_quickstart_flexai_matches_the_jax_agent():
    """Held exactly on 100 tasks.  Longer runs part without a fault: Adam
    turns the packages' rounding into whole steps where a gradient is
    near zero.  On 200 tasks (537 updates) a hidden unit's ReLU sits
    within the nets' ~1e-7 drift of zero for one sample at update 164, so
    w1[39, 61] has a gradient 2.8e-6 in the port and 0 in JAX, and Adam's
    step there differs by 6 % of lr; on 300 tasks (837 updates) the
    losses agree to 3e-5 until update 672, where a double-DQN target
    argmax is a near tie (JAX margin 7.3e-5, the port's 2.0e-5): the next
    test holds that run up to its tie."""
    q_j, plat_j, agent_j = _quickstart_jax_agent(QS_TASKS)
    init = [np.asarray(w) for w in agent_j.learner.eval_p]
    agent_j.train(plat_j, [q_j], episodes=3)
    plat_j.reset()
    want = agent_j.schedule(plat_j, q_j)

    res = quickstart.flexai("cpu", max_tasks=QS_TASKS, params=init,
                            log=_quiet)
    agent_t, got = res["agent"], res["summary"]
    assert len(res["queue"]) == got["tasks"] == want["tasks"] == QS_TASKS
    n = agent_j.replay.size
    assert agent_t.replay.size == n == 3 * QS_TASKS
    np.testing.assert_array_equal(agent_t.replay.a[:n], agent_j.replay.a[:n])
    assert len(agent_t.losses) == len(agent_j.losses) == n - 63
    np.testing.assert_allclose(agent_t.losses, agent_j.losses, rtol=1e-4,
                               atol=1e-4)
    assert got["stm_rate"] == want["stm_rate"]
    assert got["r_balance"] == want["r_balance"]


def test_quickstart_flexai_parts_from_the_jax_agent_only_at_a_tie(
        monkeypatch):
    """The quickstart's 3 episodes on its first 300 tasks.  Each package
    records, before every TD update, its EvalNet's Q values on the
    batch's next states (the double-DQN target choice), and JAX its Q
    values at every training action.  The first difference is the first
    action or target choice that parts; before it, actions are equal and
    losses within 1e-4; there, JAX's margin between the two choices must
    be a tie (``ACT_TIE`` / ``TARGET_TIE``).  STM and R_Balance are equal
    if nothing parted."""
    q_j, plat_j, agent_j = _quickstart_jax_agent(QS_LONG_TASKS)
    init = [np.asarray(w) for w in agent_j.learner.eval_p]
    act_q_j, targ_q_j, targ_q_t = [], [], []
    learner_j, act_j = agent_j.learner, agent_j.act

    def update_j(batch, update=learner_j.update):
        targ_q_j.append(np.asarray(learner_j.q_values(batch["s_next"])))
        return update(batch)

    def recorded_act(state, explore):
        if explore:
            act_q_j.append(np.asarray(learner_j.q_values(state[None]))[0])
        return act_j(state, explore)

    learner_j.update, agent_j.act = update_j, recorded_act
    agent_j.train(plat_j, [q_j], episodes=3)
    plat_j.reset()
    want = agent_j.schedule(plat_j, q_j)

    update_t = dqn_t.DQNLearner.update

    def recorded_update(self, batch):
        targ_q_t.append(self.q_values(batch["s_next"]).numpy())
        return update_t(self, batch)

    monkeypatch.setattr(dqn_t.DQNLearner, "update", recorded_update)
    res = quickstart.flexai("cpu", max_tasks=QS_LONG_TASKS, params=init,
                            log=_quiet)
    agent_t, got = res["agent"], res["summary"]
    n = agent_j.replay.size
    assert agent_t.replay.size == n == len(act_q_j) == 3 * QS_LONG_TASKS
    n_upd = len(agent_j.losses)
    assert len(agent_t.losses) == len(targ_q_t) == len(targ_q_j) == n_upd
    first_update = n - n_upd        # the env step of update 0
    acts_t, acts_j = agent_t.replay.a[:n], agent_j.replay.a[:n]
    act_diff = np.nonzero(acts_t != acts_j)[0]
    i = int(act_diff[0]) if len(act_diff) else n
    flips = [u for u in range(n_upd) if not np.array_equal(
        targ_q_t[u].argmax(1), targ_q_j[u].argmax(1))]
    u = flips[0] if flips else n_upd
    if i < n and i <= first_update + u:
        # an action parts first: a greedy one (the random draws are equal)
        q = act_q_j[i]
        margin = float(q[acts_j[i]] - q[acts_t[i]])
        assert margin < ACT_TIE, (i, margin)
        u = min(u, max(i - first_update, 0))
    elif u < n_upd:
        q, a_t = targ_q_j[u], targ_q_t[u].argmax(1)
        a_j = q.argmax(1)
        rows = np.nonzero(a_t != a_j)[0]
        margin = float((q[rows, a_j[rows]] - q[rows, a_t[rows]]).max())
        assert margin < TARGET_TIE, (u, margin)
    np.testing.assert_allclose(agent_t.losses[:u], agent_j.losses[:u],
                               rtol=1e-4, atol=1e-4)
    if i == n and u == n_upd:
        assert got["stm_rate"] == want["stm_rate"]
        assert got["r_balance"] == want["r_balance"]
    for s in (got, want):
        assert 0.0 <= s["stm_rate"] <= 1.0 and 0.0 <= s["r_balance"] <= 1.0


def _jax_platform(plat):
    """A JAX ``HMAIPlatform`` with the port platform's measured specs."""
    return hmai_jax.HMAIPlatform(specs=[hmai_jax.AcceleratorSpec(
        name=s.name, arch=taxonomy_jax.TAXONOMY[s.arch.name],
        fps=dict(s.fps), power_w=s.power_w) for s in plat.specs])


def test_pipeline_places_as_the_jax_agent_on_the_same_specs():
    cfg_j = ConfigJax(min_replay=64, eps_decay_steps=3000, update_every=4)
    n_pools = len(TINY_POOLS)
    init = [np.asarray(w) for w in AgentJax(
        hmai_jax.HMAIPlatform(specs=[hmai_jax.ACCELERATOR_SPECS["MconvMC"]]
                              * n_pools), cfg_j).learner.eval_p]
    res = pipeline.pipeline("cpu", pools=TINY_POOLS, max_tasks=48,
                            params=init, log=_quiet)
    q_j = env_jax.build_task_queue(env_jax.EnvironmentParams(
        route_km=0.02, rate_scale=res["rate_scale"], seed=0))[:48]
    assert len(q_j) == len(res["queue"]) == 48
    sim_j, real_j = _jax_platform(res["sim"]), _jax_platform(res["platform"])
    agent_j = AgentJax(sim_j, cfg_j)
    agent_j.train(sim_j, [q_j], episodes=2)
    n = agent_j.replay.size
    np.testing.assert_array_equal(res["agent"].replay.a[:n],
                                  agent_j.replay.a[:n])
    real_j.reset()
    want = agent_j.schedule(real_j, q_j)
    assert res["placements"] == [r.accel_index for r in real_j.records]
    assert res["flexai"]["stm_rate"] == want["stm_rate"]
    real_j.reset()
    worst = get_scheduler_jax("worst").schedule(real_j, q_j)
    assert res["worst_placements"] == [r.accel_index for r in real_j.records]
    assert res["worst"]["stm_rate"] == worst["stm_rate"]


def test_failures_demo_restart_equals_uninterrupted(capsys):
    assert failures.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "simulated failure: injected fault at step 37" in out
    assert "restored from step 20" in out
    assert "restart == uninterrupted: True" in out


def test_failures_demo_trains_as_the_jitted_jax_step(monkeypatch):
    """The demo from the JAX example's ``PRNGKey(0)`` init carried across,
    in fp32 compute: restart == uninterrupted, and the uninterrupted run's
    final params within rtol 1e-5, atol 1e-5 of the jitted JAX step's 60
    steps (2.6e-6 apart at most; the example's bf16 compute parts at step
    0, as the quickstart's does, so it is not compared)."""
    api = jax_model_api(JaxModelConfig(**FT_LM, dtype="float32"))
    hyper = JL.TrainHyper(peak_lr=3e-3, warmup_steps=5, total_steps=60)
    state = JL.init_train_state(unbox(api.init(jax.random.PRNGKey(0))),
                                hyper)
    init = jax.device_get(state.params)
    step = jax.jit(JL.make_train_step(api, hyper))
    bat = jax_data.batch_fn(api.cfg, jax_data.DataConfig(batch_size=4,
                                                         seq_len=32))
    for i in range(60):
        state, _ = step(state, bat(i))
    assert failures.CFG == ModelConfig(**FT_LM)
    monkeypatch.setattr(failures, "CFG",
                        ModelConfig(**FT_LM, dtype="float32"))
    demo = failures.demo("cpu", params=init, log=_quiet)
    assert demo["ok"] and demo["start"] == 20
    want = jax.tree_util.tree_leaves(jax.device_get(state.params))
    got = tree_leaves(demo["ref"].final_state.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("twin", [quickstart, pipeline, failures],
                         ids=lambda m: m.__name__)
def test_main_needs_a_gpu_unless_asked_for_the_cpu(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        twin.main([])
