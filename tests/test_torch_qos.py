"""The port's QoS placement engine (``repro_torch.serve.qos``) against
the JAX package's: twins of the engine checks of ``tests/test_serve_load.py``
(config validation, the measured service clock, a generated trace served
end to end) and the launcher's routing of the QoS flags.

Each twin serves the same submissions through both engines, with the same
weights.  The wave log, completed and shed uids, finish, slack and the
virtual clock must be equal (``serving_digest``), and so must ``stats()``.
Placements must be equal too; the one escape is the Q-net's rounding tie
of ``tests/test_torch_engine.py`` (at a first difference JAX's Q margin
below 1e-5).  The queueing checks ride the stub executor, as the JAX
tests do; the placement checks ride the greedy scheduler.
"""
import numpy as np
import pytest
import torch

from repro.core.flexai import FlexAIAgent, FlexAIConfig
from repro.core.hmai import HMAIPlatform as PlatformJax
from repro.core.platform_jax import spec_from_platform as spec_jax
from repro.core.tasks import TaskArrays as TaskArraysJax
from repro.serve.durability import serving_digest as digest_jax
from repro.serve.loadgen import LoadGenConfig as LoadGenConfigJax
from repro.serve.loadgen import generate as generate_jax
from repro.serve.loadgen import submit_trace as submit_trace_jax
from repro.serve.qos import QoSConfig as QoSConfigJax
from repro.serve.qos import QoSPlacementEngine as EngineJax
from repro_torch.core.flexai.dqn import params_from_numpy
from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.tasks import TaskArrays
from repro_torch.launch import serve as serve_launch
from repro_torch.serve import qos
from repro_torch.serve.durability import digests_equal, serving_digest
from repro_torch.serve.loadgen import LoadGenConfig, generate, submit_trace
from repro_torch.serve.policy import power_of_two_bucket
from test_torch_engine import _assert_same_placements
from test_torch_scenarios import _jax_draws

RS = 0.05
PLATFORM_JAX = PlatformJax(capacity_scale=RS)
PLATFORM = HMAIPlatform(capacity_scale=RS)
AGENT = FlexAIAgent(PLATFORM_JAX, FlexAIConfig(seed=3))
PARAMS = params_from_numpy(AGENT.learner.eval_p)
BACKLOG = AGENT.cfg.backlog_scale


def route_pair(n: int, seed: int = 0):
    """The JAX tests' synthetic [n] route, as the JAX package's
    ``TaskArrays`` (numpy) and the port's (torch)."""
    rng = np.random.default_rng(seed)
    ta = TaskArraysJax(
        kind=rng.integers(0, 3, n).astype(np.int32),
        arrival=np.sort(rng.uniform(0, 0.01 * n, n)).astype(np.float32),
        safety=np.full(n, 0.05, np.float32),
        group=np.zeros(n, np.int32),
        valid=np.ones(n, bool))
    return ta, TaskArrays(
        kind=torch.as_tensor(ta.kind, dtype=torch.int64),
        arrival=torch.as_tensor(ta.arrival),
        safety=torch.as_tensor(ta.safety),
        group=torch.as_tensor(ta.group, dtype=torch.int64),
        valid=torch.as_tensor(ta.valid))


def engine_pair(executor="stub", **cfg):
    """The JAX engine and the port's (on the CPU), same config."""
    return (EngineJax(PLATFORM_JAX, AGENT.learner.eval_p, QoSConfigJax(**cfg),
                      backlog_scale=BACKLOG, executor=executor),
            port_engine(executor, **cfg))


def port_engine(executor="stub", mesh=None, device="cpu", **cfg):
    return qos.QoSPlacementEngine(PLATFORM, PARAMS, qos.QoSConfig(**cfg),
                                  backlog_scale=BACKLOG, executor=executor,
                                  mesh=mesh, device=device)


def submit_pair(engines, jobs, seed):
    """Submit (n_tasks, arrival, deadline or None) jobs to both engines,
    job i on route seed + i; returns both engines' handles."""
    eng_j, eng_t = engines
    handles = []
    for i, (n, arr, deadline) in enumerate(jobs):
        ta_j, ta_t = route_pair(n, seed + i)
        handles.append((eng_j.submit(ta_j, arrival=arr, deadline=deadline),
                        eng_t.submit(ta_t, arrival=arr, deadline=deadline)))
    return handles


def assert_same_digest(want: dict, got: dict, routes=None) -> bool:
    """The port's ``serving_digest`` ``got`` equals the JAX one ``want``
    (placements: equal, or a JAX rounding tie at the first difference;
    ``routes`` maps uid -> the JAX ``TaskArrays``).  Returns whether a tie
    was met."""
    place = {k for k in want if k.startswith("placements_")}
    # a durable engine's final states: R_Balance is the one field the
    # jitted JAX scan computes with a contracted FMA (held at rtol 1e-6,
    # as in tests/test_torch_scan_schedulers.py); every other one exact
    fma = {k for k in want if k.startswith("state_")
           and k.endswith("_R_Balance")}
    assert set(got) == set(want)
    assert digests_equal({k: got[k] for k in set(got) - place - fma},
                         {k: want[k] for k in set(want) - place - fma})
    for k in fma:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    ties = False
    for k in sorted(place):
        if np.array_equal(got[k], want[k]):
            continue
        assert routes is not None, f"{k} differs on the stub executor"
        ties = True
        _assert_same_placements(got[k], want[k], AGENT.learner.eval_p,
                                spec_jax(PLATFORM_JAX),
                                routes[int(k.split("_")[1])])
    return ties


def assert_same_serving(eng_j, eng_t, routes=None):
    """Equal digests (:func:`assert_same_digest`) and, where the
    placements are equal, equal ``stats()``."""
    ties = assert_same_digest(digest_jax(eng_j), serving_digest(eng_t),
                              routes)
    # a durable engine's snapshot_time_s is the wall time its snapshots took
    st, sj = ({k: v for k, v in e.stats().items() if k != "snapshot_time_s"}
              for e in (eng_t, eng_j))
    if not ties:
        assert st == sj
    assert st["dispatches"] == sj["dispatches"]


# ---------------------------------------------------------------------------
# bucket / config validation
# ---------------------------------------------------------------------------

def test_power_of_two_bucket_rejects_nonpositive_minimum():
    for bad in (0, -4):
        with pytest.raises(ValueError, match="minimum"):
            power_of_two_bucket(5, bad)
    for n, m in ((5, 16), (16, 16), (17, 16), (1, 1), (0, 1)):
        assert power_of_two_bucket(n, m) == qos.power_of_two_bucket(n, m) \
            == {(5, 16): 16, (16, 16): 16, (17, 16): 32, (1, 1): 1,
                (0, 1): 1}[(n, m)]


@pytest.mark.parametrize("kw,match", [
    (dict(chunk=8, min_bucket=0), "min_bucket"),
    (dict(chunk=8, min_bucket=24), "power of two"),
    (dict(chunk=0, min_bucket=16), "chunk"),
    (dict(chunk=12, min_bucket=16), "multiple"),
    (dict(slots=0), "slots"),
    (dict(stages=0), "stages"),
    (dict(continuous=True, stages=2), "pick one"),
    (dict(policy="lifo"), "policy")])
def test_qos_config_validates_knobs(kw, match):
    qos.QoSConfig(chunk=8, min_bucket=16)      # a sane config constructs
    for cfg in (QoSConfigJax, qos.QoSConfig):
        with pytest.raises(ValueError, match=match):
            cfg(**kw)


@pytest.mark.parametrize("case", ["stub", "mesh", "durable"])
def test_pipeline_waves_refuse_stub_mesh_and_durability(case):
    """Pipeline waves need the device executor, have no 1-D mesh path and
    no durability layer, in both packages (twin of
    ``tests/test_pipeline.py::test_durability_rejects_pipeline_waves``)."""
    from repro.serve.durability import DurableQoSEngine as DurableJax
    from repro_torch.serve.durability import DurableQoSEngine
    kw, match = {"stub": (dict(executor="stub"), "executor"),
                 "mesh": (dict(mesh=object()), "single-stage"),
                 "durable": ({}, "pipeline")}[case]
    cls_j, cls_t = ((DurableJax, DurableQoSEngine) if case == "durable"
                    else (EngineJax, qos.QoSPlacementEngine))
    with pytest.raises(ValueError, match=match):
        cls_j(PLATFORM_JAX, AGENT.learner.eval_p, QoSConfigJax(stages=2),
              **kw)
    with pytest.raises(ValueError, match=match):
        cls_t(PLATFORM, PARAMS, qos.QoSConfig(stages=2), device="cpu", **kw)


def test_durable_engine_rejects_continuous_and_measured():
    from repro_torch.serve.durability import DurableQoSEngine
    for kw in (dict(continuous=True), dict(measured_svc=True)):
        cfg = qos.QoSConfig(policy="edf", chunk=16, min_bucket=16, **kw)
        with pytest.raises(ValueError):
            DurableQoSEngine(PLATFORM, PARAMS, cfg, backlog_scale=BACKLOG,
                             executor="stub", device="cpu")


def test_engine_refuses_unknown_executors():
    with pytest.raises(ValueError, match="executor"):
        port_engine(executor="greedy")


# ---------------------------------------------------------------------------
# a generated trace served end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("continuous", [False, True])
def test_submit_trace_serves_end_to_end(continuous):
    base_j, base_t = route_pair(24, 5)
    cfg_j = LoadGenConfigJax(n_requests=8, offered_load=1.0, seed=2)
    trace_j = generate_jax(base_j, PLATFORM_JAX.n, cfg_j, mean_service=0.05)
    draws = _jax_draws(2, cfg_j.families, 2, 24, PLATFORM.n)
    trace_t = generate(base_t, PLATFORM.n,
                       LoadGenConfig(n_requests=8, offered_load=1.0, seed=2),
                       mean_service=0.05, draws=draws)
    eng_j, eng_t = engine_pair(policy="edf", slots=2, chunk=16,
                               min_bucket=16, continuous=continuous)
    reqs_j = submit_trace_jax(eng_j, trace_j)
    reqs_t = submit_trace(eng_t, trace_t)
    assert [r.arrival for r in reqs_t] == [t.arrival for t in trace_t]
    assert [r.deadline for r in reqs_t] == [r.deadline for r in reqs_j]
    eng_j.run_until_done()
    eng_t.run_until_done()
    s = eng_t.stats()
    assert s["completed"] + s["shed"] == 8
    assert s["queued"] == 0 and s["in_flight"] == 0
    assert_same_serving(eng_j, eng_t)


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("policy", ["edf", "fifo"])
def test_greedy_placements_match_jax(policy, continuous):
    """Drain and continuous waves on the greedy scheduler, EDF with
    preemption and shedding, and FIFO: the same serving outcome and
    placements as the JAX engine.  A long route runs first; a short one
    arrives mid-wave with a deadline that preempts it, another arrives
    already infeasible."""
    engines = engine_pair(executor=None, policy=policy, slots=2, chunk=8,
                          min_bucket=16, continuous=continuous,
                          laxity_s=1e-4)
    svc = engines[1].svc
    jobs = [(60, 0.0, None), (12, 20 * svc, 60 * svc),
            (30, 0.001, 0.001 + 5 * svc), (20, 0.002, None),
            (45, 0.004, None), (9, 0.01, None), (50, 30 * svc, None)]
    submit_pair(engines, jobs, seed=40)
    for eng in engines:
        eng.run_until_done()
    eng_j, eng_t = engines
    routes = {i: route_pair(n, 40 + i)[0] for i, (n, _, _) in enumerate(jobs)}
    assert_same_serving(eng_j, eng_t, routes)
    s = eng_t.stats()
    assert s["completed"] >= 3 and s["completed"] + s["shed"] == len(jobs)
    if policy == "edf":
        assert s["shed"] >= 1 and s["preemptions"] >= 1
        assert s["refills"] >= int(continuous)


# ---------------------------------------------------------------------------
# measured service times
# ---------------------------------------------------------------------------

def test_measured_service_ema_calibrates_with_virtual_fallback():
    """The port's EMA is keyed by bucket (the JAX engine's by (bucket,
    stages), stages always 1 here)."""
    kw = dict(policy="edf", slots=2, chunk=16, min_bucket=16, preempt=False,
              shed=False, measured_svc=True)
    eng_j, eng = engine_pair(**kw)
    assert eng._service_need(16) == 16 * eng.svc == eng_j._service_need(16)
    eng.submit(route_pair(10, 0)[1], arrival=0.0, deadline=1e9)
    eng.run_until_done()
    assert list(eng._svc_measured) == [16] and eng._svc_measured[16] > 0.0
    assert eng._service_need(16) == pytest.approx(16 * eng._svc_measured[16])
    assert eng._service_need(64) == 64 * eng.svc  # unseen bucket: virtual
    assert eng.now > 0.0  # the clock advanced by measured wall time


def test_measured_service_ema_update_rule():
    eng_j, eng = engine_pair(policy="edf", chunk=16, min_bucket=16,
                             measured_svc=True)
    assert qos.SVC_EMA == QoSConfigJax().svc_ema == 0.25
    for e, key in ((eng_j, (16, 1)), (eng, 16)):
        e._observe_service(16, 1.6)   # per-slot 0.1 seeds the EMA
        assert e._svc_measured[key] == pytest.approx(0.1)
        e._observe_service(16, 3.2)   # 0.75 * 0.1 + 0.25 * 0.2
        assert e._svc_measured[key] == pytest.approx(0.125)
    assert eng._svc_measured[16] == eng_j._svc_measured[(16, 1)]


def test_virtual_clock_unchanged_without_measured_svc():
    engines = engine_pair(policy="edf", slots=1, chunk=16, min_bucket=16,
                          preempt=False, shed=False)
    submit_pair(engines, [(10, 0.0, 1e9)], seed=0)
    for eng in engines:
        eng.run_until_done()
    eng_j, eng = engines
    assert eng._svc_measured == {}
    assert eng.now == pytest.approx(16 * eng.svc) and eng.now == eng_j.now
    assert eng.svc == eng_j.svc
    assert_same_serving(eng_j, eng)


# ---------------------------------------------------------------------------
# the launcher's routing of the QoS flags
# ---------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--routes", "3", "--route-km", "0.005",
          "--rate-scale", "0.002"]


@pytest.fixture
def made(monkeypatch):
    """The QoS engines the launcher builds, and the arrival of each
    route it submits."""
    out = {"engines": [], "arrivals": []}
    init, submit = qos.QoSPlacementEngine.__init__, \
        qos.QoSPlacementEngine.submit

    def spy_init(self, *a, **kw):
        init(self, *a, **kw)
        out["engines"].append(self)

    def spy_submit(self, tasks, arrival=0.0, deadline=None):
        out["arrivals"].append(arrival)
        return submit(self, tasks, arrival, deadline)

    monkeypatch.setattr(qos.QoSPlacementEngine, "__init__", spy_init)
    monkeypatch.setattr(qos.QoSPlacementEngine, "submit", spy_submit)
    return out


@pytest.mark.parametrize("flags", [
    ["--qos", "edf"], ["--arrival-gap", "0.02"], ["--qos", "fifo"],
    ["--deadline-scale", "1.0"], ["--continuous"], ["--measured-svc"],
    ["--qos", "edf", "--continuous", "--arrival-gap", "0.02"]])
def test_qos_flags_reach_the_qos_engine(flags, made, capsys):
    """Any QoS-shaped flag, even at its default value, sends
    ``--placement`` to the QoS engine, with the flag in its config."""
    assert serve_launch.main(["--placement", *flags, *LAUNCH]) == 0
    assert "qos[" in capsys.readouterr().out
    (eng,) = made["engines"]
    args = serve_launch.parser().parse_args(["--placement", *flags])
    assert eng.cfg.policy == (args.qos or "fifo")
    assert eng.cfg.deadline_scale == 1.0
    assert (eng.cfg.continuous, eng.cfg.measured_svc) == \
        (args.continuous, args.measured_svc)
    gap = 0.02 if "--arrival-gap" in flags else 0.05
    assert made["arrivals"] == [i * gap for i in range(3)]
    s = eng.stats()
    assert s["submitted"] == 3 and s["queued"] == s["in_flight"] == 0


def test_plain_placement_reaches_the_batch_service(made, capsys):
    assert serve_launch.main(["--placement", *LAUNCH]) == 0
    assert "placed 3 routes" in capsys.readouterr().out
    assert made["engines"] == []


def test_token_path_defaults_to_fifo():
    args = serve_launch.parser().parse_args(["--arch", "mamba2-130m",
                                             "--smoke", "--device", "cpu",
                                             "--requests", "2",
                                             "--max-new", "2"])
    assert args.qos is None and args.deadline_scale is None
    eng, _ = serve_launch.serve_tokens(args)
    assert eng.qos == "fifo" and eng.deadline_scale == 1.0
    assert len(eng.finished) == 2


def test_launcher_equals_the_jax_launcher(tmp_path, capsys):
    """``--placement --qos edf --continuous`` serves the JAX launcher's
    routes with the JAX launcher's outcome (same weights npz)."""
    from repro.core.flexai.dqn import save_dqn_npz
    from repro.launch import serve as serve_jax
    w = str(tmp_path / "w.npz")
    save_dqn_npz(w, AGENT.learner.eval_p)
    flags = ["--placement", "--qos", "edf", "--continuous", "--routes",
             "4", "--route-km", "0.005", "--rate-scale", "0.002",
             "--arrival-gap", "0.02", "--weights", w]
    assert serve_jax.main(flags) == 0
    want = capsys.readouterr().out
    assert serve_launch.main(flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    keys = ("served", "miss_rate", "shed", "preemptions", "refills",
            "p50_slack", "p99_slack")

    def fields(out):
        line = [ln for ln in out.splitlines() if ln.startswith("qos[")][0]
        toks = line.replace(":", " ").split()
        return {k: toks[toks.index(k) + 1] for k in keys}
    assert fields(got) == fields(want)


# ---------------------------------------------------------------------------
# pipeline waves (stages > 1; core.pipeline)
# ---------------------------------------------------------------------------

def _stage_agents():
    """The JAX stage agent of ``tests/test_pipeline.py`` and the port's
    with its weights."""
    from repro.core.pipeline import PipelineFlexAI as PipeJax
    from repro_torch.core.flexai import FlexAIConfig as ConfigT
    from repro_torch.core.pipeline import PipelineFlexAI
    kw = dict(min_replay=32, batch_size=16, update_every=2,
              eps_decay_steps=500, replay_capacity=2048, seed=2)
    pipe_j = PipeJax(PLATFORM_JAX, FlexAIConfig(**kw), n_stages=2)
    pipe_t = PipelineFlexAI(PLATFORM, ConfigT(**kw), n_stages=2,
                            device="cpu")
    pipe_t.set_params(params_from_numpy(pipe_j.eval_params()))
    return pipe_j, pipe_t


def _stage_routes(seeds, kms):
    from test_torch_pipeline import arrays_pair
    return [arrays_pair(s, km) for s, km in zip(seeds, kms)]


def _assert_same_stage_serving(eng_j, eng_t, routes):
    """Equal digests and stats; stage placements equal, or a JAX Q tie
    (``test_torch_pipeline.assert_same_placements``) on the route padded
    to its bucket."""
    from repro.core.tasks import pad_task_arrays as pad_jax
    from test_torch_pipeline import assert_same_placements
    want, got = digest_jax(eng_j), serving_digest(eng_t)
    place = {k for k in want if k.startswith("placements_")}
    assert set(got) == set(want)
    assert digests_equal({k: got[k] for k in set(got) - place},
                         {k: want[k] for k in set(want) - place})
    ties = False
    for k in sorted(place):
        if np.array_equal(got[k], want[k]):
            continue
        ties = True
        req = next(r for r in eng_j.completed
                   if r.uid == int(k.split("_")[1]))
        n = req.n_tasks
        pad = np.zeros((req.bucket, 2), got[k].dtype)
        assert_same_placements(eng_j.plan, eng_j.params,
                               pad_jax(routes[req.uid], req.bucket),
                               np.concatenate([got[k], pad[n:]]),
                               np.concatenate([want[k], pad[n:]]))
    if not ties:
        assert eng_t.stats() == eng_j.stats()


def test_qos_pipeline_wave_matches_direct_schedule():
    """A solo ``stages=2`` request reproduces the direct wavefront
    schedule of its bucket-padded route, and the JAX engine's outcome
    (twin of ``tests/test_pipeline.py``'s test of that name)."""
    from repro_torch.core.tasks import pad_task_arrays
    pipe_j, pipe_t = _stage_agents()
    ((ta_j, ta_t),) = _stage_routes([37], [0.02])
    cfg = dict(policy="edf", stages=2, slots=2, min_bucket=16)
    eng_j = EngineJax(PLATFORM_JAX, pipe_j.eval_params(), QoSConfigJax(**cfg),
                      backlog_scale=pipe_j.cfg.backlog_scale)
    eng_t = qos.QoSPlacementEngine(PLATFORM, pipe_t.eval_params(),
                                   qos.QoSConfig(**cfg), device="cpu",
                                   backlog_scale=pipe_t.cfg.backlog_scale)
    req_j, req = eng_j.submit(ta_j), eng_t.submit(ta_t)
    for eng in (eng_j, eng_t):
        eng.run_until_done()
    assert req.status == "completed" and req.summary["stages"] == 2
    n = ta_t.num_tasks
    assert req.summary["placements"].shape == (n, 2)
    direct = pipe_t.schedule(pad_task_arrays(ta_t, req.bucket))
    np.testing.assert_array_equal(req.summary["placements"],
                                  direct["placements"][:n])
    assert req.summary["stm_rate"] == pytest.approx(direct["stm_rate"],
                                                    abs=1e-9)
    assert eng_t.svc_step == eng_t.svc / 2
    assert eng_t.dispatches == eng_t._flat_len(req.bucket) // 16
    _assert_same_stage_serving(eng_j, eng_t, {req_j.uid: ta_j})


def test_qos_pipeline_preemption_does_not_change_placements():
    """Pipeline waves preempt at flat segment cuts with the ``(state,
    ring)`` checkpoint; placements are the same with preemption on and
    off, and the serving outcome is the JAX engine's in both."""
    pipe_j, pipe_t = _stage_agents()
    routes = _stage_routes([38, 39, 40], [0.03, 0.02, 0.02])

    def serve(preempt):
        cfg = dict(policy="edf", stages=2, slots=1, min_bucket=16,
                   preempt=preempt, laxity_s=1e-4, shed=False)
        eng_j = EngineJax(PLATFORM_JAX, pipe_j.eval_params(),
                          QoSConfigJax(**cfg),
                          backlog_scale=pipe_j.cfg.backlog_scale)
        eng_t = qos.QoSPlacementEngine(PLATFORM, pipe_t.eval_params(),
                                       qos.QoSConfig(**cfg), device="cpu")
        # the long route starts first with a slack deadline; tighter
        # routes arrive mid-wave and must preempt it at a segment cut
        for i, (arr, dl) in enumerate([(0.0, 1e6), (1e-4, 0.05),
                                       (2e-4, 0.06)]):
            eng_j.submit(routes[i][0], arrival=arr, deadline=dl)
            eng_t.submit(routes[i][1], arrival=arr, deadline=dl)
        for eng in (eng_j, eng_t):
            eng.run_until_done()
        _assert_same_stage_serving(eng_j, eng_t,
                                   {i: r[0] for i, r in enumerate(routes)})
        return eng_t

    on, off = serve(True), serve(False)
    assert on.preemption_count > 0 == off.preemption_count
    by_uid = {r.uid: r for r in off.completed}
    assert len(on.completed) == len(routes)
    for r in on.completed:
        np.testing.assert_array_equal(r.summary["placements"],
                                      by_uid[r.uid].summary["placements"])


def test_stage_launcher_equals_the_jax_launcher(tmp_path, capsys, made):
    """``--placement --qos edf --stages 2`` serves stage placements with
    the JAX launcher's outcome (the same stage weights npz)."""
    pipe_j, _ = _stage_agents()
    w = str(tmp_path / "stage.npz")
    pipe_j.save_weights(w)
    from repro.launch import serve as serve_jax
    flags = ["--placement", "--qos", "edf", "--stages", "2", "--routes",
             "3", "--route-km", "0.005", "--rate-scale", "0.002",
             "--arrival-gap", "0.02", "--weights", w]
    assert serve_jax.main(flags) == 0
    want = capsys.readouterr().out
    assert serve_launch.main(flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    (eng,) = made["engines"]
    assert eng.cfg.stages == 2 and eng.plan is not None
    assert all(r.summary["placements"].shape == (r.n_tasks, 2)
               for r in eng.completed) and eng.completed
    keys = ("served", "miss_rate", "shed", "preemptions", "refills",
            "p50_slack", "p99_slack")

    def fields(out):
        line = [ln for ln in out.splitlines() if ln.startswith("qos[")][0]
        toks = line.replace(":", " ").split()
        return {k: toks[toks.index(k) + 1] for k in keys}
    assert fields(got) == fields(want)


@pytest.mark.parametrize("extra,match", [
    (["--snapshot-dir", "SNAP"], "incompatible with durability"),
    (["--state-out", "SNAP/d.npz"], "incompatible with durability"),
    (["--shard"], "single-stage")])
def test_stage_launcher_refuses_durability_and_shard(extra, match, tmp_path,
                                                     capsys):
    extra = [x.replace("SNAP", str(tmp_path)) for x in extra]
    assert serve_launch.main(["--placement", "--stages", "2", *LAUNCH,
                              *extra]) == 1
    assert match in capsys.readouterr().out
