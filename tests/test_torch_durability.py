"""The port's durable QoS engine (``repro_torch.serve.durability``)
against the JAX package's: twins of the in-process tests of
``tests/test_durability.py``, an in-process twin of its SIGKILL
subprocess test, and the snapshot format shared by the two packages.

Every serving twin serves the same submissions through both engines
with the same weights and holds the port to the JAX engine with
``test_torch_qos.assert_same_serving``: equal ``serving_digest`` (its
``state_*`` entries, each completed request's final ``PlatformState``,
included) and equal ``stats()``.  A run cut and restored is held to the
JAX engine cut and restored at the same point, and to its own
uninterrupted run bit for bit.  The queueing checks ride the stub
executor, as the JAX tests do.  The elastic-resume twin and the mesh
dispatch twin run in the gloo job of ``tests/test_torch_sharded_engine.py``.
"""
import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from repro.core.faults import FaultEvent as FaultEventJax
from repro.core.faults import random_fault_events as random_faults_jax
from repro.core.flexai import FlexAIAgent, FlexAIConfig
from repro.core.platform_jax import HEALTH_FLOOR as HEALTH_FLOOR_JAX
from repro.core.tasks import pad_route_batch as pad_route_batch_jax
from repro.serve import durability as dur_jax
from repro.serve.durability import serving_digest as digest_jax
from repro.serve.qos import QoSConfig as QoSConfigJax
from repro_torch.core.faults import FaultEvent, random_fault_events
from repro_torch.core.flexai.dqn import params_from_numpy
from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.platform import HEALTH_FLOOR
from repro_torch.core.tasks import TaskArrays, pad_route_batch
from repro_torch.launch import serve as serve_launch
from repro_torch.serve import durability as dur
from repro_torch.serve.qos import QoSConfig
from repro_torch.train import checkpoint as ckpt_lib
from test_torch_qos import (AGENT, BACKLOG, PARAMS, PLATFORM, PLATFORM_JAX,
                            assert_same_digest, assert_same_serving,
                            route_pair)

CFG = dict(policy="edf", slots=2, chunk=16, min_bucket=16)


def _faults(kw, jax):
    """``faults=`` as each package's ``FaultInjection``."""
    kw = dict(kw)
    if kw.get("faults") is not None:
        cls = dur_jax.FaultInjection if jax else dur.FaultInjection
        kw["faults"] = [cls(**dataclasses.asdict(f)) for f in kw["faults"]]
    return kw


def jax_engine(executor=None, agent=AGENT, **kw):
    return dur_jax.DurableQoSEngine(
        PLATFORM_JAX, agent.learner.eval_p, QoSConfigJax(**CFG),
        backlog_scale=agent.cfg.backlog_scale, executor=executor,
        **_faults(kw, jax=True))


def port_engine(executor=None, params=PARAMS, **kw):
    return dur.DurableQoSEngine(PLATFORM, params, QoSConfig(**CFG),
                                backlog_scale=BACKLOG, executor=executor,
                                device="cpu", **_faults(kw, jax=False))


def engine_pair(executor=None, tmp=None, agent=AGENT, params=PARAMS,
                dead_after_segments=None, **kw):
    """The JAX durable engine and the port's (on the CPU), same config;
    with ``tmp`` each snapshots into its own directory under it.  The
    port's ``dead_after_segments`` is the module constant
    ``DEAD_AFTER_SEGMENTS``, which a test patches to the JAX value."""
    dirs = ({"jax": {}, "port": {}} if tmp is None else
            {"jax": dict(snapshot_dir=str(tmp / "jax")),
             "port": dict(snapshot_dir=str(tmp / "port"))})
    if dead_after_segments is not None:
        assert dur.DEAD_AFTER_SEGMENTS == dead_after_segments
        dirs["jax"]["dead_after_segments"] = dead_after_segments
    return (jax_engine(executor, agent, **dirs["jax"], **kw),
            port_engine(executor, params, **dirs["port"], **kw))


def submit(engines, n_req=6, seed=0, tight=False):
    """``tests/test_durability.py``'s ``_submit`` on every engine; returns
    uid -> the JAX ``TaskArrays``."""
    rng = np.random.default_rng(seed)
    t, routes = 0.0, {}
    base_svc = engines[0].base_svc
    for i in range(n_req):
        n = int(rng.integers(40, 90))
        budget = None
        if tight:
            budget = t + float(engines[0]._bucket(n) * base_svc
                               * rng.uniform(1.0, 2.0))
        ta_j, ta_t = route_pair(n, seed + 10 * i)
        for eng in engines:
            eng.submit(ta_j if isinstance(eng, dur_jax.DurableQoSEngine)
                       else ta_t, arrival=t, deadline=budget)
        routes[i] = ta_j
        t += float(rng.uniform(0.0, base_svc * 16))
    return routes


def _crash_mid_wave(engine, snapshot_dir):
    """Serve two admission rounds with snapshots every 3 segments, then
    drop the engine with no boundary snapshot."""
    crashed = engine(snapshot_dir=snapshot_dir, snapshot_every=3)
    submit((crashed,), 4)
    crashed.serve_waves(2)
    crashed.saver.wait()
    assert crashed.snapshots_written > 0


def _restore_pair(dir_j, dir_t):
    """Each package's engine restored from a snapshot directory (each
    its own: a restored engine snapshots on into it) and run to the
    end."""
    eng_j = dur_jax.DurableQoSEngine.restore(dir_j, PLATFORM_JAX,
                                             backlog_scale=BACKLOG)
    eng_t = dur.DurableQoSEngine.restore(dir_t, PLATFORM,
                                         backlog_scale=BACKLOG, device="cpu")
    assert eng_t._inflight is not None   # genuinely mid-wave
    for eng in (eng_j, eng_t):
        eng.run_until_done()
        eng.saver.wait()
    return eng_j, eng_t


@pytest.fixture
def detect_after_one(monkeypatch):
    """The JAX tests' ``dead_after_segments=1``: the port's constant,
    patched."""
    monkeypatch.setattr(dur, "DEAD_AFTER_SEGMENTS", 1)


@pytest.fixture
def sigterm():
    """The launcher installs a ``PreemptionGuard`` SIGTERM handler; put
    the test process's own back afterwards."""
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


# ---------------------------------------------------------------------------
# snapshot round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["stub", None], ids=["stub", "real"])
def test_pack_unpack_roundtrip_bit_exact(executor):
    """A crash at a wave boundary, rebuilt from the in-memory pack and
    finished, equals the uninterrupted run, which equals the JAX
    engine's."""
    n_req = 6 if executor == "stub" else 4
    ref_j, ref_t = engine_pair(executor)
    routes = submit((ref_j, ref_t), n_req)
    ref_j.run_until_done()
    ref_t.run_until_done()
    assert_same_serving(ref_j, ref_t, routes)

    crashed = port_engine(executor)
    submit((crashed,), n_req)
    crashed.serve_waves(2)
    resumed = dur.DurableQoSEngine.from_packed(
        *dur.pack_engine(crashed), PLATFORM, backlog_scale=BACKLOG,
        executor=executor, device="cpu")
    resumed.run_until_done()
    assert dur.digests_equal(dur.serving_digest(ref_t),
                             dur.serving_digest(resumed))
    assert resumed.stats() == ref_t.stats()


def test_blob_encode_roundtrip():
    eng = port_engine("stub")
    submit((eng,))
    eng.serve_waves(2)
    arrays, meta = dur.pack_engine(eng)
    arrays2, meta2 = dur.decode_snapshot(dur.encode_snapshot(arrays, meta))
    assert meta2 == json.loads(json.dumps(meta))
    assert len(arrays) == len(arrays2)
    for a, b in zip(arrays, arrays2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_disk_restore_mid_wave_bit_exact(tmp_path):
    """The cadence snapshot lands inside a wave; restoring it resumes the
    wave (re-applying the preemption check) and ends bit-exact against
    the uninterrupted run, as the JAX engine's crash and restore do."""
    ref_j, ref_t = engine_pair()
    routes = submit((ref_j, ref_t), 4)
    ref_j.run_until_done()
    ref_t.run_until_done()
    assert_same_serving(ref_j, ref_t, routes)

    _crash_mid_wave(port_engine, str(tmp_path / "port"))
    _crash_mid_wave(jax_engine, str(tmp_path / "jax"))
    res_j, res_t = _restore_pair(str(tmp_path / "jax"),
                                 str(tmp_path / "port"))
    assert dur.digests_equal(dur.serving_digest(ref_t),
                             dur.serving_digest(res_t))
    assert_same_serving(res_j, res_t, routes)


def test_snapshots_do_not_perturb_serving(tmp_path):
    ref = port_engine("stub")
    submit((ref,))
    ref.run_until_done()
    snap_j, snap_t = engine_pair("stub", tmp_path, snapshot_every=4)
    submit((snap_j, snap_t))
    for eng in (snap_j, snap_t):
        eng.run_until_done()
        eng.saver.wait()
    assert snap_t.snapshots_written == snap_j.snapshots_written > 0
    assert dur.digests_equal(dur.serving_digest(ref),
                             dur.serving_digest(snap_t))
    assert_same_serving(snap_j, snap_t)


def test_restored_engine_keeps_snapshotting_monotonically(tmp_path):
    """A restored engine inherits the cadence and continues the crashed
    run's snapshot counter, as the JAX engine's does; at most
    ``SNAPSHOT_KEEP`` stay on disk."""
    restored = []
    for pkg, engine, plat, kw in (
            (dur_jax, jax_engine, PLATFORM_JAX, {}),
            (dur, port_engine, PLATFORM, {"device": "cpu"})):
        d = str(tmp_path / pkg.__name__)
        crashed = engine("stub", snapshot_dir=d, snapshot_every=3)
        submit((crashed,))
        crashed.serve_waves(2)
        crashed.saver.wait()
        step_at_crash = ckpt_lib.checkpoint_step(
            ckpt_lib.latest_checkpoint(d))
        assert step_at_crash == crashed.snapshots_written
        assert len(os.listdir(d)) == min(step_at_crash, dur.SNAPSHOT_KEEP)
        eng = pkg.DurableQoSEngine.restore(d, plat, backlog_scale=BACKLOG,
                                           executor="stub", **kw)
        assert eng.snapshot_every == 3
        eng.run_until_done()
        eng.saver.wait()
        assert eng.snapshots_written > step_at_crash
        assert ckpt_lib.checkpoint_step(ckpt_lib.latest_checkpoint(d)) \
            == eng.snapshots_written
        assert len(os.listdir(d)) == dur.SNAPSHOT_KEEP
        restored.append(eng)
    assert_same_serving(*restored)


def test_restore_refuses_another_platform(tmp_path):
    eng = port_engine("stub", snapshot_dir=str(tmp_path))
    submit((eng,), 2)
    eng.serve_waves(1)
    eng.snapshot()
    eng.saver.wait()
    with pytest.raises(ValueError, match="different platform"):
        dur.DurableQoSEngine.restore(
            str(tmp_path), HMAIPlatform(capacity_scale=0.5),
            backlog_scale=BACKLOG, executor="stub", device="cpu")


# ---------------------------------------------------------------------------
# the snapshot format is the JAX package's
# ---------------------------------------------------------------------------

def _r_balance_refs(meta) -> set:
    """Indices of the R_Balance arrays (field 5 of every packed
    ``PlatformState``) of a pack's meta."""
    waves = meta["preempted"] + ([meta["inflight"]] if meta["inflight"]
                                 else [])
    return ({w["state"][0] + 5 for w in waves}
            | {r[0] + 5 for r in meta["final_states"].values()})


def _assert_meta_equal(a, b, key=""):
    """JSON-normalized equality; a summary's ``r_balance`` at rtol 1e-6
    (the FMA the jitted JAX scan contracts there)."""
    if isinstance(a, dict):
        assert set(a) == set(b), key
        for k in a:
            _assert_meta_equal(a[k], b[k], k)
    elif isinstance(a, list):
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            _assert_meta_equal(x, y, key)
    elif key == "r_balance":
        assert a == pytest.approx(b, rel=1e-6)
    else:
        assert a == b, key


@pytest.mark.parametrize("executor", ["stub", None], ids=["stub", "real"])
def test_pack_equals_the_jax_pack(executor):
    """After the same two admission rounds both packs hold the same meta
    (JSON-normalized) and the same array values (R_Balance at rtol 1e-6
    on the greedy scheduler); the port's dtype differs only where its
    field does (int64 kinds, groups, actions and placements)."""
    eng_j, eng_t = engine_pair(executor)
    submit((eng_j, eng_t), 4)
    eng_j.serve_waves(2)
    eng_t.serve_waves(2)
    arrays_j, meta_j = dur_jax.pack_engine(eng_j)
    arrays_t, meta_t = dur.pack_engine(eng_t)
    _assert_meta_equal(json.loads(json.dumps(meta_j)),
                       json.loads(json.dumps(meta_t)))
    fma = _r_balance_refs(meta_j)
    assert fma and len(arrays_t) == len(arrays_j)
    for i, (a, b) in enumerate(zip(arrays_t, arrays_j)):
        assert a.shape == b.shape
        if i in fma:
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype or (a.dtype, b.dtype) == (np.int64,
                                                            np.int32)


def test_jax_snapshot_restores_in_the_port(tmp_path):
    """A snapshot the JAX engine wrote mid-wave restores in the port's
    engine, which finishes with the JAX uninterrupted digest, and as the
    JAX engine restored from the same snapshot does."""
    ref_j = jax_engine()
    routes = submit((ref_j,), 4)
    ref_j.run_until_done()
    _crash_mid_wave(jax_engine, str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    res_j, res_t = _restore_pair(str(tmp_path / "jax"),
                                 str(tmp_path / "port"))
    assert_same_digest(digest_jax(ref_j), dur.serving_digest(res_t), routes)
    assert_same_serving(res_j, res_t, routes)


@pytest.mark.parametrize("field,value", [("max_preemptions", 3),
                                         ("svc_ema", 0.5),
                                         ("svc_per_task", 0.01)])
def test_jax_snapshot_with_another_constant_is_refused(tmp_path, field,
                                                       value):
    eng = dur_jax.DurableQoSEngine(
        PLATFORM_JAX, AGENT.learner.eval_p,
        QoSConfigJax(**CFG, **{field: value}), backlog_scale=BACKLOG,
        executor="stub", snapshot_dir=str(tmp_path))
    submit((eng,), 2)
    eng.serve_waves(1)
    eng.snapshot()
    eng.saver.wait()
    with pytest.raises(ValueError, match=field):
        dur.DurableQoSEngine.restore(str(tmp_path), PLATFORM,
                                     backlog_scale=BACKLOG, executor="stub",
                                     device="cpu")


# ---------------------------------------------------------------------------
# the launcher's crash recovery, in process
# ---------------------------------------------------------------------------

LAUNCH = ["--placement", "--routes", "4", "--rate-scale", "0.005",
          "--seed", "0", "--qos", "edf"]


def test_launcher_crash_mid_wave_recovers_the_jax_digest(tmp_path, capsys,
                                                         sigterm):
    """The SIGKILL test's workload: the launcher's engine with cadence
    snapshots every 4 segments, cut after its third snapshot with no
    boundary snapshot and dropped; ``--resume`` finishes it with the
    digest of the JAX launcher's uninterrupted ``--state-out`` run (the
    same weights npz)."""
    from repro.core.flexai.dqn import save_dqn_npz
    from repro.launch import serve as serve_jax
    w = str(tmp_path / "w.npz")
    save_dqn_npz(w, AGENT.learner.eval_p)
    launch = LAUNCH + ["--weights", w]
    ref = str(tmp_path / "ref.npz")
    assert serve_jax.main(launch + ["--state-out", ref]) == 0
    snaps = str(tmp_path / "snaps")
    args = serve_launch.parser().parse_args(
        launch + ["--snapshot-dir", snaps, "--snapshot-every", "4",
                  "--device", "cpu"])
    eng = serve_launch.qos_engine(args)
    while eng.snapshots_written < 3:
        assert eng.serve_waves(1) == 1
    eng.saver.wait()
    del eng
    out = str(tmp_path / "resumed.npz")
    capsys.readouterr()
    assert serve_launch.main(launch + ["--resume", "--snapshot-dir", snaps,
                                       "--state-out", out, "--device",
                                       "cpu"]) == 0
    assert "resumed snapshot" in capsys.readouterr().out
    with np.load(ref) as a, np.load(out) as b:
        want, got = dict(a), dict(b)
    assert any(k.startswith("state_") for k in want)
    assert_same_digest(want, got)


# ---------------------------------------------------------------------------
# fault injection and graceful degradation
# ---------------------------------------------------------------------------

def _fault_workload():
    """The recovery benchmark's degradation workload (16 routes, agent
    seed 0), its busiest core failing x50 at a quarter of the healthy
    run's virtual time: the healthy, handled and unhandled runs of each
    engine."""
    from benchmarks.recovery import _busiest_core, _routes, _submit
    agent = FlexAIAgent(PLATFORM_JAX, FlexAIConfig(seed=0))
    params = params_from_numpy(agent.learner.eval_p)
    queues = _routes(16)
    queues_t = [TaskArrays(
        kind=torch.as_tensor(q.kind, dtype=torch.int64),
        arrival=torch.as_tensor(q.arrival),
        safety=torch.as_tensor(q.safety),
        group=torch.as_tensor(q.group, dtype=torch.int64),
        valid=torch.as_tensor(q.valid)) for q in queues]

    def run(faults=None):
        pair = engine_pair(agent=agent, params=params, faults=faults)
        _submit(pair[0], queues)
        _submit(pair[1], queues_t)
        for eng in pair:
            eng.run_until_done()
        return pair

    ref = run()
    core = _busiest_core(ref[0])
    assert core == _busiest_core(ref[1])

    def fault(handled):
        return [dur.FaultInjection(at_time=0.25 * float(ref[0].now),
                                   core=core, factor=50.0, handled=handled)]
    return ref, run(fault(True)), run(fault(False)), queues


def test_fault_graceful_degradation_contract():
    ref, handled, unhandled, queues = _fault_workload()
    routes = dict(enumerate(queues))
    for eng_j, eng_t in (ref, handled, unhandled):
        assert_same_serving(eng_j, eng_t, routes)
    sh, su = handled[1].stats(), unhandled[1].stats()
    assert sh["faults_fired"] == su["faults_fired"] == 1
    assert sh["cores_masked"] == 1 and su["cores_masked"] == 0
    assert sh["svc_scale"] > 1.0
    eng = handled[1]
    assert eng.fired == handled[0].fired
    assert eng.fired[0]["detected_at"] is not None
    masked = eng.fired[0]["core"]
    assert not eng.alive[masked]
    last = max((r for r in eng.completed if r.summary is not None),
               key=lambda r: r.finish)
    assert masked not in np.asarray(last.summary["placements"]).tolist()
    assert sh["miss_rate"] < su["miss_rate"]
    assert unhandled[1].now > ref[1].now


def test_straggler_mitigation_keeps_core_in_argmax(fixed_seed,
                                                   detect_after_one):
    assert 3.0 < dur.DEAD_CORE_FACTOR == dur_jax.DEAD_CORE_FACTOR
    engines = engine_pair(
        "stub", faults=[dur.FaultInjection(at_time=0.0, core=1, factor=3.0)],
        dead_after_segments=1)
    submit(engines, 6, seed=fixed_seed)
    for e in engines:
        e.run_until_done()
    assert_same_serving(*engines)
    eng = engines[1]
    s = eng.stats()
    assert s["faults_fired"] == 1 and eng.fired == engines[0].fired
    assert eng.fired[0]["detected_at"] is not None
    assert s["cores_masked"] == 0 and eng.alive.all()
    assert eng.health[1] == pytest.approx(1.0 / 3.0)
    np.testing.assert_array_equal(eng.health, engines[0].health)
    assert s["svc_scale"] > 1.0


def test_dead_core_health_belief_zeroed(fixed_seed, detect_after_one):
    engines = engine_pair(
        "stub", faults=[dur.FaultInjection(at_time=0.0, core=2,
                                           factor=50.0)],
        dead_after_segments=1)
    submit(engines, 6, seed=fixed_seed)
    for e in engines:
        e.run_until_done()
    assert_same_serving(*engines)
    eng = engines[1]
    assert not eng.alive[2] and eng.health[2] == 0.0
    et = eng.healthy_spec.exec_time.numpy().astype(np.float64)
    cap = 1.0 / et.mean(axis=1)
    assert eng.svc_scale == pytest.approx(cap.sum() / cap[eng.alive].sum())


def test_injections_from_fault_events_bridge():
    svc = 0.01
    raw = [(4, 2, 0.0), (2, 1, 0.5), (9, 1, 1.0)]
    inj = dur.injections_from_fault_events(
        [FaultEvent(*e) for e in raw], svc)
    want = dur_jax.injections_from_fault_events(
        [FaultEventJax(*e) for e in raw], svc)
    assert [dataclasses.asdict(f) for f in inj] == \
        [dataclasses.asdict(f) for f in want]
    assert HEALTH_FLOOR == HEALTH_FLOOR_JAX
    assert [f.at_time for f in inj] == [2 * svc, 4 * svc, 9 * svc]
    assert [f.core for f in inj] == [1, 2, 1]
    assert inj[0].factor == pytest.approx(2.0)
    assert inj[0].factor * inj[2].factor == pytest.approx(1.0)
    assert inj[1].factor == pytest.approx(1.0 / HEALTH_FLOOR)
    assert inj[1].factor >= dur.DEAD_CORE_FACTOR


def test_seeded_schedule_drives_serving(fixed_seed, detect_after_one):
    events = random_fault_events(fixed_seed, n_steps=64,
                                 n_cores=PLATFORM.n, n_faults=2)
    assert [tuple(e) for e in events] == [tuple(e) for e in random_faults_jax(
        fixed_seed, n_steps=64, n_cores=PLATFORM.n, n_faults=2)]
    probe = port_engine("stub")
    engines = engine_pair(
        "stub", faults=dur.injections_from_fault_events(events, probe.svc),
        dead_after_segments=1)
    n_req = 8
    submit(engines, n_req, seed=fixed_seed, tight=True)
    for e in engines:
        e.run_until_done()
    assert_same_serving(*engines)
    eng = engines[1]
    assert eng.stats()["faults_fired"] >= 1
    done = [r.uid for r in eng.completed]
    shed = [d["uid"] for d in eng.dead_letter]
    assert sorted(done + shed) == list(range(n_req))


def test_unhandled_fault_on_the_real_executor_pays_its_charge():
    """The fault charge, in float64 on the host records, keeps the JAX
    virtual clock's bits on the greedy scheduler."""
    engines = engine_pair(
        faults=[dur.FaultInjection(at_time=0.0, core=0, factor=20.0,
                                   handled=False)])
    routes = submit(engines, 4)
    for e in engines:
        e.run_until_done()
    assert_same_serving(*engines, routes)
    assert engines[1].stats()["faults_fired"] == 1


# ---------------------------------------------------------------------------
# AsyncCheckpointer retry with backoff (a flaky filesystem)
# ---------------------------------------------------------------------------

def test_async_checkpointer_retries_transient_oserror(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = ckpt_lib._write

    def flaky(directory, step, names, host):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient filesystem blip")
        return real(directory, step, names, host)

    monkeypatch.setattr(ckpt_lib, "_write", flaky)
    saver = ckpt_lib.AsyncCheckpointer(str(tmp_path), retries=3,
                                       backoff_s=0.0)
    saver.save(1, {"w": torch.arange(4.0)})
    saver.wait()   # must not raise
    assert calls["n"] == 3
    path = ckpt_lib.latest_checkpoint(str(tmp_path))
    assert path is not None and ckpt_lib.checkpoint_step(path) == 1


def test_async_checkpointer_exhausted_retries_surface(tmp_path, monkeypatch):
    def broken(directory, step, names, host):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib, "_write", broken)
    saver = ckpt_lib.AsyncCheckpointer(str(tmp_path), retries=2,
                                       backoff_s=0.0)
    saver.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        saver.wait()


# ---------------------------------------------------------------------------
# the launcher's refusals, and the batch padding of the mesh path
# ---------------------------------------------------------------------------

def test_inject_core_validated_against_platform(capsys):
    for core in ("99", "-1"):
        assert serve_launch.main(["--placement", "--routes", "1",
                                  "--inject-core", core, "--device",
                                  "cpu"]) == 1
        assert "out of range" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--continuous", "--measured-svc"])
def test_launcher_refuses_durability_with_continuous_or_measured(flag,
                                                                 capsys):
    assert serve_launch.main(["--placement", "--routes", "1", flag,
                              "--serve-waves", "1", "--device", "cpu"]) == 1
    assert "incompatible with durability" in capsys.readouterr().out


def test_pad_route_batch_pads_with_invalid_lanes():
    ta_j, ta_t = route_pair(20, seed=1)
    batch_j = type(ta_j)(*[np.stack([np.asarray(x)] * 3) for x in ta_j])
    batch_t = TaskArrays(*[torch.stack([x] * 3) for x in ta_t])
    want, got = pad_route_batch_jax(batch_j, 2), pad_route_batch(batch_t, 2)
    assert got.kind.shape[0] == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got.valid[3].any()
