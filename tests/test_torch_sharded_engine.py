"""The port's sharded engines over a ``repro_torch.distributed`` mesh:
the greedy schedule, population and data-parallel training, the GA/SA
searches and the placement service, each against the port's own batched
path (the JAX sharded paths are the oracles of the JAX package only, and
its sharded GA/SA test fails in the JAX package itself).

One job of two gloo processes on the CPU runs every case once (about
15 s) and each rank writes what it saw; the tests read both ranks'
results.  Routes, lanes and draws are split in contiguous blocks, so the
schedules, the searches and the population (independent lanes) must
equal the batched path bit for bit, and the QoS engine's waves (3 lanes,
padded to 4) must give the same serving digest with the mesh as without.
The data-parallel trainer averages gradients over 2 lanes a rank and
then across the 2 ranks, where the unsharded trainer averages 4 lanes at
once: actions must be equal and parameters within atol 1e-3 (the JAX
package's bound for its sharded DP test, ``tests/test_dp_trainer.py``).
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import distributed as pdist
from repro_torch.core import environment as env
from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
from repro_torch.core.flexai import engine
from repro_torch.core.flexai.dqn import init_qnet
from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.platform import spec_from_platform
from repro_torch.core.schedulers import (GAConfig, SAConfig,
                                         make_metaheuristic_fn,
                                         make_sharded_metaheuristic_fn)
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
from repro_torch.serve import durability
from repro_torch.serve.durability import (DurableQoSEngine, FaultInjection,
                                          digests_equal, pack_engine,
                                          serving_digest)
from repro_torch.serve.engine import FlexAIPlacementService
from repro_torch.serve.qos import QoSConfig, QoSPlacementEngine

WORLD = 2
RS = 0.012
ROUTE = dict(route_km=0.01, rate_scale=RS, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)
KW = dict(min_replay=16, batch_size=16, update_every=1, eps_decay_steps=300,
          target_sync_every=8, replay_capacity=512, seed=6)
D, A = 58, 11


def _routes(seeds):
    return [env.build_task_queue(env.EnvironmentParams(seed=s, **ROUTE))
            for s in seeds]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _cases(mesh) -> dict:
    """Every case, on this rank; returns what the tests check."""
    res = {"rank": pdist.mesh_rank(mesh), "size": pdist.mesh_size(mesh)}
    plat = HMAIPlatform(capacity_scale=RS)
    spec = spec_from_platform(plat)
    queues = _routes((31, 32, 33, 39))   # 86 to 142 tasks
    batch = stack_task_arrays([tasks_to_arrays(q) for q in queues])
    gen = torch.Generator().manual_seed(0)
    params = init_qnet(D, A, gen)

    # greedy schedule
    want = engine.make_schedule_fn(spec, batched=True)(params, batch)
    got = engine.make_sharded_schedule_fn(spec, mesh)(params, batch)
    res["schedule"] = _same(got[0], want[0]) and _same(got[1], want[1])

    # population lanes (default draws from the generator)
    cfg = FlexAIConfig(**KW)

    def population():
        return engine.train_init(D, A, cfg.replay_capacity, seed=3, lanes=4,
                                 device="cpu")

    want = engine.make_train_fn(spec, cfg, batched=True)(population(), batch)
    got = engine.make_sharded_train_fn(spec, cfg, mesh)(population(), batch)
    res["population_actions"] = torch.equal(got[2].action, want[2].action)
    res["population_params"] = _same(got[0].eval_p, want[0].eval_p) and \
        _same(got[0].targ_p, want[0].targ_p)
    res["population_losses"] = torch.equal(got[3], want[3])
    res["population_rings"] = _same(got[0].replay[:5], want[0].replay[:5])
    res["population_counters"] = (
        np.array_equal(got[0].updates, want[0].updates)
        and np.array_equal(got[0].replay.size, want[0].replay.size)
        and int(want[0].updates.min()) >= 50)

    # data-parallel: 2 lanes a rank x 2 ranks vs 4 lanes unsharded
    def dp():
        return engine.dp_train_init(D, A, cfg.replay_capacity, 4, seed=3,
                                    device="cpu")

    want = engine.make_dp_train_fn(spec, cfg, 4)(dp(), batch)
    reduces, pmean = [], pdist.pmean
    pdist.pmean = lambda x, m: reduces.append(x.numel()) or pmean(x, m)
    try:
        got = engine.make_dp_train_fn(spec, cfg, 4, mesh=mesh,
                                      td_kernel=True)(dp(), batch)
    finally:
        pdist.pmean = pmean
    # one all-reduce of the flattened loss and gradients an update
    res["dp_reduces"] = (len(reduces), len(set(reduces)))
    res["dp_actions"] = torch.equal(got[2].action, want[2].action)
    res["dp_mask"] = torch.equal(got[4], want[4]) and \
        (got[0].updates, got[0].env_steps) == (want[0].updates,
                                               want[0].env_steps)
    res["dp_updates"] = want[0].updates
    res["dp_param_err"] = max(float((a - b).abs().max())
                              for a, b in zip(got[0].eval_p, want[0].eval_p))
    res["dp_loss_err"] = float((got[3] - want[3]).abs().max())
    res["dp_rings"] = _same(got[0].replay[:5], want[0].replay[:5])

    # GA / SA searches
    small = {"ga": GAConfig(window=8, population=6, generations=3),
             "sa": SAConfig(window=8, iters=12, chains=4)}
    for name, c in small.items():
        want = make_metaheuristic_fn(spec, name, c, batched=True)(5, batch)
        got = make_sharded_metaheuristic_fn(spec, name, mesh, c)(5, batch)
        res[f"search_{name}"] = _same(got[0], want[0]) and \
            _same(got[1], want[1])

    # placement service: 3 routes in a bucket, padded to the mesh
    kw = dict(min_bucket=64, device="cpu")
    want = FlexAIPlacementService(plat, params, **kw).place(queues[:3])
    svc = FlexAIPlacementService(plat, params, mesh=mesh, **kw)
    got = svc.place(queues[:3])
    res["service"] = all(
        np.array_equal(g["placements"], w["placements"])
        and g["stm_rate"] == w["stm_rate"] for g, w in zip(got, want))
    res["service_shards"] = svc.shards

    # QoS waves of 3 lanes, padded to the mesh and trimmed, every segment
    # after the first resuming from the wave's state
    for mode in ("drain", "continuous"):
        digests = []
        for m in (None, mesh):
            eng = QoSPlacementEngine(
                plat, params, QoSConfig(policy="edf", slots=3, chunk=8,
                                        min_bucket=16,
                                        continuous=mode == "continuous"),
                mesh=m, device="cpu")
            for i in range(5):
                eng.submit(queues[i % 4][:10 + 3 * i], arrival=0.002 * i,
                           deadline=100.0)
            eng.run_until_done()
            digests.append(serving_digest(eng))
            res[f"qos_{mode}_completed"] = eng.stats()["completed"]
        res[f"qos_{mode}"] = digests_equal(*digests)

    # the durable engine: its alive-masked dispatch on the mesh (3 lanes
    # padded to 4), healthy and with a core failing at once, equals the
    # unmeshed engine; a one-device pack resumed on the mesh (elastic
    # resume) finishes as the uninterrupted run
    durability.DEAD_AFTER_SEGMENTS = 1   # detect the fault at once

    def durable(m=None, faults=None):
        eng = DurableQoSEngine(
            plat, params, QoSConfig(policy="edf", slots=3, chunk=8,
                                    min_bucket=16),
            mesh=m, faults=faults, device="cpu")
        for i in range(5):
            eng.submit(queues[i % 4][:10 + 3 * i], arrival=0.002 * i,
                       deadline=100.0)
        return eng

    fault = [FaultInjection(at_time=0.0, core=0, factor=50.0)]
    for name, faults in (("durable_mesh", None),
                         ("durable_mesh_fault", fault)):
        one, meshed = durable(faults=faults), durable(mesh, faults)
        for eng in (one, meshed):
            eng.run_until_done()
        res[name] = digests_equal(serving_digest(one), serving_digest(meshed))
        res[f"{name}_masked"] = meshed.stats()["cores_masked"]
    ref, cut = durable(), durable()
    ref.run_until_done()
    res["durable_cut_waves"] = cut.serve_waves(1)
    elastic = DurableQoSEngine.from_packed(*pack_engine(cut), plat,
                                           mesh=mesh, device="cpu")
    elastic.run_until_done()
    res["durable_elastic"] = digests_equal(serving_digest(ref),
                                           serving_digest(elastic))
    res["durable_waves"] = len(ref.wave_log)

    # refusals
    refused = []
    trainer = ScanFlexAI(plat, cfg, lanes=4, mesh=mesh, device="cpu")
    trace = torch.ones(4, batch.num_tasks, A)
    for call in (
            lambda: trainer.train_episode(queues, health=trace),
            lambda: engine.make_sharded_train_fn(spec, cfg, mesh)(
                population(), batch, health=trace),
            lambda: ScanFlexAI(plat, cfg, lanes=3, mesh=mesh,
                               device="cpu"),
            lambda: engine.make_dp_train_fn(spec, cfg, 3, mesh=mesh),
            lambda: engine.make_sharded_schedule_fn(spec, mesh)(
                params, type(batch)(*[f[:3] for f in batch])),
            lambda: QoSPlacementEngine(plat, params, QoSConfig(),
                                       executor="stub", mesh=mesh,
                                       device="cpu")):
        try:
            call()
            refused.append(False)
        except ValueError:
            refused.append(True)
    res["refusals"] = refused
    return res


def _worker(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        res = _cases(pdist.make_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, str(out)), nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_the_job_runs_one_rank_a_process(ranks):
    assert [(r["rank"], r["size"]) for r in ranks] == [(0, 2), (1, 2)]


def test_sharded_schedule_equals_batched(ranks):
    assert all(r["schedule"] for r in ranks)


@pytest.mark.parametrize("what", ["actions", "params", "losses", "rings",
                                  "counters"])
def test_sharded_population_equals_batched(ranks, what):
    assert all(r[f"population_{what}"] for r in ranks)


def test_sharded_dp_matches_unsharded_dp(ranks):
    for r in ranks:
        assert r["dp_actions"] and r["dp_mask"] and r["dp_rings"]
        assert r["dp_updates"] >= 50
        assert r["dp_param_err"] < 1e-3 and r["dp_loss_err"] < 1e-3


def test_sharded_dp_all_reduces_on_update_steps_only(ranks):
    """The gradient all-reduce fires once an update and on no other
    step, the same number of times on every rank."""
    for r in ranks:
        assert r["dp_reduces"] == (r["dp_updates"], 1)


@pytest.mark.parametrize("name", ["ga", "sa"])
def test_sharded_search_equals_batched(ranks, name):
    assert all(r[f"search_{name}"] for r in ranks)


def test_sharded_placement_service_equals_unsharded(ranks):
    assert all(r["service"] and r["service_shards"] == 2 for r in ranks)


@pytest.mark.parametrize("mode", ["drain", "continuous"])
def test_sharded_qos_waves_equal_unsharded(ranks, mode):
    """``serving_digest`` (wave log, uids, finish, slack, clock,
    placements) of the QoS engine with the mesh equals the one without."""
    for r in ranks:
        assert r[f"qos_{mode}"] and r[f"qos_{mode}_completed"] == 5


@pytest.mark.parametrize("case", ["durable_mesh", "durable_mesh_fault"])
def test_durable_mesh_dispatch_equals_unmeshed(ranks, case):
    """The durable engine's alive-masked segments split over the mesh
    (``make_sharded_masked_fn``, the alive mask replicated) serve as the
    unmeshed engine does, with a dead core masked out too."""
    for r in ranks:
        assert r[case]
        assert r[f"{case}_masked"] == (case == "durable_mesh_fault")


def test_elastic_resume_onto_the_mesh(ranks):
    """A snapshot packed by a one-device engine after one admission
    round resumes on the two-rank mesh with the uninterrupted run's
    digest (the in-process twin of the JAX package's elastic resume
    subprocess test)."""
    for r in ranks:
        assert r["durable_cut_waves"] == 1 < r["durable_waves"]
        assert r["durable_elastic"]


def test_sharded_paths_refuse_traces_and_uneven_splits(ranks):
    assert all(all(r["refusals"]) for r in ranks), \
        [r["refusals"] for r in ranks]


def test_a_world_of_one_without_torchrun(tmp_path):
    """Without a process group, ``make_mesh`` starts a world of one (in a
    fresh process, so this test's own process stays out of any group)."""
    import subprocess
    import sys
    code = ("from repro_torch import distributed as d\n"
            "m = d.make_mesh('cpu')\n"
            "print(d.mesh_size(m), d.mesh_rank(m))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["1", "0"]


def test_launcher_shards_both_placement_paths():
    """``--shard`` on the plain and the QoS placement paths, each in a
    world of one started by the launcher (in a fresh process)."""
    import subprocess
    import sys
    code = (
        "from repro_torch.launch import serve as s\n"
        "a = ['--placement', '--shard', '--device', 'cpu', '--routes', '3',"
        " '--route-km', '0.005', '--rate-scale', '0.002']\n"
        "assert s.main(a) == 0\n"
        "assert s.main(a + ['--qos', 'edf', '--continuous']) == 0\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert sum("placement mesh: 1 process(es)" in ln for ln in lines) == 2
    assert any(ln.startswith("placed 3 routes") for ln in lines)
    assert any(ln.startswith("qos[edf] served ") for ln in lines)
