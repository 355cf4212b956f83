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

The stage pipeline's mesh paths run in the same job (``_stage_cases``):
the two processes also form a (2, 1) ``("stages", "routes")`` mesh at 2
stages and a (1, 2) one at 1 stage, where the stage-sharded wavefront's
records, rings and ``combine_stage_states`` must equal the flat engine's
bit for bit (the JAX sharded pipeline does not run on this jax, so the
port's flat engine, which ``tests/test_torch_pipeline.py`` holds to the
JAX package, is the oracle); on the 1-D mesh the population stage
trainer equals the batched one bit for bit, the DP stage trainer holds
the DP bound above, and ``PipelineFlexAI(mesh=)`` trains, schedules and
round-trips its weights in both modes.
"""
import dataclasses
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
from repro_torch.core import pipeline
from repro_torch.core.schedulers import (GAConfig, SAConfig,
                                         make_metaheuristic_fn,
                                         make_sharded_metaheuristic_fn)
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
from repro_torch.launch.mesh import make_platform_mesh
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
D_STAGE = pipeline.stage_state_dim(A)


def _routes(seeds):
    return [env.build_task_queue(env.EnvironmentParams(seed=s, **ROUTE))
            for s in seeds]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _cases(mesh, out_dir: str) -> dict:
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

    res.update(_stage_cases(mesh, plat, spec, queues, batch, cfg, out_dir))

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


def _stage_cases(mesh, plat, spec, queues, batch, cfg, out_dir) -> dict:
    """The stage pipeline's mesh paths: the stage-sharded wavefront on
    2-D meshes of the job's two processes, (2, 1) at S = 2 and (1, 2) at
    S = 1, against the flat engine; the stage trainers and
    ``PipelineFlexAI`` on the job's 1-D mesh against the unsharded
    ones."""
    res = {}
    params = init_qnet(D_STAGE, A, torch.Generator().manual_seed(4))
    grids = {2: make_platform_mesh(2, "cpu"),
             1: pdist.make_mesh("cpu", shape=(1, 2),
                                axes=("stages", "routes"))}
    res["stage_grids"] = {S: (tuple(g.mesh_dim_names), tuple(g.shape),
                              pdist.mesh_rank(g, "stages"),
                              pdist.mesh_rank(g, "routes"))
                          for S, g in grids.items()}
    for S, grid in grids.items():
        plan = pipeline.build_stage_plan(plat, S)
        for policy in ("eft", "flexai"):
            fn = pipeline.make_sharded_pipeline_fn(spec, plan, grid,
                                                   policy=policy)
            states, ring, recs = fn(params, batch)
            final, f_ring, f_recs = pipeline.make_pipeline_schedule_fn(
                spec, plan, policy=policy, batched=True)(params, batch)
            key = f"stage_{S}_{policy}"
            # recs[s, r, k] against the flat engine's recs[r][k, s]
            res[f"{key}_recs"] = _same(recs, [f.permute(2, 0, 1)
                                              for f in f_recs])
            res[f"{key}_ring"] = torch.equal(ring.T, f_ring)
            res[f"{key}_state"] = _same(
                pipeline.combine_stage_states(plan, states), final)
            res[f"{key}_stats"] = dict(fn.stats)
            res[f"{key}_tasks"] = batch.num_tasks

    # population stage lanes, default draws from the generator
    plan = pipeline.build_stage_plan(plat, 2)

    def population():
        return engine.train_init(D_STAGE, A, cfg.replay_capacity, seed=3,
                                 lanes=4, device="cpu")

    want = pipeline.make_pipeline_train_fn(spec, plan, cfg, batched=True)(
        population(), batch)
    got = pipeline.make_sharded_pipeline_train_fn(
        spec, plan, cfg, mesh, td_kernel=True)(population(), batch)
    res["stage_population"] = (
        torch.equal(got[2].action, want[2].action)
        and _same(got[0].eval_p, want[0].eval_p)
        and _same(got[0].targ_p, want[0].targ_p)
        and _same(got[0].replay[:5], want[0].replay[:5])
        and torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        and np.array_equal(got[0].updates, want[0].updates)
        and _same(got[1], want[1]))
    res["stage_population_updates"] = int(want[0].updates.min())

    # one DP stage agent: 2 lanes a rank x 2 ranks vs 4 lanes unsharded,
    # an update every 8 env steps (~110 updates): at every step (~270)
    # the two means' rounding, grown by Adam, flips a TD target's argmax
    # near update 115 and the trajectories part (ROADMAP question 8)
    dp_cfg = dataclasses.replace(cfg, update_every=8)

    def dp():
        return engine.dp_train_init(D_STAGE, A, cfg.replay_capacity, 4,
                                    seed=3, device="cpu")

    want = pipeline.make_pipeline_dp_train_fn(spec, plan, dp_cfg, 4)(
        dp(), batch)
    reduces, pmean = [], pdist.pmean
    pdist.pmean = lambda x, m, a=None: reduces.append(x.numel()) or \
        pmean(x, m, a)
    try:
        got = pipeline.make_pipeline_dp_train_fn(
            spec, plan, dp_cfg, 4, mesh=mesh, td_kernel=True)(dp(), batch)
    finally:
        pdist.pmean = pmean
    res["stage_dp_reduces"] = (len(reduces), len(set(reduces)))
    res["stage_dp_same"] = (
        torch.equal(got[2].action, want[2].action)
        and torch.equal(got[4], want[4])
        and (got[0].updates, got[0].env_steps) == (want[0].updates,
                                                   want[0].env_steps)
        and _same(got[0].replay[:5], want[0].replay[:5]))
    res["stage_dp_updates"] = want[0].updates
    res["stage_dp_param_err"] = max(
        float((a - b).abs().max()) for a, b in zip(got[0].eval_p,
                                                   want[0].eval_p))
    res["stage_dp_loss_err"] = float((got[3] - want[3]).abs().max())

    # the wrapper in both mesh modes, on short routes
    short = [q[:40] for q in queues]
    for mode, kw in (("population", {}), ("dp", {"dp": True})):
        pipes = [pipeline.PipelineFlexAI(plat, cfg, lanes=4, mesh=m,
                                         device="cpu", **kw)
                 for m in (None, mesh)]
        hist = [p.train(short, episodes=1, eval_queue=short[0],
                        eval_every=1) for p in pipes]
        res[f"stage_pipe_{mode}_mesh"] = pipes[1].mesh is mesh
        res[f"stage_pipe_{mode}_steps"] = [h[0]["update_steps"]
                                           for h in hist]
        res[f"stage_pipe_{mode}_err"] = max(
            float((a - b).abs().max()) for a, b in zip(
                pipes[0].eval_params(), pipes[1].eval_params()))
        placed = [p.schedule(short[1])["placements"] for p in pipes]
        res[f"stage_pipe_{mode}_placements"] = placed[1].shape == (
            len(short[1]), 2) and (mode == "dp" or np.array_equal(*placed))
        path = os.path.join(out_dir, f"{mode}{pdist.mesh_rank(mesh)}.npz")
        pipes[1].save_weights(path)
        back = pipeline.PipelineFlexAI(plat, cfg, device="cpu")
        back.load_weights(path)
        res[f"stage_pipe_{mode}_weights"] = _same(back.eval_params(),
                                                  pipes[1].eval_params())

    # refusals: the stage axis against the plan, R against the route
    # axis, lanes against the route axis, trainers on a stage axis > 1
    refused = []
    for call in (
            lambda: pipeline.make_sharded_pipeline_fn(
                spec, pipeline.build_stage_plan(plat, 3), grids[2]),
            lambda: pipeline.make_sharded_pipeline_fn(
                spec, pipeline.build_stage_plan(plat, 1), grids[1])(
                params, type(batch)(*[f[:3] for f in batch])),
            lambda: pipeline.PipelineFlexAI(plat, cfg, lanes=3, mesh=mesh,
                                            device="cpu"),
            lambda: pipeline.PipelineFlexAI(plat, cfg, mesh=mesh,
                                            device="cpu"),
            lambda: pipeline.make_pipeline_dp_train_fn(spec, plan, cfg, 3,
                                                       mesh=mesh),
            lambda: pipeline.make_sharded_pipeline_train_fn(
                spec, plan, cfg, mesh)(population(), type(batch)(
                    *[f[:3] for f in batch])),
            lambda: pipeline.make_sharded_pipeline_train_fn(
                spec, plan, cfg, grids[2]),
            lambda: pipeline.make_pipeline_dp_train_fn(spec, plan, cfg, 2,
                                                       mesh=grids[2]),
            lambda: pipeline.PipelineFlexAI(plat, cfg, lanes=2, dp=True,
                                            mesh=grids[2], device="cpu")):
        try:
            call()
            refused.append(False)
        except ValueError:
            refused.append(True)
    try:
        make_platform_mesh(3, "cpu")
        refused.append(False)
    except RuntimeError:
        refused.append(True)
    res["stage_refusals"] = refused
    return res


def _worker(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        res = _cases(pdist.make_mesh("cpu"), out_dir)
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


@pytest.mark.parametrize("policy", ["eft", "flexai"])
@pytest.mark.parametrize("stages", [2, 1], ids=["2x1", "1x2"])
def test_stage_sharded_wavefront_equals_flat(ranks, stages, policy):
    """The stage-sharded wavefront on a (2, 1) ``("stages", "routes")``
    mesh at S = 2 and on a (1, 2) mesh at S = 1: records (``recs[s, r,
    k]`` = the flat engine's ``recs[r][k, s]``), rings and the combined
    state equal the flat engine's bit for bit (the twin of
    ``tests/test_pipeline.py::test_sharded_pipeline_matches_flattened``);
    one hop after every column but the last, none at S = 1, and no host
    copy on the CPU."""
    key = f"stage_{stages}_{policy}"
    for r in ranks:
        assert r[f"{key}_recs"] and r[f"{key}_ring"] and r[f"{key}_state"]
        cols = r[f"{key}_tasks"] + stages - 1
        assert r[f"{key}_stats"] == {
            "columns": cols, "hops": cols - 1 if stages > 1 else 0,
            "host_copies": 0}


def test_platform_meshes_number_ranks_stage_major(ranks):
    for rank, r in enumerate(ranks):
        assert r["stage_grids"] == {
            2: (("stages", "routes"), (2, 1), rank, 0),
            1: (("stages", "routes"), (1, 2), 0, rank)}


def test_sharded_stage_population_equals_batched(ranks):
    """Actions, nets, rings, losses, update masks, counters and platform
    states of the population stage trainer split over the route axis
    (through the lane Adam entry point) equal the batched trainer's."""
    for r in ranks:
        assert r["stage_population"]
        assert r["stage_population_updates"] >= 50


def test_sharded_stage_dp_matches_unsharded(ranks):
    """2 lanes a rank x 2 ranks vs 4 lanes: actions, update mask,
    counters and rings equal, parameters and losses within 1e-3; one
    gradient all-reduce an update and on no other step."""
    for r in ranks:
        assert r["stage_dp_same"] and r["stage_dp_updates"] >= 50
        assert r["stage_dp_param_err"] < 1e-3
        assert r["stage_dp_loss_err"] < 1e-3
        assert r["stage_dp_reduces"] == (r["stage_dp_updates"], 1)


@pytest.mark.parametrize("mode", ["population", "dp"])
def test_pipeline_flexai_trains_on_the_mesh(ranks, mode):
    """``PipelineFlexAI(mesh=)`` trains as without the mesh (the same
    update steps; population nets equal, DP within 1e-3), schedules
    unsharded, and its saved weights load back equal."""
    for r in ranks:
        assert r[f"stage_pipe_{mode}_mesh"]
        steps = r[f"stage_pipe_{mode}_steps"]
        assert steps[0] == steps[1] > 0
        assert r[f"stage_pipe_{mode}_err"] == 0.0 if mode == "population" \
            else r[f"stage_pipe_{mode}_err"] < 1e-3
        assert r[f"stage_pipe_{mode}_placements"]
        assert r[f"stage_pipe_{mode}_weights"]


def test_stage_mesh_refusals(ranks):
    """A stage axis that is not the plan's, routes or lanes that do not
    split over the route axis, a single lane on a mesh, the trainers on a
    stage axis > 1, and a world that does not split into stage groups."""
    assert all(all(r["stage_refusals"]) for r in ranks), \
        [r["stage_refusals"] for r in ranks]


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
