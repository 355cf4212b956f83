"""The port's virtual-accelerator platform, loop schedulers and driving
pipeline on the CPU (mirrors ``tests/test_distribution_extras.py``'s
``test_virtual_platform_schedules``; the schedulers are held to the JAX
package's on one queue)."""
import dataclasses

import pytest

from repro.core import environment as env_jax
from repro.core import hmai as hmai_jax
from repro.core.schedulers import get_scheduler as get_scheduler_jax
from repro_torch.core import environment as env_t
from repro_torch.core import hmai as hmai_t
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.tasks import Task, TaskKind
from repro_torch.core.virtual_platform import (DEFAULT_POOLS,
                                               VirtualPlatform, _ModelBank)
from repro_torch.launch import drive

SMALL = dict(route_km=0.01, rate_scale=0.012, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0, seed=3)
TINY_POOLS = tuple(dataclasses.replace(p, batch_size=1)
                   for p in DEFAULT_POOLS)


@pytest.fixture(scope="module")
def plat():
    return VirtualPlatform(TINY_POOLS, run_real=False, device="cpu")


def test_virtual_platform_schedules(plat):
    assert plat.n == 3
    assert all(p.measured_fps and min(p.measured_fps.values()) > 0
               for p in plat.pools)
    rec = plat.execute(Task(uid=0, kind=TaskKind.YOLO, camera_group="FC",
                            camera_id=0, arrival_time=0.0, safety_time=5.0), 0)
    assert rec.exec_time > 0
    spec = plat.pools[0].as_accelerator_spec()
    assert spec.arch.name == "MconvMC"
    assert spec.fps == plat.pools[0].measured_fps


def test_each_pool_runs_its_archetype(plat, monkeypatch):
    from repro_torch.models.perception import cnn
    seen = []
    real = cnn.conv2d

    def spy(*args, dataflow, **kw):
        seen.append(dataflow)
        return real(*args, dataflow=dataflow, **kw)

    monkeypatch.setattr(cnn, "conv2d", spy)
    for pool in plat.pools:
        for kind in ("yolo", "ssd", "goturn"):
            seen.clear()
            out = pool.run(kind, pool.inputs[kind])
            assert out.shape[0] == pool.spec.batch_size
            assert seen and set(seen) == {pool.spec.archetype}, kind
        assert len(seen) == 10   # the GOTURN pair: 5 convs per tower


@pytest.mark.parametrize("name", ["worst", "random"])
def test_loop_schedulers_place_like_jax(name):
    q_jax = env_jax.build_task_queue(env_jax.EnvironmentParams(**SMALL))
    q_t = env_t.build_task_queue(env_t.EnvironmentParams(**SMALL))
    p_jax = hmai_jax.HMAIPlatform(capacity_scale=SMALL["rate_scale"])
    p_t = hmai_t.HMAIPlatform(capacity_scale=SMALL["rate_scale"])
    s_jax = get_scheduler_jax(name).schedule(p_jax, q_jax)
    s_t = get_scheduler(name).schedule(p_t, q_t)
    assert len(q_t) > 50
    assert ([r.accel_index for r in p_t.records]
            == [r.accel_index for r in p_jax.records])
    for key in ("stm_rate", "r_balance", "makespan_s", "total_energy_j",
                "gvalue"):
        assert s_t[key] == s_jax[key], key


def test_drive_pipeline_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.core import virtual_platform
    monkeypatch.setattr(virtual_platform, "DEFAULT_POOLS", TINY_POOLS)
    args = drive.parser().parse_args(
        ["--device", "cpu", "--route-km", "0.01", "--max-tasks", "24",
         "--episodes", "1"])
    res = drive.run_pipeline(args)
    out = capsys.readouterr().out
    assert "pool det-large [MconvMC]" in out and "FlexAI:" in out
    assert res["tasks"] == len(res["placements"]) == 24
    assert res["trainer"].ts.env_steps == 24
    for key in ("flexai", "worst"):
        assert res[key]["tasks"] == 24
        assert 0.0 <= res[key]["stm_rate"] <= 1.0
    assert 0 < res["rate_scale"] <= 1.0


def test_full_width_bank_runs_each_net_at_its_size():
    import torch
    from repro_torch.models.perception.nets import PERCEPTION_SPECS
    bank = _ModelBank(0, None, 2, torch.device("cpu"))
    for kind, (spec, width) in PERCEPTION_SPECS.items():
        assert bank.inputs[kind].shape == (2, spec.input_hw, spec.input_hw, 3)
        params = bank.params[kind]
        first = (params["tower"] if kind == "goturn" else params)[0]["w"]
        assert first.shape[-1] == max(4, int(spec.layers[0][1] * width))


def test_drive_pipeline_full_width_flag_picks_full_pools(capsys,
                                                         monkeypatch):
    from repro_torch.core import virtual_platform
    tiny = tuple(dataclasses.replace(p, name="full-" + p.name)
                 for p in TINY_POOLS)
    monkeypatch.setattr(virtual_platform, "FULL_WIDTH_POOLS", tiny)
    args = drive.parser().parse_args(
        ["--device", "cpu", "--route-km", "0.01", "--max-tasks", "8",
         "--episodes", "1", "--full-width"])
    res = drive.run_pipeline(args)
    out = capsys.readouterr().out
    assert "pool full-det-large [MconvMC]" in out
    assert [p.spec.name for p in res["platform"].pools] == [
        p.name for p in tiny]
    assert res["flexai"]["tasks"] == res["worst"]["tasks"] == 8
