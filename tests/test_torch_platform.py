"""The port's platform, queue generator and task features against the JAX
package's.

The JAX functions are called op by op (not under ``jit``, where XLA
contracts ``a * b + c`` into FMAs): then every float field of the state
and the records, and the Gvalue, agree bit for bit.  The state vector is
compared at rtol 1e-6, because ``log1p`` is not the same routine in XLA
and in PyTorch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import hmai as hmai_jax
from repro.core import platform_jax as pj
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro.models.perception.nets import perception_stats as stats_jax
from repro_torch.core import environment as env_t
from repro_torch.core import hmai as hmai_t
from repro_torch.core import platform as pt
from repro_torch.core import tasks as tasks_t
from repro_torch.models.perception.stats import perception_stats

# a ~128-task route (small params of the verify recipe, fewer cameras/s)
SMALL = dict(route_km=0.01, rate_scale=0.012, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)


def _queues(seed, **kw):
    p = dict(SMALL, seed=seed, **kw)
    return (env_jax.build_task_queue(env_jax.EnvironmentParams(**p)),
            env_t.build_task_queue(env_t.EnvironmentParams(
                **{k: (env_t.Area(v.value) if k == "area" else v)
                   for k, v in p.items()})))


def _task_tuple(t):
    return (t.uid, t.kind.value, t.camera_group, t.camera_id,
            t.arrival_time, t.safety_time)


@pytest.mark.parametrize("seed,area", [(0, "UB"), (5, "UHW"), (9, "HW")])
def test_copied_environment_builds_the_same_queue(seed, area):
    qj, qt = _queues(seed, area=env_jax.Area(area))
    assert len(qj) == len(qt) > 0
    assert [_task_tuple(t) for t in qj] == [_task_tuple(t) for t in qt]


def test_copied_perception_stats_and_features():
    assert perception_stats() == stats_jax()
    np.testing.assert_array_equal(pt.kind_feature_table(),
                                  pj.kind_feature_table())
    pj_plat, pt_plat = hmai_jax.HMAIPlatform(), hmai_t.HMAIPlatform()
    np.testing.assert_array_equal(pt_plat.exec_time_table,
                                  pj_plat.exec_time_table)
    np.testing.assert_array_equal(pt_plat.energy_table, pj_plat.energy_table)


def test_task_arrays_match_and_pad():
    qj, qt = _queues(2)
    aj, at = arrays_jax(qj), tasks_t.tasks_to_arrays(qt)
    for f in tasks_t.TaskArrays._fields:
        np.testing.assert_array_equal(getattr(at, f).numpy(),
                                      np.asarray(getattr(aj, f)))
    padded = tasks_t.pad_task_arrays(at, at.num_tasks + 5)
    assert padded.num_tasks == at.num_tasks + 5
    assert not padded.valid[-5:].any() and padded.valid[:-5].all()
    batch = tasks_t.stack_task_arrays([at, tasks_t.invalid_task_arrays(3)])
    assert tuple(batch.arrival.shape) == (2, at.num_tasks)
    wide = tasks_t.pad_route_batch(batch, 4)
    assert tuple(wide.valid.shape) == (4, at.num_tasks)
    assert not wide.valid[1:].any()
    with pytest.raises(ValueError):
        tasks_t.pad_task_arrays(at, 1)


def _jax_row(ta, i):
    return type(ta)(*[jnp.asarray(f)[i] for f in ta])


def _assert_state_equal(sj, st, where):
    for f in pj.PlatformState._fields:
        np.testing.assert_array_equal(
            getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
            err_msg=f"{where}: state.{f}")


@pytest.mark.parametrize("seed,health", [(1, False), (4, True)])
def test_platform_step_matches_jax_step_by_step(seed, health):
    """Same route, same actions: state, records, Gvalue bit for bit; state
    vector at rtol 1e-6.  With ``health`` a degraded core and a dead core
    are installed, so the health lookups are exercised too."""
    qj, qt = _queues(seed)
    aj, at = arrays_jax(qj), tasks_t.tasks_to_arrays(qt)
    plat = hmai_jax.HMAIPlatform(capacity_scale=SMALL["rate_scale"])
    spec_j = pj.spec_from_platform(plat)
    spec_t = pt.spec_from_platform(
        hmai_t.HMAIPlatform(capacity_scale=SMALL["rate_scale"]))
    feat_j = jnp.asarray(pj.kind_feature_table())
    feat_t = torch.from_numpy(pt.kind_feature_table())
    n = plat.n
    actions = np.random.default_rng(seed).integers(0, n, len(qj))
    sj, st = pj.platform_init(n), pt.platform_init(n)
    if health:
        hrow = np.ones(n, np.float32)
        hrow[2], hrow[5] = 0.5, 0.0
        sj = pj.with_health(sj, jnp.asarray(hrow))
        st = pt.with_health(st, torch.from_numpy(hrow)[None])
    recs_j, recs_t = [], []
    for i in range(len(qj)):
        tj = _jax_row(aj, i)
        tt = tasks_t.TaskArrays(*[f[i:i + 1] for f in at])
        np.testing.assert_allclose(
            pt.state_vector(spec_t, feat_t, 1.0, st, tt)[0].numpy(),
            np.asarray(pj.state_vector(spec_j, feat_j, 1.0, sj, tj)),
            rtol=1e-6, err_msg=f"step {i}: state_vector")
        sj, rj = pj.platform_step(spec_j, sj, tj, jnp.int32(actions[i]))
        st, rt = pt.platform_step(spec_t, st, tt,
                                  torch.tensor([actions[i]]))
        _assert_state_equal(sj, pt.route(st, 0), f"step {i}")
        for f in pj.StepRecord._fields:
            np.testing.assert_array_equal(
                getattr(rt, f)[0].numpy(), np.asarray(getattr(rj, f)),
                err_msg=f"step {i}: record.{f}")
        assert pt.gvalue_state(spec_t, st)[0].numpy() == \
            np.asarray(pj.gvalue_state(spec_j, sj)), f"step {i}: gvalue"
        recs_j.append(rj)
        recs_t.append(rt)
    stacked_j = pj.StepRecord(*[jnp.stack(f) for f in zip(*recs_j)])
    stacked_t = pt.route(pt.stack_records(recs_t), 0)
    assert pt.summarize(spec_t, pt.route(st, 0), stacked_t) == \
        pj.summarize(spec_j, sj, stacked_j)


def test_padding_rows_pass_the_state_through():
    qj, qt = _queues(3)
    at = tasks_t.stack_task_arrays([tasks_t.tasks_to_arrays(qt),
                                    tasks_t.invalid_task_arrays(4)])
    spec = pt.spec_from_platform(hmai_t.HMAIPlatform())
    s0 = pt.platform_init(spec.n, 2)
    s1, rec = pt.platform_step(spec, s0, at.step(0), torch.tensor([3, 3]))
    assert bool(rec.valid[0]) and not bool(rec.valid[1])
    for f0, f1 in zip(pt.route(s0, 1), pt.route(s1, 1)):
        assert torch.equal(f0, f1)
    assert int(s1.num_tasks[0, 3]) == 1


def test_environment_params_are_the_same_dataclass_shape():
    fj = [f.name for f in dataclasses.fields(env_jax.EnvironmentParams)]
    ft = [f.name for f in dataclasses.fields(env_t.EnvironmentParams)]
    assert fj == ft
