"""The port's scenario fleets (``core/scenarios.py``) against the JAX
package's ``scenario_batch``.

The JAX families draw with ``jax.random`` (``fold_in`` per family,
``split`` per scenario); the test regenerates those draws outside the
transforms and injects them.  The transforms are then exact: every task
field and every health trace equals the JAX fleet's bit for bit, and the
lane batches take the same rows.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import scenarios as scen_jax
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro_torch.core import environment as env_t
from repro_torch.core import scenarios
from repro_torch.core.tasks import tasks_to_arrays

SMALL = dict(route_km=0.01, rate_scale=0.012, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)
N = 11


def _base(seed=21):
    return (arrays_jax(env_jax.build_task_queue(
                env_jax.EnvironmentParams(seed=seed, **SMALL))),
            tasks_to_arrays(env_t.build_task_queue(
                env_t.EnvironmentParams(seed=seed, **SMALL))))


def _jax_draws(seed, families, p, t, n_cores):
    """Each family's draws as ``scenario_batch`` makes them: fold_in the
    family's index, split one key per scenario."""
    f = min(2, max(n_cores - 1, 0))

    def family(name, k):
        if name == "sensor_dropout":
            return {"keep": jax.random.bernoulli(k, 0.6, (6,))}
        if name == "weather":
            return {"rate": jax.random.uniform(k, (), minval=0.6,
                                               maxval=1.6)}
        if name == "burst":
            k_c, = jax.random.split(k, 1)
            return {"burst_u": jax.random.uniform(k_c, ())}
        if name == "fault":
            k_core, k_at, k_back, k_fail, k_deg = jax.random.split(k, 5)
            return {
                "perm": jax.random.permutation(k_core, n_cores),
                "at": jax.random.randint(k_at, (f,), 1, max(2 * t // 3, 2)),
                "back": jax.random.randint(k_back, (f,), max(t // 6, 1),
                                           max(t, 2)),
                "fail": jax.random.bernoulli(k_fail, 0.5, (f,)),
                "degrade": jax.random.uniform(k_deg, (f,), minval=0.25,
                                              maxval=0.75)}
        return {}

    key = jax.random.PRNGKey(seed)
    out = {}
    for fi, name in enumerate(families):
        keys = jax.random.split(jax.random.fold_in(key, fi), p)
        drawn = jax.vmap(lambda k, name=name: family(name, k))(keys)
        out[name] = scenarios.ScenarioDraws(**{
            k: torch.from_numpy(np.array(v)) for k, v in drawn.items()})
    return out


@pytest.mark.parametrize("families", [
    scenarios.FAMILIES, ("fault", "burst"), ("sensor_dropout",),
    ("weather", "clean")], ids="+".join)
def test_scenario_batch_matches_jax_with_injected_draws(families):
    base_j, base_t = _base()
    t = base_t.num_tasks
    p, seed = 5, 13
    want = scen_jax.scenario_batch(base_j, N, seed, n_per_family=p,
                                   families=families)
    draws = _jax_draws(seed, families, p, t, N)
    got = scenarios.scenario_batch(base_t, N, seed, n_per_family=p,
                                   families=families, draws=draws)
    assert got.num_scenarios == want.num_scenarios == p * len(families)
    np.testing.assert_array_equal(got.family, want.family)
    for f in want.tasks._fields:
        np.testing.assert_array_equal(
            getattr(got.tasks, f).numpy(),
            np.asarray(getattr(want.tasks, f)).astype(
                getattr(got.tasks, f).numpy().dtype), err_msg=f)
    np.testing.assert_array_equal(got.health.numpy(),
                                  np.asarray(want.health))
    for name in families:
        np.testing.assert_array_equal(got.family_rows(name),
                                      want.family_rows(name))


@pytest.mark.parametrize("lanes", [3, 8])
def test_lane_batches_match_jax(lanes):
    base_j, base_t = _base(22)
    t = base_t.num_tasks
    want = scen_jax.scenario_batch(base_j, N, 4, n_per_family=4)
    got = scenarios.scenario_batch(base_t, N, 4, n_per_family=4,
                                   draws=_jax_draws(4, scenarios.FAMILIES,
                                                    4, t, N))
    pairs = list(zip(scenarios.scenario_lane_batches(got, lanes),
                     scen_jax.scenario_lane_batches(want, lanes)))
    assert len(pairs) == 20 // lanes
    for (tasks_t, h_t), (tasks_j, h_j) in pairs:
        assert h_t.shape == (lanes, t, N)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
        np.testing.assert_array_equal(tasks_t.arrival.numpy(),
                                      np.asarray(tasks_j.arrival))
        np.testing.assert_array_equal(tasks_t.valid.numpy(),
                                      np.asarray(tasks_j.valid))


def test_default_draws_are_seeded_and_keep_each_family_s_contract():
    _, base = _base(23)
    t = base.num_tasks
    a = scenarios.scenario_batch(base, N, 7, n_per_family=6)
    b = scenarios.scenario_batch(base, N, 7, n_per_family=6)
    c = scenarios.scenario_batch(base, N, 8, n_per_family=6)
    assert torch.equal(a.health, b.health)
    assert torch.equal(a.tasks.arrival, b.tasks.arrival)
    assert not torch.equal(a.tasks.arrival, c.tasks.arrival)
    rows = {name: a.family_rows(name) for name in scenarios.FAMILIES}
    clean = rows["clean"]
    assert torch.equal(a.tasks.arrival[clean[0]], base.arrival)
    drop = a.tasks.valid[rows["sensor_dropout"]]
    front = base.group == 0
    assert drop[:, front].all() and not drop.all()
    for name in ("weather", "burst"):
        arr = a.tasks.arrival[rows[name]]
        assert (arr[:, 1:] >= arr[:, :-1]).all(), name
        assert not torch.equal(arr[0], base.arrival)
    rate = base.arrival[-1] / a.tasks.arrival[rows["weather"], -1]
    assert ((rate >= 0.6) & (rate < 1.6)).all()
    assert (a.health[np.concatenate([rows[n] for n in scenarios.FAMILIES
                                     if n != "fault"])] == 1.0).all()
    fault = a.health[rows["fault"]]
    bad = (fault < 1.0).any(1).sum(-1)               # faulty cores per row
    assert ((bad >= 1) & (bad <= 2)).all()
    assert (fault.amin((1, 2)) >= 0.0).all() and fault.shape == (6, t, N)
    vals = fault[fault < 1.0]
    assert ((vals == 0.0) | ((vals >= 0.25) & (vals < 0.75))).all()
