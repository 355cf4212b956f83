"""The port's GA/SA searches (``core/schedulers/metaheuristic.py``)
against the JAX package's batched path (``make_metaheuristic_fn(...,
batched=True)``).

The JAX searches draw from ``jax.random`` inside the search; the test
rebuilds the JAX key tree (``split`` per window as in ``_route_run``, per
generation / iteration as in ``_ga_window`` / ``_sa_window``) and injects
those draws into the port.  Fitness is held at rtol 1e-6: the energy term
is a sum over the window whose order XLA chooses.  Placements must be
equal, except that at a first difference (a window where the two
searches picked other assignments, after which the routes part) JAX's
fitness margin between the two candidates, from JAX's state at that
window, is below 1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import faults as faults_jax
from repro.core import hmai as hmai_jax
from repro.core import platform_jax as pj
from repro.core.schedulers import metaheuristic_jax as mh_jax
from repro.core.tasks import pad_task_arrays as pad_jax
from repro.core.tasks import tasks_to_arrays as arrays_jax
from repro.core.tasks import window_task_arrays as window_jax
from repro_torch.core import environment as env_t
from repro_torch.core import faults
from repro_torch.core import hmai as hmai_t
from repro_torch.core import platform as pt
from repro_torch.core.schedulers import (GAConfig, SAConfig, get_scheduler,
                                         make_metaheuristic_fn,
                                         metaheuristic_schedule,
                                         window_fitness)
from repro_torch.core.schedulers import metaheuristic as mh
from repro_torch.core.tasks import (TaskArrays, stack_task_arrays,
                                    tasks_to_arrays, window_task_arrays)
from test_torch_pipeline import one_torch_thread  # noqa: F401

RATE = 0.012
SMALL = dict(route_km=0.01, rate_scale=RATE, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0)
N = 11
MARGIN = 1e-5
CONFIGS = {
    "ga": GAConfig(window=8, population=6, generations=3),
    "sa": SAConfig(window=8, iters=12, chains=4),
    "sa-tempering": SAConfig(window=8, iters=12, chains=4, tempering=True,
                             exchange_every=3),
}


def _queue_pair(seed):
    return (env_jax.build_task_queue(
                env_jax.EnvironmentParams(seed=seed, **SMALL)),
            env_t.build_task_queue(env_t.EnvironmentParams(seed=seed,
                                                           **SMALL)))


def _specs():
    return (pj.spec_from_platform(hmai_jax.HMAIPlatform(capacity_scale=RATE)),
            pt.spec_from_platform(hmai_t.HMAIPlatform(capacity_scale=RATE)))


def _trace(t, seed):
    return faults.build_health_trace(
        t, N, faults.random_fault_events(seed, t, N, n_faults=3))


# ---------------------------------------------------------------------------
# the JAX key tree's draws, regenerated outside the search
# ---------------------------------------------------------------------------

def _ga_draws_jax(cfg, key, nw, n):
    w, pop = cfg.window, cfg.population
    n_elite, n_child = pop // 2, pop - pop // 2

    def gen(key, _):
        key, k_par, k_cx, k_mut, k_val = jax.random.split(key, 5)
        return key, (
            jax.random.randint(k_par, (n_child, 2), 0, n_elite),
            jax.random.randint(k_cx, (n_child, 1), 1, max(w, 2))[:, 0],
            jax.random.uniform(k_mut, (n_child, w)),
            jax.random.randint(k_val, (n_child, w), 0, n, jnp.int32))

    def win(key, _):
        key, k_w = jax.random.split(key)
        k_init, k_loop = jax.random.split(k_w)
        init = jax.random.randint(k_init, (pop, w), 0, n, jnp.int32)
        _, per = jax.lax.scan(gen, k_loop, None, length=cfg.generations)
        return key, (init, *per)

    return jax.lax.scan(win, key, None, length=nw)[1]


def _sa_draws_jax(cfg, key, nw, n):
    w, c = cfg.window, cfg.chains

    def it(key, _):
        key, k_pos, k_val, k_acc = jax.random.split(key, 4)
        out = (jax.random.randint(k_pos, (c,), 0, w),
               jax.random.randint(k_val, (c,), 0, n, jnp.int32),
               jax.random.uniform(k_acc, (c,)))
        if cfg.tempering:
            key, k_ex = jax.random.split(key)
            out += (jax.random.uniform(k_ex, (c,)),)
        return key, out

    def win(key, _):
        key, k_w = jax.random.split(key)
        k_init, k_loop = jax.random.split(k_w)
        init = jax.random.randint(k_init, (c, w), 0, n, jnp.int32)
        _, per = jax.lax.scan(it, k_loop, None, length=cfg.iters)
        return key, (init, *per)

    return jax.lax.scan(win, key, None, length=nw)[1]


def _draws(name, cfg, keys, nw):
    """The port's draws ([R, NW, ...]) for JAX route keys [R]."""
    fn = _ga_draws_jax if name == "ga" else _sa_draws_jax
    out = jax.jit(jax.vmap(functools.partial(fn, cfg, nw=nw, n=N)))(keys)
    cls = mh.GADraws if name == "ga" else mh.SADraws
    return cls(*[torch.from_numpy(np.array(x)) for x in out])


# ---------------------------------------------------------------------------
# fitness
# ---------------------------------------------------------------------------

def _mid_route_state(spec_j, qj, k, health_row):
    final, _ = faults_jax.replay_actions(
        spec_j, arrays_jax(qj[:k]),
        jnp.asarray(np.arange(k) % N, jnp.int32))
    return pj.with_health(final, jnp.asarray(health_row))


def _to_torch_state(state_j):
    return pt.PlatformState(*[torch.from_numpy(np.array(f))[None]
                              for f in state_j])


@pytest.mark.parametrize("w", [1, 8, 30])
def test_window_fitness_matches_jax(w):
    """A mid-route state under a health row with a dead and a throttled
    core, a window with padding rows, 16 candidate assignments."""
    qj, qt = _queue_pair(4)
    spec_j, spec_t = _specs()
    row = np.ones(N, np.float32)
    row[2], row[5] = 0.0, 0.5
    state_j = _mid_route_state(spec_j, qj, 40, row)
    wt_j = window_jax(arrays_jax(qj[40:40 + w - w // 3]), w)
    wt_j = type(wt_j)(*[f[0] for f in wt_j])
    wt_t = window_task_arrays(tasks_to_arrays(qt[40:40 + w - w // 3]), w)
    wt_t = TaskArrays(*[f[None, 0] for f in wt_t])
    assert bool(np.asarray(wt_j.valid).all()) == (w == 1)
    cand = np.random.default_rng(w).integers(0, N, (16, w))
    want = jax.vmap(lambda a: mh_jax.window_fitness(
        spec_j, state_j, wt_j, a))(jnp.asarray(cand, jnp.int32))
    got = window_fitness(spec_t, _to_torch_state(state_j), wt_t,
                         torch.from_numpy(cand)[None])
    assert got.shape == (1, 16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-6)
    # padding rows add nothing: their genes do not move the fitness
    if w > 1:
        moved = cand.copy()
        moved[:, ~np.asarray(wt_j.valid)] = 0
        assert torch.equal(
            window_fitness(spec_t, _to_torch_state(state_j), wt_t,
                           torch.from_numpy(moved)[None]), got)


def test_maxplus_reduce_matches_jax():
    rng = np.random.default_rng(0)
    for w in (1, 2, 5, 8, 30):
        c = rng.random((w, N), np.float32)
        d = np.where(rng.random((w, N)) < 0.5, -np.inf,
                     rng.random((w, N))).astype(np.float32)
        got = mh._maxplus_reduce(torch.from_numpy(c), torch.from_numpy(d))
        want = mh_jax._maxplus_reduce(jnp.asarray(c), jnp.asarray(d))
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))


# ---------------------------------------------------------------------------
# searches: the port with injected draws against the JAX batched path
# ---------------------------------------------------------------------------

def _assert_placements_within_margin(name, cfg, spec_j, ta_j, got, want,
                                     health):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)[0]
    if len(diff) == 0:
        return
    w = cfg.window
    wi = int(diff[0]) // w
    whealth = np.repeat(np.asarray(faults_jax.window_health(health, w)), w,
                        axis=0)
    padded = pad_jax(ta_j, len(whealth))
    prefix = type(ta_j)(*[jnp.asarray(f)[:wi * w] for f in padded])
    state = pj.platform_init(spec_j.n) if wi == 0 else \
        faults_jax.replay_actions(spec_j, prefix,
                                  jnp.asarray(want[:wi * w], jnp.int32),
                                  jnp.asarray(whealth[:wi * w]))[0]
    state = pj.with_health(state, jnp.asarray(whealth[wi * w]))
    wt = type(ta_j)(*[jnp.asarray(f)[wi * w:(wi + 1) * w] for f in padded])
    fit = [float(mh_jax.window_fitness(spec_j, state, wt, jnp.asarray(
        a[wi * w:(wi + 1) * w], jnp.int32))) for a in (want, got)]
    margin = (fit[0] - fit[1]) / abs(fit[0])
    assert margin < MARGIN, (
        f"{name}: window {wi} differs with a JAX fitness margin of "
        f"{margin} ({fit})")


@pytest.mark.parametrize("faulty", [False, True], ids=["healthy", "trace"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_search_matches_jax_batched_with_injected_draws(name, faulty):
    cfg = CONFIGS[name]
    search = name.split("-")[0]
    spec_j, spec_t = _specs()
    pairs = [_queue_pair(s) for s in (15, 16)]
    t_max = max(len(qt) for _, qt in pairs)
    nw = -(-t_max // cfg.window)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    batch_j = type(arrays_jax(pairs[0][0]))(*[
        jnp.stack(f) for f in zip(*[pad_jax(arrays_jax(qj), t_max)
                                    for qj, _ in pairs])])
    traces = (np.stack([_trace(t_max, s) for s in (5, 6)]) if faulty
              else np.ones((2, t_max, N), np.float32))
    fn_j = mh_jax.make_metaheuristic_fn(spec_j, search, cfg, batched=True)
    _, recs_j = fn_j(keys, batch_j, jnp.asarray(traces) if faulty else None)
    draws = _draws(search, cfg, keys, nw)
    batch_t = stack_task_arrays([tasks_to_arrays(qt) for _, qt in pairs])
    finals, recs_t = make_metaheuristic_fn(spec_t, search, cfg,
                                           batched=True)(
        0, batch_t, health=traces if faulty else None, draws=draws)
    assert recs_t.action.shape == np.asarray(recs_j.action).shape
    for r, (qj, qt) in enumerate(pairs):
        _assert_placements_within_margin(
            name, cfg, spec_j, pad_jax(arrays_jax(qj), t_max),
            recs_t.action[r].numpy(), np.asarray(recs_j.action[r]),
            traces[r])
        # the single-route entry point equals its route of the batch
        final_s, recs_s = make_metaheuristic_fn(spec_t, search, cfg)(
            0, tasks_to_arrays(qt), health=traces[r, :len(qt)] if faulty
            else None, draws=type(draws)(*[None if d is None else d[r]
                                           for d in draws]))
        n_valid = len(qt)
        assert torch.equal(recs_s.action[:n_valid],
                           recs_t.action[r, :n_valid])
        assert torch.equal(final_s.E, pt.route(finals, r).E)


def test_search_avoids_dead_cores_and_default_draws_are_seeded():
    """Under a trace with a core dead all route long, fitness alone drives
    the winning genes off it; the default draws come from the seed."""
    _, qt = _queue_pair(17)
    _, spec_t = _specs()
    h = np.ones((len(qt), N), np.float32)
    h[:, 0] = 0.0
    for name, cfg in (("ga", CONFIGS["ga"]), ("sa", CONFIGS["sa"])):
        fn = make_metaheuristic_fn(spec_t, name, cfg)
        runs = [fn(seed, tasks_to_arrays(qt), health=h) for seed in (1, 1, 2)]
        acts = [r[1].action[r[1].valid] for r in runs]
        assert torch.equal(acts[0], acts[1])
        assert not torch.equal(acts[0], acts[2])
        assert (acts[0] != 0).all(), name


def test_device_scheduler_surface():
    _, qt = _queue_pair(18)
    plat = hmai_t.HMAIPlatform(capacity_scale=RATE)
    s = get_scheduler("sa_scan", cfg=CONFIGS["sa"], seed=4,
                      device="cpu").schedule(plat, qt)
    m = metaheuristic_schedule("sa", plat, qt, cfg=CONFIGS["sa"], seed=4,
                               device="cpu")
    assert s["tasks"] == len(qt) == len(s["placements"])
    np.testing.assert_array_equal(s["placements"], m["placements"])
    assert plat.records == []          # the NumPy platform is untouched
    g = get_scheduler("ga_scan", cfg=CONFIGS["ga"], device="cpu") \
        .schedule(plat, qt)
    assert 0.0 <= g["stm_rate"] <= 1.0 and g["schedule_time_s"] > 0


def test_margin_rule_accepts_ties_and_flags_real_differences():
    """The placement rule: a window relabeled between two identical
    accelerators (equal tables, both idle) ties in JAX fitness and
    passes; piling the window onto one core does not."""
    qj, _ = _queue_pair(19)
    spec_j, _ = _specs()
    cfg = CONFIGS["ga"]
    ta_j = arrays_jax(qj)
    health = np.ones((len(qj), N), np.float32)
    want = np.random.default_rng(0).integers(0, N, len(qj))
    want[:4] = 0                          # cores 0-3 are alike (SconvOD)
    tie = want.copy()
    tie[:cfg.window] = np.where(want[:cfg.window] == 0, 1,
                                np.where(want[:cfg.window] == 1, 0,
                                         want[:cfg.window]))
    _assert_placements_within_margin("ga", cfg, spec_j, ta_j, tie, want,
                                     health)
    piled = want.copy()
    piled[:cfg.window] = 0
    with pytest.raises(AssertionError, match="fitness margin"):
        _assert_placements_within_margin("ga", cfg, spec_j, ta_j, piled,
                                         want, health)
