"""The port's stage pipeline (``repro_torch.core.pipeline``) against the
JAX package's ``core/pipeline.py``: the stage plan, the stage
observation, the wavefront and task-major engines, the greedy policies
and ``combine_stage_states`` (the stage-sharded engine itself runs in
``tests/test_torch_sharded_engine.py``'s gloo job).  Routes are
``tests/test_pipeline.py``'s short ones (route_km 0.02 at rate 0.05).

Tolerances: the layer windows, share tables and every array of
``build_stage_plan`` exactly equal; ``stage_state_vector`` at rtol 1e-6
(``log1p`` differs between XLA and PyTorch).  The port's flat engine
equals its task-major reference bit for bit, and a padded route batch and
a segment resumed from its ``(state, ring)`` checkpoint equal the plain
run bit for bit.  Against the jitted JAX engines EFT's records and rings
are exactly equal and so is the final state but ``R_Balance`` (rtol 1e-6:
XLA contracts its ``a * b + c`` into an FMA); FlexAI's placements are
equal, or at a first difference the JAX Q margin is below 1e-5 (the
Q-net's rounding tie of ``tests/test_torch_engine.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import environment as env_jax
from repro.core import hmai as hmai_jax
from repro.core import pipeline as pipe_jax
from repro.core import platform_jax as pj
from repro.core import tasks as tasks_jax
from repro.core.faults import build_health_trace, random_fault_events
from repro.core.flexai import dqn as dqn_jax
from repro_torch.core import environment as env_t
from repro_torch.core import hmai as hmai_t
from repro_torch.core import pipeline as pipe_t
from repro_torch.core import tasks as tasks_t
from repro_torch.core.flexai import dqn as dqn_t
from repro_torch.core.flexai.engine import make_schedule_fn
from repro_torch.core.platform import (kind_feature_table, platform_init,
                                       platform_step, spec_from_platform,
                                       stage_state_vector)

RS = 0.05
MARGIN = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for a module's tests (the step loops' tensors
    are far below any op's parallel grain).  Under tier-1's six workers,
    a process's idle OpenMP threads spin on cores the other workers
    need: six concurrent runs of ``test_torch_pipeline_train.py`` take
    1,059 s with the default thread count and 65 s with one.  The
    trainers' test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
PLAT_J = hmai_jax.HMAIPlatform(capacity_scale=RS)
PLAT_T = hmai_t.HMAIPlatform(capacity_scale=RS)
SPEC_J = pj.spec_from_platform(PLAT_J)
SPEC_T = spec_from_platform(PLAT_T)
N = PLAT_T.n
D = pipe_t.stage_state_dim(N)


def queue_pair(seed, km=0.02):
    """``tests/test_pipeline.py``'s route ``seed`` in both packages."""
    kw = dict(route_km=km, rate_scale=RS, seed=seed, max_times_turn=2,
              max_times_reverse=1, max_duration_turn=4.0,
              max_duration_reverse=6.0)
    return (env_jax.build_task_queue(env_jax.EnvironmentParams(**kw)),
            env_t.build_task_queue(env_t.EnvironmentParams(**kw)))


def arrays_pair(seed, km=0.02):
    qj, qt = queue_pair(seed, km)
    return tasks_jax.tasks_to_arrays(qj), tasks_t.tasks_to_arrays(qt)


def stage_weights(seed=4):
    """A stage Q-net (70 -> 256 -> 64 -> 11) in both packages."""
    p = dqn_jax.init_qnet(jax.random.PRNGKey(seed), D, N)
    return p, dqn_t.params_from_numpy(p)


def assert_state_equal(got, want):
    """A port state against a JAX one: exact but R_Balance (rtol 1e-6)."""
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "R_Balance":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def assert_records_equal(got, want, fields=None):
    for name, g, w in zip(got._fields, got, want):
        if fields is None or name in fields:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def jax_q_margin(plan_j, params_j, ta_j, want, got, health=None):
    """JAX's Q margin between its stage placement ``want`` and the port's
    ``got`` ([T, S]) at their first difference in flat order."""
    S = plan_j.stage_exec.shape[0]
    rows, s_seq = pipe_jax._wavefront_stream(ta_j, S)
    order = np.asarray(pipe_jax._record_order(ta_j.arrival.shape[0], S))
    flat_w = np.empty(order.size, int)
    flat_g = np.empty(order.size, int)
    flat_w[order.reshape(-1)] = want.reshape(-1)
    flat_g[order.reshape(-1)] = got.reshape(-1)
    valid = np.asarray(rows.valid)
    i = int(np.nonzero((flat_w != flat_g) & valid[:flat_w.size])[0][0])
    run = pipe_jax._pipeline_segment_run(SPEC_J, plan_j)
    hflat = None
    if health is not None:
        t = ta_j.arrival.shape[0]
        k_seq = np.repeat(np.arange(t + S - 1), S) - np.tile(
            np.arange(S - 1, -1, -1), t + S - 1)
        hflat = jnp.asarray(health)[np.clip(k_seq, 0, t - 1)]
    cut = jax.tree_util.tree_map(lambda a: a[:i], rows)
    state, ring, _ = run(params_j, cut, s_seq[:i], health=None
                         if hflat is None else hflat[:i])
    row = jax.tree_util.tree_map(lambda a: a[i], rows)
    s = s_seq[i]
    if hflat is not None:
        state = pj.with_health(state, hflat[i])
    trow = pipe_jax._stage_task_view(plan_j, ring, row, s)
    sv = pj.stage_state_vector(
        SPEC_J, jnp.asarray(pj.kind_feature_table()), 1.0, state, trow,
        stage_exec=plan_j.stage_exec[s], mac_frac=plan_j.mac_frac[s, row.kind],
        group_mask=plan_j.group_mask[s], stage_frac=jnp.float32(s))
    q = np.asarray(dqn_jax.qnet_apply(params_j, sv))
    return float(q[flat_w[i]] - q[flat_g[i]])


def assert_same_placements(plan_j, params_j, ta_j, got, want, health=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not np.array_equal(got, want):
        margin = jax_q_margin(plan_j, params_j, ta_j, want, got, health)
        assert margin < MARGIN, f"JAX Q margin {margin} at a difference"


# ---------------------------------------------------------------------------
# the stage plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [1, 2, 3])
def test_stage_plan_matches_jax(stages):
    """Layer windows, MAC fractions, activation bytes, share tables and
    every array of the plan: exactly equal."""
    for got, want in zip(tasks_t.stage_layer_stats(stages),
                         tasks_jax.stage_layer_stats(stages)):
        np.testing.assert_array_equal(got, want)
    names = tuple(s.name for s in PLAT_T.specs)
    np.testing.assert_array_equal(
        pipe_t.stage_share_table(names, stages),
        pipe_jax.stage_share_table(names, stages))
    got, want = (pipe_t.build_stage_plan(PLAT_T, stages),
                 pipe_jax.build_stage_plan(PLAT_J, stages))
    for name, g, w in zip(got._fields, got, want):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got.n_stages == stages and got.n == N
    graph_t = tasks_t.route_to_stage_graph(queue_pair(31)[1], stages)
    graph_j = tasks_jax.route_to_stage_graph(queue_pair(31)[0], stages)
    for f in ("layer_splits", "mac_frac", "act_bytes", "edges_src",
              "edges_dst"):
        np.testing.assert_array_equal(getattr(graph_t, f),
                                      getattr(graph_j, f))
    np.testing.assert_array_equal(graph_t.tasks.arrival.numpy(),
                                  graph_j.tasks.arrival)


def test_stage_plan_groups_override_and_refusals():
    groups = np.arange(N) % 2
    got = pipe_t.build_stage_plan(PLAT_T, 2, groups=groups)
    want = pipe_jax.build_stage_plan(PLAT_J, 2, groups=groups)
    np.testing.assert_array_equal(got.group_mask.numpy(),
                                  np.asarray(want.group_mask))
    for bad, match in ((np.zeros(N), "every stage"),
                       (np.zeros(N - 1), r"groups must be \[")):
        for build, plat in ((pipe_t.build_stage_plan, PLAT_T),
                            (pipe_jax.build_stage_plan, PLAT_J)):
            with pytest.raises(ValueError, match=match):
                build(plat, 2, groups=bad)
    with pytest.raises(ValueError, match="n_stages"):
        pipe_t.build_stage_plan(PLAT_T, 0)
    with pytest.raises(ValueError, match="stage groups"):
        pipe_t.assign_stage_groups(("a", "b"), np.ones((3, 2, 3)),
                                   np.ones(3))


def test_stage_state_vector_matches_jax():
    """A batch of mid-route states (a few EFT steps in), each stage and
    both stage_frac conventions: rtol 1e-6."""
    ta_j, ta_t = arrays_pair(36)
    plan_j = pipe_jax.build_stage_plan(PLAT_J, 3)
    plan_t = pipe_t.build_stage_plan(PLAT_T, 3)
    feat_j = jnp.asarray(pj.kind_feature_table())
    feat_t = torch.as_tensor(kind_feature_table())
    state = platform_init(N, 1)
    rng = np.random.default_rng(0)
    for t in range(40):
        state, _ = platform_step(SPEC_T, state, tasks_t.TaskArrays(
            *[f[t:t + 1] for f in ta_t]), torch.tensor([rng.integers(N)]))
    health = torch.ones(1, N)
    health[0, 3] = 0.0
    health[0, 5] = 0.5
    state = state._replace(alive=health > 0, cap=torch.where(
        health > 0, health, 1.0))
    state_j = pj.PlatformState(*[jnp.asarray(f[0].numpy()) for f in state])
    for s in range(3):
        for k in (40, 41, 42):
            row_t = tasks_t.TaskArrays(*[f[k:k + 1] for f in ta_t])
            row_j = jax.tree_util.tree_map(lambda a, k=k: a[k], ta_j)
            for frac in (float(s), float(np.float32(s) / np.float32(3))):
                got = stage_state_vector(
                    SPEC_T, feat_t, 1.0, state, row_t,
                    stage_exec=plan_t.stage_exec[s],
                    mac_frac=plan_t.mac_frac[s][row_t.kind],
                    group_mask=plan_t.group_mask[s],
                    stage_frac=torch.tensor(frac))
                want = pj.stage_state_vector(
                    SPEC_J, feat_j, 1.0, state_j, row_j,
                    stage_exec=plan_j.stage_exec[s],
                    mac_frac=plan_j.mac_frac[s, row_j.kind],
                    group_mask=plan_j.group_mask[s],
                    stage_frac=jnp.float32(frac))
                assert got.shape == (1, D)
                np.testing.assert_allclose(got[0].numpy(),
                                           np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _health_pair(ta_t, seed=5):
    t = ta_t.num_tasks
    return build_health_trace(t, N, random_fault_events(seed, t, N,
                                                        n_faults=2))


@pytest.mark.parametrize("policy", ["eft", "flexai"])
@pytest.mark.parametrize("with_health", [False, True],
                         ids=["clean", "fault-trace"])
def test_flat_equals_reference_and_jax(policy, with_health):
    """The port's wavefront equals its task-major reference bit for bit,
    and both equal the JAX package's (twin of
    ``tests/test_pipeline.py::test_flattened_matches_reference`` and
    ``tests/test_faults.py::test_pipeline_two_stage_parity_under_trace``)."""
    ta_j, ta_t = arrays_pair(11 if with_health else 31,
                             0.03 if with_health else 0.02)
    health = _health_pair(ta_t) if with_health else None
    plan_j = pipe_jax.build_stage_plan(PLAT_J, 2)
    plan_t = pipe_t.build_stage_plan(PLAT_T, 2)
    params_j, params_t = stage_weights(4) if policy == "flexai" else (
        None, None)
    flat = pipe_t.make_pipeline_schedule_fn(SPEC_T, plan_t, policy=policy)
    ref = pipe_t.make_pipeline_reference_fn(SPEC_T, plan_t, policy=policy)
    f1, ring1, r1 = flat(params_t, ta_t, health=health)
    f2, ring2, r2 = ref(params_t, ta_t, health=health)
    for a, b in zip((*f1, ring1, *r1), (*f2, ring2, *r2)):
        assert torch.equal(a, b)
    assert r1.action.shape == (ta_t.num_tasks, 2)

    fj, ringj, rj = pipe_jax.make_pipeline_schedule_fn(
        SPEC_J, plan_j, policy=policy)(params_j, ta_j, health=None
                                       if health is None
                                       else jnp.asarray(health))
    if policy == "flexai" and not np.array_equal(r1.action.numpy(),
                                                 np.asarray(rj.action)):
        assert_same_placements(plan_j, params_j, ta_j, r1.action.numpy(),
                               np.asarray(rj.action), health)
        return
    assert_records_equal(r1, rj)
    np.testing.assert_array_equal(ring1.numpy(), np.asarray(ringj))
    assert_state_equal(f1, fj)


def test_combine_stage_states_matches_jax():
    """``combine_stage_states`` on per-stage states [S, R, ...] (each a
    flat EFT run of its own route batch, as a stage shard's state is a
    run of its own group) equals the JAX function on the same arrays,
    bit for bit: rows picked by group, the scales recomputed."""
    plan_j = pipe_jax.build_stage_plan(PLAT_J, 2)
    plan_t = pipe_t.build_stage_plan(PLAT_T, 2)
    run = pipe_t.make_pipeline_schedule_fn(SPEC_T, plan_t, policy="eft",
                                           batched=True)
    finals = []
    for seeds in ((33, 34), (35, 36)):
        routes = [arrays_pair(s)[1] for s in seeds]
        finals.append(run(None, tasks_t.stack_task_arrays(routes))[0])
    states = type(finals[0])(*[torch.stack(f) for f in zip(*finals)])
    got = pipe_t.combine_stage_states(plan_t, states)
    want = pipe_jax.combine_stage_states(
        plan_j, pj.PlatformState(*[jnp.asarray(f.numpy()) for f in states]))
    assert got.avail.shape == (2, N)
    for name, g, w in zip(got._fields, got, want):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    groups = plan_t.groups.numpy()
    for i in range(N):
        assert torch.equal(got.E[:, i], states.E[groups[i], :, i])


def test_one_stage_task_policy_is_the_scan_engine():
    """A 1-stage plan with the task-level policy is the greedy scheduler:
    the same final state and, squeezed, the same records."""
    _, ta_t = arrays_pair(32)
    plan = pipe_t.build_stage_plan(PLAT_T, 1)
    params = dqn_t.params_from_numpy(
        dqn_jax.init_qnet(jax.random.PRNGKey(2), 3 + 5 * N, N))
    f_p, _, r_p = pipe_t.make_pipeline_schedule_fn(
        SPEC_T, plan, policy="task")(params, ta_t)
    f_s, r_s = make_schedule_fn(SPEC_T)(params, ta_t)
    for a, b in zip(f_p, f_s):
        assert torch.equal(a, b)
    for a, b in zip(r_p, r_s):
        assert torch.equal(a[:, 0], b)


def test_padded_route_batch_is_inert():
    """A route batch padded to a lane multiple: every real lane equals
    its route run alone (padded to the batch length), and the padding
    lane records nothing."""
    plan = pipe_t.build_stage_plan(PLAT_T, 2)
    routes = [arrays_pair(s)[1] for s in (33, 34, 35)]
    batch = tasks_t.pad_route_batch(tasks_t.stack_task_arrays(routes), 4)
    assert batch.arrival.shape[0] == 4
    fb, rb_ring, rb = pipe_t.make_pipeline_schedule_fn(
        SPEC_T, plan, policy="eft", batched=True)(None, batch)
    solo = pipe_t.make_pipeline_schedule_fn(SPEC_T, plan, policy="eft")
    t_len = batch.arrival.shape[1]
    for lane, r in enumerate(routes):
        fl, ring, rl = solo(None, tasks_t.pad_task_arrays(r, t_len))
        for a, b in zip((*fb, rb_ring, *rb), (*fl, ring, *rl)):
            assert torch.equal(a[lane], b)
    assert not rb.valid[3].any()


def test_segment_resume_bit_exact():
    """The flat stream cut at a segment boundary and resumed from the
    ``(state, ring)`` checkpoint equals the single pass: the QoS
    preemption contract."""
    plan = pipe_t.build_stage_plan(PLAT_T, 2)
    _, params = stage_weights(7)
    _, ta = arrays_pair(36)
    batch = tasks_t.TaskArrays(*[f[None] for f in ta])
    rows, s_seq = pipe_t._wavefront_stream(batch, 2)
    run = pipe_t._pipeline_segment_run(SPEC_T, plan)
    f1, ring1, r1 = run(params, rows, s_seq)
    cut = 2 * (rows.arrival.shape[1] // 5)
    head = tasks_t.TaskArrays(*[f[:, :cut] for f in rows])
    tail = tasks_t.TaskArrays(*[f[:, cut:] for f in rows])
    fa, ra, rec_a = run(params, head, s_seq[:cut])
    fb, rb, rec_b = run(params, tail, s_seq[cut:], fa, ra)
    for a, b in zip((*f1, ring1), (*fb, rb)):
        assert torch.equal(a, b)
    for a, x, y in zip(r1, rec_a, rec_b):
        assert torch.equal(a, torch.cat([x, y], dim=1))


def test_summaries_and_wavefront_layout_match_jax():
    """``_wavefront_stream``, ``_record_order``, ``_next_valid_flat`` and
    ``pipeline_summarize`` against the JAX functions."""
    ta_j, ta_t = arrays_pair(38)
    for S in (1, 2, 3):
        rows_j, s_j = pipe_jax._wavefront_stream(ta_j, S)
        rows_t, s_t = pipe_t._wavefront_stream(ta_t, S)
        np.testing.assert_array_equal(s_t, np.asarray(s_j))
        for a, b in zip(rows_t, rows_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            pipe_t._record_order(ta_t.num_tasks, S),
            np.asarray(pipe_jax._record_order(ta_t.num_tasks, S)))
        valid = np.asarray(rows_j.valid)
        for v in (valid, np.stack([valid, valid[::-1]])):
            got = pipe_t._next_valid_flat(v)
            want = jax.jit(pipe_jax._next_valid_flat)(jnp.asarray(v))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
    plan_j = pipe_jax.build_stage_plan(PLAT_J, 2)
    plan_t = pipe_t.build_stage_plan(PLAT_T, 2)
    fj, _, rj = pipe_jax.make_pipeline_schedule_fn(
        SPEC_J, plan_j, policy="eft")(None, ta_j)
    ft, _, rt = pipe_t.make_pipeline_schedule_fn(
        SPEC_T, plan_t, policy="eft")(None, ta_t)
    want = pipe_jax.pipeline_summarize(SPEC_J, fj, rj)
    got = pipe_t.pipeline_summarize(SPEC_T, ft, rt)
    assert got.keys() == want.keys() and got["stages"] == 2
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
