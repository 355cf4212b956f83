"""The port's LM training (``repro_torch.train``: data, optimizer,
compression, train step, fault-tolerant runner, launcher) against the JAX
package's on the CPU.

* ``train.data``: byte-equal to the JAX copy for every arch at several
  steps, ``frontend_embeds`` included.
* ``adamw_update``, ``lr_schedule``, ``quantize_int8`` and
  ``compress_grads_int8_ef`` on the same NumPy inputs: bit-equal to the
  JAX functions called op by op, except that with clipping on the global
  norm's sum runs in another order (within 2 ulp), which the clip scale
  carries into the moments (rtol 1e-5), and that the schedule's cosine is
  each library's own (within 2 ulp).  Against ``jax.jit`` of each, XLA
  contracts and fuses: rtol 1e-5, and int8 within one quantum.
* ``make_train_step`` against ``jax.jit(make_train_step)``, from one
  ``TrainState`` carried across (``train_state_from_numpy``), on an fp32
  copy of ``tests/test_train.py``'s config, 3 steps.  The first step's
  learning rate is 0 (warmup), so its parameters stay as they were and
  its moments are the clipped gradients' (``mu = 0.1 g``): held tightly
  (rtol 1e-4, atol 1e-6 of max|mu|).  ``bf16`` and ``int8_ef`` round the
  gradients, and a value at a rounding boundary can round the other way
  in the other package: one bf16 step (2^-8 of it) or one int8 quantum
  (max|mu| / 127).  Adam then divides by sqrt(v-hat): a gradient entry
  whose rounding differs can move its parameter by up to 2 lr a step (at
  step 1, m-hat / sqrt(v-hat) = +-1 for any nonzero gradient).  So after
  3 steps parameters are held within 2 * sum(lr) everywhere and within
  1e-6 but for at most 1 % of entries (the uncompressed step within
  rtol 1e-5 / atol 1e-6 everywhere).
* LM checkpoints restore across the packages by leaf name, both ways.
* The ports of ``tests/test_train.py``'s training cases, on the port
  alone with its own weights, at the JAX file's gates.
* The launcher: ``--arch ... --smoke --device cpu``, the JAX launcher's
  output lines, and a restart from ``--ckpt-dir``.
"""
import contextlib
import dataclasses
import io
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import train as jax_launch
from repro.models import layers as jax_layers
from repro.models.api import model_api as jax_model_api
from repro.models.config import ModelConfig as JaxModelConfig
from repro.sharding import unbox
from repro.train import checkpoint as jax_ckpt
from repro.train import compression as JC
from repro.train import data as jax_data
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import train as launch
from repro_torch.models import layers as L
from repro_torch.models.api import model_api
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as C
from repro_torch.train import data
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import _flatten_with_names
from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                               elastic_restore,
                                               run_with_fault_tolerance)
from repro_torch.train.loop import (TrainHyper, init_train_state,
                                    make_train_step, train_state_from_numpy)
from test_torch_pipeline import one_torch_thread  # noqa: F401

# tests/test_train.py's config and hyperparameters
CFG = dict(name="train-tiny", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
           attention_impl="naive")
HYPER = dict(peak_lr=3e-3, warmup_steps=5, total_steps=200)
DATA = dict(batch_size=4, seq_len=32, seed=1)


def _leaves(tree):
    """Leaves as NumPy in the JAX package's order, from either package."""
    out = []
    for x in _flatten_with_names(tree)[1]:
        if isinstance(x, torch.Tensor):
            x = x.detach().view(torch.int16) if x.dtype == torch.bfloat16 \
                else x.detach()
            out.append(x.numpy())
        else:
            x = np.asarray(x)
            out.append(x.view(np.int16) if x.dtype.name == "bfloat16"
                       else x)
    return out


def _names(tree):
    return _flatten_with_names(tree)[0]


# ---------------------------------------------------------------------------
# data, loss, optimizer, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_is_the_jax_copy(arch):
    cfg_t, cfg_j = get_smoke_config(arch), jax_smoke_config(arch)
    mine = data.DataConfig(batch_size=3, seq_len=9, seed=5)
    ref = jax_data.DataConfig(batch_size=3, seq_len=9, seed=5)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for step in (0, 7, 123):
        a = data.batch_fn(cfg_t, mine)(step)
        b = jax_data.lm_batch_at_step(cfg_j, ref, step)
        assert sorted(a) == sorted(b)
        assert ("frontend_embeds" in a) == (cfg_t.frontend is not None)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)


@pytest.mark.parametrize("mask", ["none", "ones", "some", "zeros"])
def test_softmax_cross_entropy_matches_jax(mask):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    m = {"none": None, "ones": np.ones((2, 5), np.float32),
         "some": (rng.random((2, 5)) > 0.4).astype(np.float32),
         "zeros": np.zeros((2, 5), np.float32)}[mask]
    want = jax_layers.softmax_cross_entropy(
        logits, labels, None if m is None else jnp.asarray(m))
    got = L.softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                  None if m is None else torch.tensor(m))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_inputs():
    rng = np.random.default_rng(0)

    def tree(scale):
        return {"b": {"w": rng.standard_normal((3, 5, 4)) * scale,
                      "s": rng.standard_normal((2, 7)) * scale},
                "a": rng.standard_normal(9) * scale}

    f32 = lambda t: jax.tree_util.tree_map(lambda x: x.astype(np.float32), t)
    p, g, m = f32(tree(1.0)), f32(tree(0.3)), f32(tree(0.01))
    v = jax.tree_util.tree_map(lambda x: np.abs(x) * 1e-3, f32(tree(1.0)))
    return p, g, m, v


def _tensors(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
@pytest.mark.parametrize("clip", [None, 1.0, 0.37])
def test_adamw_update_matches_jax(clip, jit):
    p, g, m, v = _opt_inputs()
    update = lambda *a: JO.adamw_update(*a, jnp.float32(1e-3),
                                        grad_clip_norm=clip)
    pj, sj, mj = (jax.jit(update) if jit else update)(
        p, g, JO.OptState(jnp.int32(3), m, v))
    pt, st, mt = O.adamw_update(
        _tensors(p), _tensors(g),
        O.OptState(torch.tensor(3, dtype=torch.int32), _tensors(m),
                   _tensors(v)), torch.tensor(1e-3), grad_clip_norm=clip)
    assert st.step.dtype == torch.int32 and int(st.step) == int(sj.step) == 4
    assert _names(pt) == _names(jax.device_get(pj))
    # the norm's sum of squares folds the leaves in the same order; inside
    # a leaf XLA and PyTorch sum in their own orders
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=2.4e-7)
    exact = clip is None and not jit
    for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
        for a, b in zip(_leaves(got), _leaves(jax.device_get(want))):
            if exact:
                assert a.tobytes() == b.tobytes()
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5,
                                           atol=1e-7 * np.abs(b).max())


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
def test_lr_schedule_matches_jax(jit):
    """Warmup, its end, the cosine's middle and past the end: bit-equal
    but where the two libraries' cosines part (2 ulp at most)."""
    sched = lambda s: JO.lr_schedule(s, peak_lr=3e-3, warmup_steps=5,
                                     total_steps=50)
    sched = jax.jit(sched) if jit else sched
    for s in (0, 3, 5, 17, 27, 49, 50, 80):
        want = np.asarray(sched(jnp.int32(s)))
        got = O.lr_schedule(torch.tensor(s, dtype=torch.int32), peak_lr=3e-3,
                            warmup_steps=5, total_steps=50)
        assert got.dtype == torch.float32
        ulps = abs(int(got.numpy().view(np.int32)) - int(want.view(np.int32)))
        assert ulps <= (2 if 5 < s < 50 else 0), (s, ulps)


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
def test_int8_compression_matches_jax(jit):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 30)).astype(np.float32)
    x[0, 0], x[1, 1] = 5.0, np.float32(5.0 / 127 * 2.5)  # a half to round
    quant = jax.jit(JC.quantize_int8) if jit else JC.quantize_int8
    qj, sj = quant(x)
    qt, st = C.quantize_int8(torch.tensor(x))
    assert qt.dtype == torch.int8 and float(st) == float(sj)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    _, g, m, _ = _opt_inputs()
    comp = jax.jit(JC.compress_grads_int8_ef) if jit \
        else JC.compress_grads_int8_ef
    gj, ej = comp(g, m)
    gt, et = C.compress_grads_int8_ef(_tensors(g), _tensors(m))
    for a, b, r in zip(_leaves((gt, et)), _leaves(jax.device_get((gj, ej))),
                       _leaves((gt, gt))):
        if jit:
            # one quantum, where XLA's fused division rounds a value
            # across a half
            assert np.abs(a - b).max() <= np.abs(r).max() / 127 * 1.001
        else:
            assert a.tobytes() == b.tobytes()
    for a, b in zip(_leaves(C.ef_init(_tensors(g))),
                    _leaves(jax.device_get(JC.ef_init(g)))):
        assert a.dtype == b.dtype == np.float32 and not a.any()


# ---------------------------------------------------------------------------
# the train step against the jitted JAX step
# ---------------------------------------------------------------------------

def _pair(compression="none", micro=1):
    """The same TrainState, fp32 config and hyperparameters in both
    packages (the JAX init carried across); returns (jax state, jitted
    jax step, port state, port step, batch_at_step)."""
    cfg_j = JaxModelConfig(**CFG, dtype="float32",
                           use_grad_accum_microbatches=micro)
    cfg_t = ModelConfig(**CFG, dtype="float32",
                        use_grad_accum_microbatches=micro)
    hj = JL.TrainHyper(**HYPER, compression=compression)
    ht = TrainHyper(**HYPER, compression=compression)
    api_j = jax_model_api(cfg_j)
    state_j = JL.init_train_state(unbox(api_j.init(jax.random.PRNGKey(11))),
                                  hj)
    state_t = train_state_from_numpy(jax.device_get(state_j), "cpu")
    return (state_j, jax.jit(JL.make_train_step(api_j, hj)), state_t,
            make_train_step(model_api(cfg_t), ht),
            data.batch_fn(cfg_t, data.DataConfig(**DATA)))


def _hold_params(got, want, lr_sum, exact_mode):
    for a, b in zip(_leaves(got), _leaves(jax.device_get(want))):
        if exact_mode:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            d = np.abs(a.astype(np.float64) - b)
            assert d.max() <= 2 * lr_sum, (d.max(), lr_sum)
            assert np.mean(d > 1e-6) <= 1e-2, np.mean(d > 1e-6)


def test_train_state_carries_across_exactly():
    state_j, _, state_t, _, _ = _pair("int8_ef")
    host = jax.device_get(state_j)
    assert _names(state_t) == _names(host)
    assert state_t.opt.step.dtype == torch.int32
    for a, b in zip(_leaves(state_t), _leaves(host)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # the port's own init has the same tree, dtypes and shapes
    mine = init_train_state(model_api(ModelConfig(**CFG)).init(
        torch.Generator().manual_seed(0)), TrainHyper(compression="int8_ef"))
    assert _names(mine) == _names(host)
    assert [(a.dtype, a.shape) for a in _leaves(mine)] == \
        [(b.dtype, b.shape) for b in _leaves(host)]


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
def test_train_step_matches_jax(compression):
    state_j, step_j, state_t, step_t, bat = _pair(compression)
    p0 = _leaves(state_t.params)
    lr_sum = 0.0
    for i in range(3):
        state_j, mj = step_j(state_j, bat(i))
        state_t, mt = step_t(state_t, bat(i))
        assert sorted(mt) == sorted(mj)
        for k in ("loss", "aux_loss", "perplexity"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        assert float(mt["lr"]) == float(mj["lr"])
        lr_sum += float(mt["lr"])
        if i == 0:
            # lr 0: parameters as they were; mu = 0.1 x the clipped
            # (compressed) gradients
            for a, b in zip(_leaves(state_t.params), p0):
                assert a.tobytes() == b.tobytes()
            for a, b in zip(_leaves(state_t.opt.mu),
                            _leaves(jax.device_get(state_j.opt.mu))):
                top = np.abs(b).max()
                tol = {"none": 1e-6 * top, "bf16": 2.0 ** -7 * top,
                       "int8_ef": top / 127 * 1.001}[compression]
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=tol)
    assert int(state_t.opt.step) == int(state_j.opt.step) == 3
    assert (state_t.ef is None) == (compression != "int8_ef")
    _hold_params(state_t.params, state_j.params, lr_sum,
                 compression == "none")


def test_grad_accumulation_matches_jax():
    """2 microbatches, each package's: loss and parameters after 2 steps
    as the uncompressed step's."""
    state_j, step_j, state_t, step_t, bat = _pair(micro=2)
    for i in range(2):
        state_j, mj = step_j(state_j, bat(i))
        state_t, mt = step_t(state_t, bat(i))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
    _hold_params(state_t.params, state_j.params, 0.0, True)
    for a, b in zip(_leaves(state_t.opt.nu),
                    _leaves(jax.device_get(state_j.opt.nu))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 *
                                   np.abs(b).max())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_restores_across_packages(first, tmp_path):
    """3 steps of one package, saved; the other package restores them by
    leaf name (the tensors bit-equal to the saved ones) and runs 3 more,
    against 6 steps of the first package alone (the uncompressed step's
    tolerance)."""
    state_j, step_j, state_t, step_t, bat = _pair()
    d = str(tmp_path)
    if first == "jax":
        for i in range(3):
            state_j, _ = step_j(state_j, bat(i))
        jax_ckpt.save_checkpoint(d, 3, state_j)
        saved = jax.device_get(state_j)
        resumed, start = elastic_restore(d, state_t)
        assert start == 3
        assert _names(resumed) == _names(saved)
        for a, b in zip(_leaves(resumed), _leaves(saved)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for a, b in zip(_leaves(resumed),
                        _leaves(train_state_from_numpy(saved, "cpu"))):
            assert a.tobytes() == b.tobytes()
        for i in range(3, 6):
            resumed, _ = step_t(resumed, bat(i))
            state_j, _ = step_j(state_j, bat(i))
        got, want = resumed, state_j
    else:
        for i in range(3):
            state_t, _ = step_t(state_t, bat(i))
        ckpt.save_checkpoint(d, 3, state_t)
        resumed = jax_ckpt.restore_checkpoint(jax_ckpt.latest_checkpoint(d),
                                              jax.device_get(state_j))
        for a, b in zip(_leaves(jax.device_get(resumed)), _leaves(state_t)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for i in range(3, 6):
            resumed, _ = step_j(resumed, bat(i))
            state_t, _ = step_t(state_t, bat(i))
        got, want = state_t, resumed
    assert int(got.opt.step) == int(want.opt.step) == 6
    _hold_params(got.params, want.params, 0.0, True)


# ---------------------------------------------------------------------------
# tests/test_train.py's cases on the port
# ---------------------------------------------------------------------------

def _setup(compression="none", micro=1):
    cfg = ModelConfig(**CFG, use_grad_accum_microbatches=micro)
    api = model_api(cfg)
    hyper = TrainHyper(**HYPER, compression=compression)
    state = init_train_state(api.init(torch.Generator().manual_seed(11)),
                             hyper)
    return cfg, state, make_train_step(api, hyper), data.batch_fn(
        cfg, data.DataConfig(**DATA))


def test_loss_decreases():
    _, state, step, bat = _setup()
    losses = []
    for i in range(40):
        state, m = step(state, bat(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[:5]


@pytest.mark.parametrize("compression", ["bf16", "int8_ef"])
def test_compressed_training_still_learns(compression):
    _, state, step, bat = _setup(compression=compression)
    losses = []
    for i in range(40):
        state, m = step(state, bat(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.4


def test_grad_accum_matches_full_batch():
    """2-microbatch grad accumulation == single-batch step (same batch)."""
    _, state1, step1, bat = _setup(micro=1)
    _, state2, step2, _ = _setup(micro=2)
    b = bat(0)
    s1, m1 = step1(state1, b)
    s2, m2 = step2(state2, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    for a, b_ in zip(_leaves(s1.params), _leaves(s2.params)):
        np.testing.assert_allclose(a, b_, rtol=5e-2, atol=5e-4)


def test_restart_equals_uninterrupted(tmp_path):
    """Crash at step 12, restore from the checkpoint at 10, resume: the
    final state bit-equal to an uninterrupted run's."""
    _, state0, step, bat = _setup()
    full = run_with_fault_tolerance(
        step, state0, bat, num_steps=20, ckpt_dir=str(tmp_path / "a"),
        ckpt_every=5)
    with pytest.raises(RuntimeError, match="injected fault at step 12"):
        run_with_fault_tolerance(
            step, state0, bat, num_steps=20, ckpt_dir=str(tmp_path / "b"),
            ckpt_every=5, fail_at_step=12)
    restored, start = elastic_restore(str(tmp_path / "b"), state0)
    assert start == 10
    resumed = run_with_fault_tolerance(
        step, restored, bat, num_steps=20, ckpt_dir=str(tmp_path / "b"),
        ckpt_every=5, start_step=start)
    assert full.completed_steps == resumed.completed_steps == 20
    assert not full.interrupted and not resumed.interrupted
    for a, b in zip(_leaves(full.final_state), _leaves(resumed.final_state)):
        assert a.tobytes() == b.tobytes()
    assert elastic_restore(str(tmp_path / "none"), state0) == (None, 0)


def test_preemption_guard_checkpoints(tmp_path):
    _, state, step, bat = _setup()
    guard = PreemptionGuard(install_handler=False)
    guard.preempted = True
    res = run_with_fault_tolerance(
        step, state, bat, num_steps=10, ckpt_dir=str(tmp_path),
        ckpt_every=100, guard=guard)
    assert res.interrupted and res.completed_steps == 0
    assert ckpt.latest_checkpoint(str(tmp_path)) is not None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(main, argv):
    """Run a launcher's ``main`` in this process; its stdout lines.  The
    SIGTERM handler its ``PreemptionGuard`` installs is put back."""
    handler = signal.getsignal(signal.SIGTERM)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
    finally:
        signal.signal(signal.SIGTERM, handler)
    return out.getvalue().splitlines()


def _shape(line):
    """A line with its numbers blanked."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line)


@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-medium"])
def test_launcher_trains_and_restarts(arch, tmp_path):
    """The JAX launcher's lines (its own run for mamba2; the values differ,
    another weight draw), then a restart from the checkpoint dir."""
    args = ["--arch", arch, "--smoke", "--steps", "6", "--batch-size", "2",
            "--seq-len", "16", "--ckpt-every", "3", "--log-every", "2"]
    mine = _launch(launch.main, args + ["--device", "cpu", "--ckpt-dir",
                                        str(tmp_path / "port")])
    if arch == "mamba2-130m":
        ref = _launch(jax_launch.main, args + ["--ckpt-dir",
                                               str(tmp_path / "jax")])
        assert [_shape(l) for l in mine] == [_shape(l) for l in ref]
        assert mine[0] == ref[0]
    assert mine[0].startswith(f"arch={get_smoke_config(arch).name} params=")
    assert [l.split(":")[0] for l in mine[1:4]] == ["step 2", "step 4",
                                                    "step 6"]
    assert all("nan" not in l for l in mine)
    assert re.fullmatch(r"done: steps=6 interrupted=False final_loss=\S+",
                        mine[-1])
    # a second call restores step 6 and runs to 9
    more = _launch(launch.main, args[:4] + ["9"] + args[5:] + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    assert more[1] == "restored checkpoint at step 6"
    assert more[-1].startswith("done: steps=9 interrupted=False")
    assert ckpt.checkpoint_step(ckpt.latest_checkpoint(
        str(tmp_path / "port"))) == 9


def test_launcher_asks_for_an_arch():
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu"])
