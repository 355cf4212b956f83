"""The port's checkpointing and fault tolerance (``repro_torch.train``):
twins of the checkpoint, checkpointer and detector tests of
``tests/test_train.py`` (the round trip on a FlexAI ``TrainState``, where
the JAX test takes an LM state), the on-disk layout and leaf names shared
with the JAX package, and the training launcher's snapshot and resume,
which must continue a run bit for bit.
"""
import json
import os
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ckpt_jax
from repro_torch.core.flexai import engine
from repro_torch.launch import train as train_launch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (HeartbeatRecord,
                                               PreemptionGuard,
                                               StragglerDetector)
from test_torch_pipeline import one_torch_thread  # noqa: F401


def _train_state():
    """A FlexAI ``TrainState`` after one short episode (its replay ring
    written, Adam stepped, the generator advanced)."""
    args = train_launch.parser().parse_args(
        ["--flexai", "--episodes", "1", "--routes", "1", "--rate-scale",
         "0.002", "--route-km", "0.01", "--device", "cpu"])
    trainer, _, _, _ = train_launch.train_flexai(args)
    return trainer


def _as_numpy(tree):
    """The same tree with host NumPy leaves (a generator as its state),
    for ``jax.tree_util``."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_as_numpy(v) for v in tree])
    if isinstance(tree, torch.Generator):
        return tree.get_state().numpy()
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def test_checkpoint_roundtrip(tmp_path):
    """A trainer snapshot saved and restored into a template: every leaf
    equal with the template's type, dtype and device, the generator's
    draws continuing where the saved one's do; the leaf names are what
    ``jax.tree_util`` names the same tree."""
    trainer = _train_state()
    snap = train_launch._trainer_snapshot(trainer, 1)
    path = ckpt.save_checkpoint(str(tmp_path), 3, snap)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    assert ckpt.checkpoint_step(path) == 3
    assert sorted(os.listdir(path))[:2] == ["arr_00000.npy", "arr_00001.npy"]

    names, leaves, _ = ckpt._flatten_with_names(snap)
    want, _, _ = ckpt_jax._flatten_with_names(_as_numpy(snap))
    assert names == want
    assert "['ts']/.eval_p/.w1" in names and "['episode']" in names

    fresh = engine.train_init(trainer.state_dim, trainer.n_actions,
                              trainer.cfg.replay_capacity, seed=99,
                              device="cpu")
    template = {**snap, "ts": fresh, "episode": np.int32(0)}
    restored = ckpt.restore_checkpoint(path, template)
    _, got, _ = ckpt._flatten_with_names(restored)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        elif isinstance(a, torch.Generator):
            assert torch.equal(a.get_state(), b.get_state())
        else:
            np.testing.assert_array_equal(a, b)
    ts = restored["ts"]
    assert torch.equal(torch.rand(5, generator=ts.generator),
                       torch.rand(5, generator=snap["ts"].generator))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(path, {**template, "best_p": type(
            template["best_p"])(*[p[:1] for p in template["best_p"]])})


def test_straggler_detection():
    det = StragglerDetector(n_hosts=4, threshold=1.5, window=8)
    now = time.time()
    for step in range(8):
        for h in range(4):
            dt = 1.0 if h != 2 else 2.5  # host 2 is slow
            det.record(HeartbeatRecord(h, step, dt, now))
    assert det.stragglers() == [2]
    assert det.dead_hosts(now=now + 120) == [0, 1, 2, 3]
    assert det.dead_hosts(now=now + 1) == []


def test_preemption_guard_flag():
    guard = PreemptionGuard(install_handler=False)
    assert not guard.preempted
    guard._handler(15, None)
    assert guard.preempted


def test_async_checkpointer_overlapping_saves_keep_order(tmp_path,
                                                         monkeypatch):
    real_write = ckpt._write

    def slow_write(directory, step, names, host):
        time.sleep(0.05)
        return real_write(directory, step, names, host)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(1, {"x": torch.full((4,), 1.0)})
    saver.save(2, {"x": torch.full((4,), 2.0)})  # overlaps save 1
    saver.save(1, {"x": torch.full((4,), 9.0)})  # stale resubmit: dropped
    saver.wait()
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert ckpt.checkpoint_step(path) == 2
    _, arrays, _ = ckpt.load_checkpoint_arrays(path)
    np.testing.assert_array_equal(arrays[0], np.full(4, 2.0, np.float32))
    assert ckpt.checkpoint_step(os.path.join(
        str(tmp_path), "step_00000001")) == 1


def test_async_checkpointer_callable_state(tmp_path):
    """A zero-argument callable defers the flatten and the host copy to
    the writer thread."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    payload = {"a": torch.arange(6, dtype=torch.float32), "b": np.arange(3)}
    saver.save(1, lambda: payload)
    saver.wait()
    restored = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(str(tmp_path)),
        {"a": torch.zeros(6), "b": np.zeros(3, np.int64)})
    assert torch.equal(restored["a"], torch.arange(6, dtype=torch.float32))
    np.testing.assert_array_equal(restored["b"], np.arange(3))


def test_async_checkpointer_keeps_the_newest(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        saver.save(step, {"x": torch.full((2,), float(step))})
    saver.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


@pytest.mark.parametrize("dtype,values", [
    ("bfloat16", [1.5, -2.0, 0.0, 3.25]),
    ("float16", [1.5, -2.0, 0.0, 3.25]),
    ("bool", [True, False, True, True]),
    ("int32", [1, -7, 0, 2**31 - 1]),
    ("float64", [1.0 / 3.0, -1e300, 0.0, 2.5]),
])
def test_checkpoint_dtype_roundtrip(tmp_path, dtype, values):
    """Each dtype through the manifest, as a tensor leaf: bf16 as its
    bits with "bfloat16" in the manifest (the JAX package's name for it),
    float64 exact (the JAX template path truncates it to float32 with x64
    off; ROADMAP section 3).  Each package reads the other's file."""
    t = torch.tensor(values, dtype=getattr(torch, dtype))
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 1, {"leaf": t})
    _, arrays, names = ckpt.load_checkpoint_arrays(path)
    assert names == ["['leaf']"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["arrays"][0]["dtype"] == dtype
    restored = ckpt.restore_checkpoint(path, {"leaf": torch.zeros_like(t)})
    assert restored["leaf"].dtype == t.dtype
    assert torch.equal(restored["leaf"], t)

    want = (np.asarray(values, ml_dtypes.bfloat16) if dtype == "bfloat16"
            else np.asarray(values, np.dtype(dtype)))
    _, from_port, _ = ckpt_jax.load_checkpoint_arrays(path)
    assert from_port[0].dtype == want.dtype
    np.testing.assert_array_equal(from_port[0], want)
    jax_path = ckpt_jax.save_checkpoint(str(tmp_path / "jax"), 1,
                                        {"leaf": want})
    from_jax = ckpt.restore_checkpoint(jax_path,
                                       {"leaf": torch.zeros_like(t)})
    assert torch.equal(from_jax["leaf"], t)
    if dtype == "float64" and not jax.config.jax_enable_x64:
        jax_restored = ckpt_jax.restore_checkpoint(
            path, {"leaf": np.zeros(4)})
        assert np.asarray(jax_restored["leaf"]).dtype == np.float32


def test_straggler_detector_injected_clock():
    now = [0.0]
    det = StragglerDetector(n_hosts=2, dead_after_s=5.0,
                            clock=lambda: now[0])
    det.record(HeartbeatRecord(0, 0, 1.0, timestamp=0.0))
    det.record(HeartbeatRecord(1, 0, 1.0, timestamp=0.0))
    assert det.dead_hosts() == []
    now[0] = 4.0
    assert det.dead_hosts() == []
    now[0] = 6.0
    assert det.dead_hosts() == [0, 1]
    det.record(HeartbeatRecord(1, 1, 1.0, timestamp=6.0))
    assert det.dead_hosts() == [0]


# ---------------------------------------------------------------------------
# the training launcher's snapshot and resume
# ---------------------------------------------------------------------------

# two short routes (193 and 161 tasks): the first TD update comes in the
# second episode, once the ring holds min_replay = 256 rows
TRAIN = ["--flexai", "--td-kernel", "--routes", "2", "--rate-scale",
         "0.001", "--route-km", "0.01", "--eval-every", "2", "--seed", "0",
         "--device", "cpu"]


def _state_leaves(trainer):
    snap = train_launch._trainer_snapshot(trainer, 0)
    snap.pop("episode")
    return ckpt._flatten_with_names(snap)[:2]


@pytest.mark.parametrize("mode", [[], ["--dp", "--dp-lanes", "2"]],
                         ids=["single", "dp"])
def test_trainer_resume_is_bit_exact(tmp_path, mode, capsys):
    """Two episodes, then ``--resume`` for two more, equal four
    uninterrupted episodes: every ``TrainState`` leaf (nets, Adam, rings,
    counters of their own types, the generator's state), the best and
    the saved weights."""
    def run(extra):
        args = train_launch.parser().parse_args(TRAIN + mode + extra)
        return train_launch.train_flexai(args)[0]

    full = run(["--episodes", "4"])
    snaps = str(tmp_path / "snaps")
    part = run(["--episodes", "2", "--snapshot-dir", snaps])
    assert sorted(os.listdir(snaps)) == ["step_00000001", "step_00000002"]
    resumed = run(["--episodes", "2", "--snapshot-dir", snaps, "--resume"])
    assert "resumed trainer snapshot at episode 2" in capsys.readouterr().out
    assert part.ts.updates > 0 and resumed.ts.updates > part.ts.updates
    names, want = _state_leaves(full)
    got_names, got = _state_leaves(resumed)
    assert got_names == names
    for name, a, b in zip(names, got, want):
        assert type(a) is type(b), name
        if isinstance(a, torch.Generator):
            assert torch.equal(a.get_state(), b.get_state()), name
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert resumed.best_eval_stm == full.best_eval_stm is not None
    assert resumed.losses == full.losses[len(full.losses)
                                         - len(resumed.losses):]
