"""The port's partitioned train step (``train.loop.make_train_step`` on a
state of ``DTensor`` leaves placed by the logical-axis specs) and its
mesh-aware checkpoints, against the JAX package's single-device step and
the port's meshless step.

One gloo job of four processes (``torch.multiprocessing.spawn``, a free
localhost port) builds a (2, 2) ``("data", "model")`` mesh and runs:

* JAX parity: ``h2o-danube-3-4b``'s smoke config in fp32, the JAX
  package's init carried across, one partitioned step against one
  ``jax.jit`` step of the JAX package (the twin of
  ``tests/test_sharding.py``'s sharded step, its hyperparameters):
  loss rtol 1e-5; the step's learning rate is 0, so the parameters stay
  as they were (bit for bit) and the moments are the clipped gradients',
  held as ``tests/test_torch_train.py`` holds them (rtol 1e-4, atol 1e-6
  of the leaf's max);
* the port's meshless step against its partitioned step, one step from
  step 10 (learning rate 3e-5): danube plain, with two microbatches and
  with ``int8_ef``; ``mamba2-130m``; ``qwen3-moe-30b-a3b`` at its own
  capacity factor and at 0.5, both dropping choices, the drop counts
  equal.  Loss within 1e-6 relative, every leaf within 1e-5 (int8_ef
  too: a gradient entry whose ``g / scale`` sat within float noise of
  an int8 rounding boundary would round the other way in the other step
  and move its residual by one quantum; none does at these inputs);
* each rank's local shapes against ``local_shape`` of its spec;
* checkpoints: two steps on (2, 2), saved blocking and through the
  fault-tolerant runner's ``AsyncCheckpointer``; both byte-equal to the
  save of the same state from one process.  ``elastic_restore`` onto (4, 1), (1, 4) and no mesh
  restores the state bit for bit, and a third step from each equals the
  uninterrupted run at the tolerance above.

The batches are NumPy draws from a seed whose ``loss_mask`` drops ~30 %
of the positions and one whole row, so the ranks' kept counts differ.
"""
from __future__ import annotations

import dataclasses
import filecmp
import os
import socket
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import model_api as jax_model_api
from repro.sharding import abstract_mesh as jax_abstract_mesh
from repro.sharding import named_sharding as jax_named_sharding
from repro.sharding import unbox
from repro.train import loop as JL
from repro_torch.sharding import partition as P
from repro_torch.train.checkpoint import _flatten_with_names

WORLD = 4
MESH = (2, 2)
AXES = ("data", "model")
B, S = 8, 16
JAX_S = 32
DANUBE = "h2o-danube-3-4b"
JAX_HYPER = dict(warmup_steps=1, total_steps=10)   # tests/test_sharding.py's
CASES = {
    "danube": (DANUBE, {}, "none"),
    "danube-micro2": (DANUBE, {"use_grad_accum_microbatches": 2}, "none"),
    "danube-int8": (DANUBE, {}, "int8_ef"),
    "mamba2": ("mamba2-130m", {}, "none"),
    "qwen3": ("qwen3-moe-30b-a3b", {}, "none"),
    "qwen3-factor-0.5": ("qwen3-moe-30b-a3b", {"moe_capacity_factor": 0.5},
                         "none"),
}
RESTORES = ((4, 1), (1, 4), None)


def _batch(vocab: int, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s + 1))
    mask = (rng.random((b, s)) >= 0.3).astype(np.float32)
    mask[b - 3] = 0.0          # a whole row dropped
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32), "loss_mask": mask}


def _np(tree) -> list:
    return [x.detach().numpy().copy() for x in _flatten_with_names(tree)[1]]


# ---------------------------------------------------------------------------
# In-process: specs and placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [("batch", None, "mlp"), ("embed", "vocab"),
                                  ("expert", "embed", "expert_mlp"),
                                  ("kv_heads", "head_dim")], ids=str)
@pytest.mark.parametrize("shape", [(2, 2), (2, 4, 4)], ids=str)
def test_named_sharding_spec_equals_jax(axes, shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    want = jax_named_sharding(axes, jax_abstract_mesh(shape, names)).spec
    got = P.named_sharding(axes, P.abstract_mesh(shape, names))
    assert got.spec == tuple(want)[:len(axes)] + (None,) * (
        len(axes) - len(tuple(want)))


def test_placements_nest_multi_axis_entries_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = P.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    sh = P.named_sharding(("batch", None, "mlp"), mesh)
    assert sh.spec == (("pod", "data"), None, "model")
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert P.NamedSharding(mesh, (None, None)).placements == (Replicate(),) * 3


MIS_ORDERED = [(("model", "data"),), (("data", "pod"),),
               (("model", "pod"), None)]
_JAX_BLOCKS = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
devs = np.array(jax.devices()).reshape(2, 2, 2)
mesh = Mesh(devs, ("pod", "data", "model"))
out = []
for spec in json.loads(sys.argv[1]):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    shape = (8, 3)[:len(spec)]
    x = jax.device_put(np.arange(int(np.prod(shape))).reshape(shape),
                       NamedSharding(mesh, PartitionSpec(*spec)))
    out.append({json.dumps(np.argwhere(devs == s.device)[0].tolist()):
                np.asarray(s.data).tolist() for s in x.addressable_shards})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    """Each device's block of an arange under each ``MIS_ORDERED`` spec,
    from ``jax.device_put`` on eight forced host devices (a subprocess:
    the device count is fixed when JAX starts)."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run([sys.executable, "-c", _JAX_BLOCKS,
                          json.dumps(MIS_ORDERED)], capture_output=True,
                         text=True, env=env, check=True)
    return json.loads(run.stdout.splitlines()[-1])


@pytest.mark.parametrize("i", range(len(MIS_ORDERED)),
                         ids=[str(s) for s in MIS_ORDERED])
def test_a_mis_ordered_multi_axis_entry_takes_jax_block_order(jax_blocks,
                                                              i):
    """An entry whose axes are out of the mesh's order (the
    ``("model", "data")`` entries of ``DECODE_RULES``) gives each rank the
    block JAX's ``P(entry)`` gives that device: the entry's first axis
    major."""
    import json
    spec = MIS_ORDERED[i]
    shape = (8, 3)[:len(spec)]
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    assert len(jax_blocks[i]) == 8
    for coord, want in jax_blocks[i].items():
        mesh = P.abstract_mesh((2, 2, 2), ("pod", "data", "model"),
                               json.loads(coord))
        got = P.block_of(x, P.NamedSharding(mesh, spec))
        assert got.tolist() == want, (spec, coord)


def test_an_axis_off_the_mesh_or_used_twice_raises():
    mesh = P.abstract_mesh((2, 2), ("data", "model"))
    for spec in (("pod",), ("data", "data")):
        with pytest.raises(ValueError, match="off the mesh"):
            P.NamedSharding(mesh, spec)


def test_remat_recomputes_in_the_context_of_its_first_call():
    """The autograd engine runs the backward of CUDA tensors on a thread
    of its own, which does not see the caller's context variables (the
    row shard a partitioned MoE layer routes by).  A backward started on
    a new thread stands in for it here: the recompute must see what the
    first call saw."""
    import contextvars
    import threading

    from repro_torch.models.transformer import remat
    scale = contextvars.ContextVar("scale", default=1.0)
    body = remat(SimpleNamespace(remat="full"),
                 lambda x: torch.sin(x * scale.get()))
    x = torch.linspace(-1.0, 1.0, 7, requires_grad=True)
    token = scale.set(2.0)
    try:
        y = body(x).sum()
    finally:
        scale.reset(token)
    thread = threading.Thread(target=y.backward)
    thread.start()
    thread.join()
    want = 2.0 * torch.cos(2.0 * x.detach())
    torch.testing.assert_close(x.grad, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The gloo job
# ---------------------------------------------------------------------------

def _api(arch, extra):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import model_api
    return model_api(dataclasses.replace(get_smoke_config(arch),
                                         dtype="float32", **extra))


def _shardings(api, hyper, mesh):
    from repro_torch.models import layers as L
    from repro_torch.train import loop
    boxed = L.abstract(api.init, torch.Generator().manual_seed(0))
    return P.tree_named_shardings(loop.train_state_boxed(boxed, hyper), mesh)


def _full(state) -> list:
    return [P.full_tensor(x).numpy().copy()
            for x in _flatten_with_names(state)[1]]


def _state(api, hyper, step=10):
    from repro_torch.train import loop
    state = loop.init_train_state(api.init(torch.Generator().manual_seed(3)),
                                  hyper)
    return state._replace(opt=state.opt._replace(
        step=torch.tensor(step, dtype=torch.int32)))


def _parity_cases(mesh, rank):
    from repro_torch.models import moe
    from repro_torch.train import loop
    out = {}
    for name, (arch, extra, comp) in CASES.items():
        api = _api(arch, extra)
        hyper = loop.TrainHyper(compression=comp)
        step = loop.make_train_step(api, hyper)
        state = _state(api, hyper)
        batch = _batch(api.cfg.vocab_size, B, S, 5)
        with moe.count_drops() as drops:
            new, m = step(P.place(state, _shardings(api, hyper, mesh)),
                          batch)
        res = {"loss": float(m["loss"]), "drops": drops["dropped"],
               "metrics": {k: float(v) for k, v in m.items()},
               "leaves": _full(new)}
        if rank == 0:
            with moe.count_drops() as drops:
                want, wm = step(state, batch)
            res["want"] = {"loss": float(wm["loss"]),
                           "drops": drops["dropped"],
                           "metrics": {k: float(v) for k, v in wm.items()},
                           "leaves": _np(want)}
        out[name] = res
    return out


def _placement_case(mesh):
    from repro_torch.train import loop
    api = _api(DANUBE, {})
    hyper = loop.TrainHyper(compression="int8_ef")
    sh = _shardings(api, hyper, mesh)
    placed = P.place(_state(api, hyper), sh)
    names, leaves, _ = _flatten_with_names(placed)
    return [(n, tuple(x.to_local().shape), tuple(x.shape), s.spec)
            for n, x, s in zip(names, leaves, _flatten_with_names(sh)[1])]


def _jax_case(mesh, state_path):
    from repro_torch.train import loop
    api = _api(DANUBE, {})
    hyper = loop.TrainHyper(**JAX_HYPER)
    template = loop.init_train_state(
        api.init(torch.Generator().manual_seed(0)), hyper)
    d = np.load(state_path)
    names, _, unflatten = _flatten_with_names(template)
    state = P.place(unflatten([torch.from_numpy(d[n]) for n in names]),
                    _shardings(api, hyper, mesh))
    step = loop.make_train_step(api, hyper)
    state, m = step(state, _batch(api.cfg.vocab_size, B, JAX_S, 0))
    return dict({k: float(v) for k, v in m.items()}, leaves=_full(state))


def _checkpoint_case(mesh, rank, work):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.fault_tolerance import (elastic_restore,
                                                   run_with_fault_tolerance)
    api = _api(DANUBE, {})
    hyper = loop.TrainHyper()
    step = loop.make_train_step(api, hyper)
    state = _state(api, hyper)

    def bat(i):
        return _batch(api.cfg.vocab_size, B, S, 100 + i)

    out = {}
    placed = P.place(state, _shardings(api, hyper, mesh))
    run = run_with_fault_tolerance(step, placed, bat, num_steps=2,
                                   ckpt_dir=os.path.join(work, "async"),
                                   ckpt_every=1)
    two = placed
    for i in range(2):
        two, _ = step(two, bat(i))
    save_checkpoint(os.path.join(work, "mesh"), 2, two)
    out["saved"] = _full(two)
    out["runner_equal"] = all(np.array_equal(a, b) for a, b in zip(
        _full(run.final_state), out["saved"]))
    three, m = step(two, bat(2))
    out["uninterrupted"] = (float(m["loss"]), _full(three))
    if rank == 0:
        # the same state from one process: plain tensors of its values
        _, _, unflatten = _flatten_with_names(state)
        save_checkpoint(os.path.join(work, "plain"), 2, unflatten(
            [torch.from_numpy(a) for a in out["saved"]]))
        plain = state
        for i in range(3):
            plain, m = step(plain, bat(i))
        out["plain"] = (float(m["loss"]), _np(plain))
    for target in RESTORES:
        sub = None if target is None else make_test_mesh(target, AXES)
        restored, at = elastic_restore(
            os.path.join(work, "mesh"), state,
            None if sub is None else _shardings(api, hyper, sub))
        got = _full(restored)
        new, m = step(restored, bat(2))
        out[target] = {"step": at, "restored": got,
                       "dtensor": P.is_dtensor(restored.opt.mu["embed"]),
                       "local": tuple(restored.params["embed"].to_local().shape
                                      if sub is not None else ()),
                       "third": (float(m["loss"]), _full(new))}
    return out


def _worker(rank: int, port: int, work: str) -> None:
    from repro_torch import distributed as pdist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    res = {"rank": rank}
    try:
        mesh = make_test_mesh(MESH, AXES)
        res["coords"] = tuple(mesh.get_coordinate())
        res["placement"] = _placement_case(mesh)
        with pdist.count_wire() as wire:
            res["parity"] = _parity_cases(mesh, rank)
        res["wire"] = wire
        res["jax"] = _jax_case(mesh, os.path.join(work, "jax_state.npz"))
        res["ckpt"] = _checkpoint_case(mesh, rank, work)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))


def _jax_steps(work: str):
    """The JAX package's danube smoke state (fp32, its own init), saved
    for the job: (api, hyper, state, leaf names)."""
    cfg = dataclasses.replace(jax_smoke_config(DANUBE), dtype="float32")
    api = jax_model_api(cfg)
    hyper = JL.TrainHyper(**JAX_HYPER)
    state = JL.init_train_state(unbox(api.init(jax.random.PRNGKey(0))),
                                hyper)
    names, leaves, _ = _flatten_with_names(jax.device_get(state))
    np.savez(os.path.join(work, "jax_state.npz"),
             **{n: np.asarray(x) for n, x in zip(names, leaves)})
    return api, hyper, state, names


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("partitioned"))
    api, hyper, state, names = _jax_steps(work)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.spawn(_worker, args=(port, work), nprocs=WORLD, join=False)
    state, m = jax.jit(JL.make_train_step(api, hyper))(
        state, _batch(api.cfg.vocab_size, B, JAX_S, 0))
    jax_res = ({k: float(v) for k, v in m.items()},
               [np.asarray(x) for x in
                _flatten_with_names(jax.device_get(state))[1]])
    while not ctx.join():
        pass
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return SimpleNamespace(ranks=ranks, jax=jax_res, names=names, work=work)


def _leaf_names(arch, extra, comp):
    from repro_torch.train import loop
    api = _api(arch, extra)
    return _flatten_with_names(_state(api, loop.TrainHyper(
        compression=comp)))[0]


@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_step_equals_the_meshless_step(job, case):
    want = job.ranks[0]["parity"][case]["want"]
    names = _leaf_names(*CASES[case])
    assert len(names) == len(want["leaves"]) > 20
    for r in job.ranks:
        got = r["parity"][case]
        assert abs(got["loss"] / want["loss"] - 1) <= 1e-6, (got["loss"],
                                                            want["loss"])
        for k in ("aux_loss", "perplexity", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert got["metrics"]["lr"] == want["metrics"]["lr"] > 0
        assert got["drops"] == want["drops"]
        for n, a, b in zip(names, got["leaves"], want["leaves"]):
            assert a.shape == b.shape and a.dtype == b.dtype, n
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=n)


def test_moe_cases_drop_choices(job):
    drops = {c: job.ranks[0]["parity"][c]["want"]["drops"]
             for c in ("qwen3", "qwen3-factor-0.5")}
    assert 0 < drops["qwen3"] < drops["qwen3-factor-0.5"], drops
    assert job.ranks[0]["parity"]["qwen3"]["metrics"]["aux_loss"] > 0


def test_each_rank_holds_its_spec_block(job):
    coords = {r["coords"] for r in job.ranks}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    mesh = P.abstract_mesh(MESH, AXES)
    for r in job.ranks:
        sharded = 0
        for name, local, shape, spec in r["placement"]:
            assert local == P.local_shape(shape, spec, mesh), name
            sharded += local != shape
        assert sharded > 10
    # the state's bytes split: less than half of them on a rank
    whole = sum(np.prod(s) for _, _, s, _ in job.ranks[0]["placement"])
    held = sum(np.prod(l) for _, l, _, _ in job.ranks[0]["placement"])
    assert held < whole / 2


def test_collectives_went_through_the_wire_counter(job):
    for r in job.ranks:
        w = r["wire"]
        assert w["collectives"] > 6 * 20 and w["bytes"] > 0
        assert w["host_copies"] == 0          # CPU tensors on a gloo mesh


def test_partitioned_step_equals_the_jax_single_device_step(job):
    mj, leaves_j = job.jax
    assert mj["lr"] == 0
    for r in job.ranks:
        got = r["jax"]
        for k in ("loss", "aux_loss", "perplexity"):
            np.testing.assert_allclose(got[k], mj[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], mj["grad_norm"],
                                   rtol=1e-4)
        assert got["lr"] == mj["lr"]
        assert len(got["leaves"]) == len(leaves_j) == len(job.names)
        for n, a, b in zip(job.names, got["leaves"], leaves_j):
            assert a.shape == b.shape and a.dtype == b.dtype, n
            if n == ".opt/.step":
                assert a == b == 1
            elif n.startswith(".opt/"):
                np.testing.assert_allclose(
                    a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max(), err_msg=n)
                assert np.abs(b).max() > 0, n
            else:             # lr 0: the parameters as they were
                assert a.tobytes() == b.tobytes(), n


def test_checkpoint_saved_from_the_mesh_is_byte_equal(job):
    plain = os.path.join(job.work, "plain", "step_00000002")
    files = sorted(os.listdir(plain))
    assert "manifest.json" in files and len(files) > 20
    for kind in ("mesh", "async"):
        got = os.path.join(job.work, kind, "step_00000002")
        assert sorted(os.listdir(got)) == files, kind
        for f in files:
            assert filecmp.cmp(os.path.join(got, f), os.path.join(plain, f),
                               shallow=False), (kind, f)
    # the runner's saves: steps 1 and 2, nothing left half-written
    assert sorted(os.listdir(os.path.join(job.work, "async"))) == [
        "step_00000001", "step_00000002"]
    for r in job.ranks:
        assert r["ckpt"]["runner_equal"]


@pytest.mark.parametrize("target", RESTORES, ids=str)
def test_elastic_restore_onto_another_mesh(job, target):
    want_loss, want = job.ranks[0]["ckpt"]["plain"]
    for r in job.ranks:
        c = r["ckpt"]
        res = c[target]
        assert res["step"] == 2
        assert res["dtensor"] == (target is not None)
        if target is not None:
            assert res["local"] == (512 // target[1], 128 // target[0])
        for a, b in zip(res["restored"], c["saved"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        loss, leaves = res["third"]
        for ref_loss, ref in (c["uninterrupted"], (want_loss, want)):
            assert abs(loss / ref_loss - 1) <= 1e-6
            for a, b in zip(leaves, ref):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
