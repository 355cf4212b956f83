"""The port's expert-parallel MoE (``moe_apply_shard_map`` over a gloo
process mesh, ``_pack_by_bucket``) against the JAX package's.

One gloo job of four processes (``torch.multiprocessing.spawn``, a free
localhost port) runs the mesh cases on a (2, 2) ``("data", "model")``
mesh, the first three also on a (1, 4) one, with the JAX package's
``init_moe`` weights carried across:

* at capacity factor 8.0 (no drops) the forward within 1e-5 of JAX's
  ``moe_apply_gspmd`` and every leaf's gradient (the experts, the
  router, the shared expert and the input) within 1e-3 of JAX's on
  every rank, the whole expert stacks or a rank's slice of them;
* at the config's factor 1.25 the outputs within 1e-5 and the drop
  counts equal to JAX's own ``moe_apply_shard_map`` on four forced host
  devices (one subprocess, started beside the job), its drops counted
  with its own ``_pack_by_bucket``;
* the three GSPMD rules: no mesh, ``E % model != 0``, ``n % shards !=
  0``;
* one ``make_train_step`` step of the qwen3-moe smoke config (fp32
  compute) with ``moe_impl="shard_map"`` on the mesh against the
  meshless step: loss and every leaf of the new state within 1e-5;
* ``serve_tokens`` of that config (bf16 compute, as it is): tokens and
  ``wave_log`` equal to the meshless engine's, and a ``ServeEngine`` on
  each rank's slice of the experts.

The last two run at capacity factor 8.0, where neither path drops a
choice: the two paths' capacities differ (per expert over all tokens,
against per destination rank and per local expert), so where they drop,
they drop different choices.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.models import moe as jax_moe
from repro.models.config import ModelConfig as JaxModelConfig
from repro.sharding import unbox
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

WORLD = 4
MESHES = ((2, 2), (1, 4))
SMALL = dict(name="ep", family="moe", num_layers=1, d_model=32, num_heads=2,
             num_kv_heads=2, d_ff=24, vocab_size=64, num_experts=8,
             num_experts_per_token=2, num_shared_experts=1, dtype="float32")
X_SHAPE = (4, 16, 32)


# ---------------------------------------------------------------------------
# _pack_by_bucket
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pack_by_bucket_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a, n_buckets, cap = 40, 5, 6          # 8 rows a bucket on average
    bucket = rng.integers(0, n_buckets, a).astype(np.int32)
    rows = rng.standard_normal((a, 3)).astype(np.float32)
    extra = rng.integers(0, 100, (a, 2)).astype(np.int32)
    want = jax_moe._pack_by_bucket(jnp.asarray(bucket), n_buckets, cap,
                                   jnp.asarray(rows), jnp.asarray(extra))
    got = moe._pack_by_bucket(torch.from_numpy(bucket), n_buckets, cap,
                              torch.from_numpy(rows),
                              torch.from_numpy(extra))
    assert not bool(got[3].all())                 # some rows overflow
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


# ---------------------------------------------------------------------------
# The gloo job
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _inputs():
    """The JAX package's weights and two inputs: ``x`` (N(0, 1)) and
    ``x_skew`` (a shared direction added, so routing crowds experts and
    drops choices at factor 1.25)."""
    cfg = JaxModelConfig(**SMALL)
    p = unbox(jax_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    skew = x + 1.5 * rng.standard_normal(X_SHAPE[-1]).astype(np.float32)
    return _flat(p), x, skew.astype(np.float32)


def _jax_reference(p, x):
    """JAX's GSPMD forward and the gradient of sum(out^2) + aux over every
    leaf and x, at factor 8.0."""
    cfg = JaxModelConfig(**SMALL, moe_capacity_factor=8.0)

    def loss(p, x):
        out, aux = jax_moe.moe_apply_gspmd(p, cfg, x)
        return jnp.sum(out ** 2) + aux, out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, _nest(p)), jnp.asarray(x))
    return np.asarray(out), _flat(gp), np.asarray(gx)


JAX_SHARD_MAP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_test_mesh
    from repro.models.config import ModelConfig
    from repro.models.moe import _pack_by_bucket, moe_apply_shard_map
    from repro.sharding import activate
    d = dict(np.load(sys.argv[1]))
    cfg = ModelConfig(**{cfg}, moe_capacity_factor=1.25)
    p = {{}}
    for k, v in d.items():
        if k.startswith("w:"):
            *head, last = k[2:].split("/")
            node = p
            for h in head:
                node = node.setdefault(h, {{}})
            node[last] = jnp.asarray(v)
    x = jnp.asarray(d["x_skew"])
    n, dm = x.shape[0] * x.shape[1], x.shape[2]
    e, k = cfg.num_experts, cfg.num_experts_per_token
    probs = jax.nn.softmax(jnp.einsum("nd,de->ne", x.reshape(n, dm),
                                      p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    res = {{}}
    for shape in {meshes}:
        mesh = make_test_mesh(shape, ("data", "model"))
        with activate(mesh):
            out, aux = jax.jit(lambda p, x: moe_apply_shard_map(
                p, cfg, x, mesh))(p, x)
        m, shards = shape[1], shape[0] * shape[1]
        e_loc, n_loc = e // m, n // shards
        a_loc = n_loc * k
        cap_send = max(8, -(- int(a_loc / m * 1.5) // 8) * 8)
        cap_loc = max(8, -(- int(cap_send * m / e_loc
                                 * cfg.moe_capacity_factor) // 8) * 8)
        drops, sent = 0, []
        for s in range(shards):
            flat_e = idx[s * n_loc:(s + 1) * n_loc].reshape(a_loc)
            meta = jnp.stack([flat_e % e_loc,
                              jnp.arange(a_loc, dtype=jnp.int32)], axis=1)
            _, pext, _, keep = _pack_by_bucket(
                (flat_e // e_loc).astype(jnp.int32), m, cap_send,
                jnp.zeros((a_loc, 1)), meta.astype(jnp.int32))
            drops += int((~keep).sum())
            sent.append(np.asarray(pext))
        for s in range(shards):
            row, j = divmod(s, m)
            recv = np.concatenate([sent[row * m + src][j * cap_send:
                                                       (j + 1) * cap_send]
                                   for src in range(m)])
            valid = recv[:, 0] >= 0
            le = np.where(valid, recv[:, 0], e_loc).astype(np.int32)
            _, _, _, keep_r = _pack_by_bucket(
                jnp.asarray(le), e_loc + 1, cap_loc,
                jnp.zeros((len(le), 1)), jnp.zeros((len(le), 1), jnp.int32))
            drops += int((valid & ~np.asarray(keep_r)).sum())
        res[str(shape)] = {{"drops": drops, "aux": float(aux)}}
        np.save(sys.argv[1] + f".{{shape[0]}}x{{shape[1]}}.npy",
                np.asarray(out))
    print("RESULT " + __import__("json").dumps(res))
""").format(cfg=repr(SMALL), meshes=repr(MESHES))


def _loss_grads(fn, p, x):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xx = torch.tensor(x, requires_grad=True)
    out, aux = fn(_nest(leaves), xx)
    (out.square().sum() + aux).backward()
    return (out.detach().numpy(),
            {k: v.grad.numpy() for k, v in leaves.items()},
            xx.grad.numpy())


def _mesh_cases(mesh, inp, rank):
    from repro_torch.sharding import activate
    res = {}
    cfg8 = ModelConfig(**SMALL, moe_capacity_factor=8.0,
                       moe_impl="shard_map")
    with activate(mesh):
        with moe.count_drops() as c:
            res["fwd"] = _loss_grads(lambda p, x: moe.moe_apply(p, cfg8, x),
                                     inp["w"], inp["x"])
        res["drops8"] = c["dropped"]
        # this rank's slice of the experts only
        local = {k: torch.from_numpy(v) for k, v in inp["w"].items()}
        local = moe.shard_experts(_nest(local), cfg8, mesh)
        local = _flat(local)
        res["local_shapes"] = {k: v.shape for k, v in local.items()}
        res["local"] = _loss_grads(lambda p, x: moe.moe_apply(p, cfg8, x),
                                   local, inp["x"])
        cfg = dataclasses.replace(cfg8, moe_capacity_factor=1.25)
        with moe.count_drops() as c:
            out, aux = moe.moe_apply(
                _nest({k: torch.from_numpy(v) for k, v in inp["w"].items()}),
                cfg, torch.from_numpy(inp["x_skew"]))
        res["skew"] = (out.numpy(), float(aux), c["dropped"])
    return res


def _dispatch_cases(mesh):
    """Which path ``moe_apply`` takes: (shard_map calls, gspmd calls)."""
    from repro_torch.sharding import activate
    calls = {"shard_map": 0, "gspmd": 0}
    sm, gs = moe.moe_apply_shard_map, moe.moe_apply_gspmd

    def spy_sm(*a):
        calls["shard_map"] += 1
        return sm(*a)

    def spy_gs(*a):
        calls["gspmd"] += 1
        return gs(*a)

    moe.moe_apply_shard_map, moe.moe_apply_gspmd = spy_sm, spy_gs
    out = {}
    try:
        cfg = ModelConfig(**SMALL, moe_impl="shard_map")
        p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
        x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(2))

        def run(name, cfg, x, mesh_on=True):
            calls.update(shard_map=0, gspmd=0)
            if mesh_on:
                with activate(mesh):
                    moe.moe_apply(p, cfg, x)
            else:
                moe.moe_apply(p, cfg, x)
            out[name] = dict(calls)

        run("no_mesh", cfg, x, mesh_on=False)
        run("gspmd_impl", dataclasses.replace(cfg, moe_impl="gspmd"), x)
        run("split", cfg, x)
        cfg6 = dataclasses.replace(cfg, num_experts=6)
        p6 = moe.init_moe(torch.Generator().manual_seed(0), cfg6)
        calls.update(shard_map=0, gspmd=0)
        with activate(mesh):
            moe.moe_apply(p6, cfg6, x)
        out["experts_not_split"] = dict(calls)
        run("tokens_not_split", cfg, x[:1, :3])
    finally:
        moe.moe_apply_shard_map, moe.moe_apply_gspmd = sm, gs
    return out


def _train_case(mesh):
    """One train step of the qwen3-moe smoke config (fp32 compute, lr > 0)
    on the mesh and without it: (loss, new state leaves) each."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import model_api
    from repro_torch.sharding import activate
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import tree_leaves
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32", moe_impl="shard_map",
                              moe_capacity_factor=8.0)
    api = model_api(cfg)
    params = api.init(torch.Generator().manual_seed(3))
    hyper = loop.TrainHyper()
    rng = np.random.default_rng(4)
    tok = rng.integers(1, cfg.vocab_size, (2, 9))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "labels": tok[:, 1:].astype(np.int32),
             "loss_mask": np.ones((2, 8), np.float32)}
    out = {}
    for name, on in (("mesh", True), ("plain", False)):
        state = loop.init_train_state(
            {k: v for k, v in params.items()}, hyper)
        state = state._replace(opt=state.opt._replace(
            step=torch.tensor(10, dtype=torch.int32)))
        step = loop.make_train_step(api, hyper)
        if on:
            with activate(mesh), moe.count_drops() as drops:
                new, metrics = step(state, batch)
            out["drops"] = drops["dropped"]
        else:
            new, metrics = step(state, batch)
        out[name] = (float(metrics["loss"]),
                     [t.numpy().copy() for t in tree_leaves(new)])
    return out


def _serve_case(mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models.api import model_api
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding import activate
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              moe_impl="shard_map", moe_capacity_factor=8.0)
    args = serve_launch.parser().parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--requests", "6", "--max-new", "5", "--slots", "4",
         "--max-seq", "64"])
    out = {}
    with activate(mesh), moe.count_drops() as drops:
        eng, _ = serve_launch.serve_tokens(args, cfg=cfg)
    out["drops"] = drops["dropped"]
    out["mesh"] = ({r.uid: r.generated for r in eng.finished},
                   eng.wave_log)
    eng, _ = serve_launch.serve_tokens(args, cfg=cfg)
    out["plain"] = ({r.uid: r.generated for r in eng.finished},
                    eng.wave_log)
    # each rank holding its slice of the experts
    api = model_api(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 10, 5)]
    for name, on in (("sliced", True), ("whole", False)):
        p = moe.shard_experts(params, cfg, mesh) if on else params
        eng = ServeEngine(api, p, slots=4, max_seq=64, device="cpu")
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=4))
        if on:
            with activate(mesh):
                eng.run_until_done()
        else:
            eng.run_until_done()
        out[name] = ({r.uid: r.generated for r in eng.finished},
                     eng.wave_log)
        if on:
            out["sliced_shape"] = tuple(
                p["blocks"]["pos0"]["moe"]["wi_gate"].shape)
    return out


def _worker(rank: int, port: int, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    d = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    inp = {"w": {k[2:]: v for k, v in d.items() if k.startswith("w:")},
           "x": d["x"], "x_skew": d["x_skew"]}
    res = {"rank": rank}
    try:
        for shape in MESHES:
            mesh = make_test_mesh(shape, ("data", "model"))
            res[shape] = _mesh_cases(mesh, inp, rank)
            res[shape]["coords"] = tuple(mesh.get_coordinate())
        mesh = make_test_mesh((2, 2), ("data", "model"))
        res["dispatch"] = _dispatch_cases(mesh)
        res["dispatch_1x4"] = _dispatch_cases(
            make_test_mesh((1, 4), ("data", "model")))
        res["train"] = _train_case(mesh)
        res["serve"] = _serve_case(mesh)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    p, x, skew = _inputs()
    path = str(out / "inputs.npz")
    np.savez(path, x=x, x_skew=skew, **{f"w:{k}": v for k, v in p.items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    jax_job = subprocess.Popen([sys.executable, "-c", JAX_SHARD_MAP, path],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    ref = _jax_reference(p, x)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, str(out)), nprocs=WORLD, join=True)
    stdout, stderr = jax_job.communicate(timeout=300)
    assert jax_job.returncode == 0, stderr[-2000:]
    line = [l for l in stdout.splitlines() if l.startswith("RESULT")][0]
    sm = json.loads(line[len("RESULT "):])
    for shape in MESHES:
        sm[str(shape)]["out"] = np.load(f"{path}.{shape[0]}x{shape[1]}.npy")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return SimpleNamespace(ranks=ranks, ref=ref, shard_map=sm, w=p)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_forward_and_every_gradient_equal_jax_gspmd(job, shape):
    ref_out, ref_g, ref_gx = job.ref
    for r in job.ranks:
        out, g, gx = r[shape]["fwd"]
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-5)
        assert set(g) == set(ref_g) and "shared/wo" in g
        for k in g:
            np.testing.assert_allclose(g[k], ref_g[k], rtol=0, atol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(gx, ref_gx, rtol=0, atol=1e-3)
        assert r[shape]["drops8"] == 0


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_a_ranks_slice_of_the_experts_gives_the_same(job, shape):
    ref_out, ref_g, ref_gx = job.ref
    m = shape[1]
    e_loc = SMALL["num_experts"] // m
    for r in job.ranks:
        j = r[shape]["coords"][1]
        assert r[shape]["local_shapes"]["wi_gate"] == (e_loc, 32, 24)
        out, g, gx = r[shape]["local"]
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-5)
        for k in g:
            want = ref_g[k]
            if k in moe.EXPERT_LEAVES:
                want = want[j * e_loc:(j + 1) * e_loc]
            np.testing.assert_allclose(g[k], want, rtol=0, atol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(gx, ref_gx, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_factor_1_25_equals_jax_shard_map_with_its_drops(job, shape):
    want = job.shard_map[str(shape)]
    assert want["drops"] > 0
    drops = sum(r[shape]["skew"][2] for r in job.ranks)
    assert drops == want["drops"]
    for r in job.ranks:
        out, aux, _ = r[shape]["skew"]
        np.testing.assert_allclose(out, want["out"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(aux, want["aux"], rtol=1e-6)


@pytest.mark.parametrize("which", ["dispatch", "dispatch_1x4"])
def test_gspmd_only_by_the_reference_rules(job, which):
    for r in job.ranks:
        d = r[which]
        assert d["no_mesh"] == {"shard_map": 0, "gspmd": 1}
        assert d["gspmd_impl"] == {"shard_map": 0, "gspmd": 1}
        assert d["split"] == {"shard_map": 1, "gspmd": 0}
        # 6 experts over a "model" axis of 2 splits; over 4 it does not
        want = ({"shard_map": 1, "gspmd": 0} if which == "dispatch"
                else {"shard_map": 0, "gspmd": 1})
        assert d["experts_not_split"] == want
        # 3 tokens over 4 ranks: shard_map takes the GSPMD path itself
        assert d["tokens_not_split"] == {"shard_map": 1, "gspmd": 1}


def test_train_step_on_the_mesh_equals_the_meshless_step(job):
    assert sum(r["train"]["drops"] for r in job.ranks) == 0
    for r in job.ranks:
        (loss, leaves), (want_loss, want) = (r["train"]["mesh"],
                                             r["train"]["plain"])
        assert len(leaves) > 20
        assert abs(loss - want_loss) <= 1e-5
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_serving_on_the_mesh_equals_the_meshless_engine(job):
    assert sum(r["serve"]["drops"] for r in job.ranks) == 0
    for r in job.ranks:
        s = r["serve"]
        assert s["mesh"] == s["plain"]
        assert len(s["plain"][0]) == 6 and len(s["plain"][1]) >= 2
        assert s["sliced"] == s["whole"]
        assert s["sliced_shape"][:2] == (2, 4)
