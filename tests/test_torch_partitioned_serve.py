"""The port's partitioned prefill and decode (``models.partitioned``,
reached through ``ModelAPI.prefill`` / ``decode_step`` and
``serve.engine.make_serve_step`` on ``DTensor`` parameters) against its
meshless engine and the JAX package's single-device steps, and the dry
run's shape-only collectives against the ones a gloo job dispatches.

One gloo job of four processes (``torch.multiprocessing.spawn``, a free
localhost port) builds a (2, 2) ``("data", "model")`` mesh and runs, at
the fp32 smoke configs with 8-token prompts, batch 4 and a 16-position
decode cache (so the new tokens' positions fall in the second "kv_seq"
block and the first block is only read):

* for ``h2o-danube-3-4b``, ``mamba2-130m``, ``qwen3-moe-30b-a3b``,
  ``minicpm3-4b``, ``jamba-v0.1-52b`` and ``seamless-m4t-medium``
  (seeded N(0, 1) source frames): the prefill with the parameters placed
  under ``DEFAULT_RULES``, its cache padded to the decode length and
  placed under ``DECODE_RULES``, then 4 greedy ``make_serve_step``
  steps with the parameters placed under ``DECODE_RULES``, against the
  meshless prefill, ``ServeEngine._merge_cache`` and the same steps:
  tokens equal; the logits and every cache block (after the prefill and
  after the steps) within 1e-5 of the leaf's largest entry; each rank's
  block shapes equal ``local_shape`` of its spec; a decode step's wire
  bytes (``distributed.count_wire``) below one super-block's weight
  bytes a rank, so no weight is gathered;
* qwen3-moe's smoke config in its bf16 compute with bf16 parameters
  (``param_dtype``, as the JAX ``build_cell`` sets them for decode), so
  the partial sums, maxima and looked-up rows cross the gloo group in
  bf16: the same run against the meshless engine in the same dtypes at
  the LM tests' bf16 gate (5e-2 of the largest entry; tokens equal
  until a step whose meshless top-2 margin is inside the gate, the
  later steps following other histories);
* danube (GQA), mamba2-130m (Mamba), minicpm3-4b (MLA) and
  qwen3-moe-30b-a3b (MoE) on the JAX package's init (carried across):
  the partitioned prefill and 4 steps against the JAX ``api.prefill``,
  the JAX engine's ``_merge_cache`` and ``make_serve_step``, jitted in
  the parent meanwhile, at ``tests/test_torch_serve_tokens.py``'s
  tolerances (logits 1e-4; tokens equal unless the JAX top-2 margin is
  a tie);
* each rank's collectives of danube's train step, prefill and decode
  step, counted by op (count, operand and output bytes), equal to what
  ``launch.dryrun.rank_program`` of the same cells dispatches
  shape-only on an abstract (2, 2) mesh at that rank's coordinate;
* ``DTensor``'s own offsets of the blocks of ``DECODE_RULES``'
  out-of-order entries equal ``sharding.block_of``'s, and
  ``sharding_of`` gives the spec back.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
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
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import make_serve_step as jax_serve_step
from repro.sharding import unbox
from repro_torch.sharding import partition as P

WORLD = 4
MESH = (2, 2)
AXES = ("data", "model")
B, S, MAX, STEPS = 4, 8, 16, 4
DANUBE = "h2o-danube-3-4b"
ARCHS = (DANUBE, "mamba2-130m", "qwen3-moe-30b-a3b", "minicpm3-4b",
         "jamba-v0.1-52b", "seamless-m4t-medium")
JAX_ARCHS = (DANUBE, "mamba2-130m", "minicpm3-4b", "qwen3-moe-30b-a3b")
BF16 = "qwen3-moe-30b-a3b"
REL = 1e-5
BF16_REL = 5e-2


def _cfg(arch, bf16: bool = False):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if bf16:
        return dataclasses.replace(cfg, dtype="bfloat16",
                                   param_dtype="bfloat16")
    return dataclasses.replace(cfg, dtype="float32")


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        out["frontend_embeds"] = rng.standard_normal(
            (B, MAX // cfg.encoder_seq_ratio, cfg.d_model)).astype(
                np.float32)
    return out


def _rel(a, b) -> float:
    a, b = (np.asarray(x.double() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# The gloo job
# ---------------------------------------------------------------------------

def _place(tree, boxed, mesh, rules):
    return P.place(tree, P.tree_named_shardings(boxed, mesh, rules))


def _blocks_against(tree, whole) -> tuple:
    """(largest error of this rank's blocks of ``tree``'s leaves against
    the same blocks of ``whole``'s, relative to each whole leaf's
    largest entry; whether each block's shape is ``local_shape`` of its
    spec)."""
    from repro_torch.train.checkpoint import tree_leaves
    err, shapes = 0.0, True
    for x, w in zip(tree_leaves(tree), tree_leaves(whole)):
        sh = P.sharding_of(x)
        err = max(err, _rel(x.to_local(), P.block_of(w, sh)))
        shapes &= tuple(x.to_local().shape) == P.local_shape(
            tuple(w.shape), sh.spec, sh.mesh)
    return err, shapes


def _serve(arch, mesh, params=None, bf16: bool = False):
    """The partitioned prefill and decode of ``arch`` against the
    meshless ones (both on this rank)."""
    from repro_torch import distributed as pdist
    from repro_torch.models import layers as L
    from repro_torch.models import partitioned as PT
    from repro_torch.models.api import model_api
    from repro_torch.serve.engine import ServeEngine, make_serve_step
    from repro_torch.train.checkpoint import tree_leaves
    cfg = _cfg(arch, bf16)
    api = model_api(cfg)
    if params is None:
        params = api.init(torch.Generator().manual_seed(3))
    batch = _batch(cfg, 11)
    boxed = L.abstract(api.init, torch.Generator())
    step = make_serve_step(api)
    out = {}
    with torch.no_grad():
        want_l, want_c = api.prefill(params, {k: torch.as_tensor(v)
                                              for k, v in batch.items()})
        want_c = ServeEngine(api, params, slots=B, max_seq=MAX,
                             device="cpu")._merge_cache(want_c)
        # the prefill's cache padded to the decode length, placed as the
        # decode step reads it (ServeEngine's merge, with no gather)
        logits, cache = PT.prefill(
            cfg, _place(params, boxed, mesh, P.DEFAULT_RULES), batch,
            cache_len=MAX)
        out["logits_spec"] = P.sharding_of(logits).spec
        out["prefill"] = _rel(logits.to_local(),
                              P.block_of(want_l, P.sharding_of(logits)))
        out["prefill_cache"] = _blocks_against(cache, want_c)
        whole = P.full_tensor(logits)
        out["prefill_whole"] = whole.float().numpy().copy()
        placed = _place(params, boxed, mesh, P.DECODE_RULES)
        tok = tok_w = whole[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out["tokens"], out["want_tokens"], out["errs"] = [], [], []
        out["wire"], out["logits"], out["want_logits"] = [], [], []
        for i in range(STEPS):
            tok_w, lw, want_c = step(params, want_c, tok_w, S + i)
            with pdist.count_wire() as wire:
                tok, lg, cache = step(placed, cache, tok, S + i)
            out["wire"].append(wire["bytes"])
            out["errs"].append(_rel(lg, lw))
            out["logits"].append(lg.float().numpy().copy())
            out["want_logits"].append(lw.float().numpy().copy())
            out["tokens"].append(tok[:, 0].tolist())
            out["want_tokens"].append(tok_w[:, 0].tolist())
        out["decode_cache"] = _blocks_against(cache, want_c)
        key = "dec_blocks" if cfg.is_encoder_decoder else "blocks"
        out["superblock_bytes"] = sum(
            x.to_local()[0].numel() * x.element_size()
            for x in tree_leaves(placed[key]))
    return out


def _collectives(mesh, coord):
    """This rank's collectives of danube's train step, prefill and decode
    step, dispatched and shape-only."""
    from repro_torch import distributed as pdist
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L
    from repro_torch.models import partitioned as PT
    from repro_torch.models.api import model_api
    from repro_torch.train import loop
    cfg = _cfg(DANUBE)
    api = model_api(cfg)
    params = api.init(torch.Generator().manual_seed(5))
    boxed = L.abstract(api.init, torch.Generator())
    abstract = P.abstract_mesh(MESH, AXES, coord)
    out = {}
    for step in ("train", "prefill", "decode"):
        cell = ShapeCell("t", 16, B, step)
        rules = P.DECODE_RULES if step == "decode" else P.DEFAULT_RULES
        batch = {k: torch.ones(v.shape, dtype=v.dtype) for k, v in
                 unbox(dryrun.train_batch_specs(cfg, cell)).items()}
        with pdist.count_wire() as real, torch.no_grad():
            if step == "train":
                hyper = loop.TrainHyper()
                state = P.place(loop.init_train_state(params, hyper),
                                P.tree_named_shardings(
                                    loop.train_state_boxed(boxed, hyper),
                                    mesh))
                loop.make_train_step(api, hyper)(state, batch)
            elif step == "prefill":
                PT.prefill(cfg, _place(params, boxed, mesh, rules), batch)
            else:
                cache = _place(api.init_cache(B, 16),
                               L.abstract(api.init_cache, B, 16), mesh,
                               rules)
                PT.decode_step(cfg, _place(params, boxed, mesh, rules),
                               cache, torch.ones(B, 1, dtype=torch.int32), 0)
        got = dryrun.trace_readings(*dryrun.rank_program(cfg, cell, abstract,
                                                         rules))
        out[step] = (dryrun.collectives_record(real["ops"]),
                     got["collectives"])
    return out


def _offsets(mesh):
    """(spec, DTensor's offset, block_of's offset) of DECODE_RULES'
    out-of-order leaves of danube's parameters."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.models import layers as L
    from repro_torch.models.api import model_api
    from repro_torch.train.checkpoint import tree_leaves
    api = model_api(_cfg(DANUBE))
    boxed = L.abstract(api.init, torch.Generator())
    out = []
    for box, sh in zip(tree_leaves(boxed), tree_leaves(
            P.tree_named_shardings(boxed, mesh, P.DECODE_RULES))):
        if not any(isinstance(e, tuple) and list(e) != sorted(
                e, key=AXES.index) for e in sh.spec):
            continue
        shape = tuple(box.shape)
        x = torch.arange(int(np.prod(shape))).reshape(shape)
        block = P.block_of(x, sh)
        _, offset = compute_local_shape_and_global_offset(
            shape, mesh, sh.placements)
        placed = P.from_local(block, sh)
        out.append((sh.spec, P.sharding_of(placed).spec, tuple(offset),
                    tuple(int(i) for i in np.unravel_index(
                        int(block.flatten()[0]), shape))))
    return out


def _worker(rank: int, port: int, work: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import lm_params_from_numpy
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    res = {"rank": rank}
    try:
        mesh = make_test_mesh(MESH, AXES)
        coord = tuple(mesh.get_coordinate())
        res["coords"] = coord
        res["serve"] = {a: _serve(a, mesh) for a in ARCHS}
        res["bf16"] = _serve(BF16, mesh, bf16=True)
        with open(os.path.join(work, "jax_params.pkl"), "rb") as f:
            trees = pickle.load(f)
        res["jax"] = {a: _serve(a, mesh, lm_params_from_numpy(trees[a], "cpu"))
                      for a in JAX_ARCHS}
        res["collectives"] = _collectives(mesh, coord)
        res["offsets"] = _offsets(mesh)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))


def _jax_run(work: str):
    """The JAX package's smoke params (fp32) of ``JAX_ARCHS``, saved for
    the job, and a function that runs their prefills and steps:
    {arch: (prefill logits, [(tokens, logits)])}."""
    models = {}
    for arch in JAX_ARCHS:
        cfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        api = jax_model_api(cfg)
        models[arch] = (cfg, api, jax.jit(lambda k, api=api: unbox(
            api.init(k)))(jax.random.PRNGKey(0)))
    with open(os.path.join(work, "jax_params.pkl"), "wb") as f:
        pickle.dump({a: jax.tree_util.tree_map(np.asarray, m[2])
                     for a, m in models.items()}, f)

    def one(cfg, api, params):
        batch = _batch(cfg, 11)
        logits, cache = jax.jit(api.prefill)(params, batch)
        cache = JaxServeEngine(api, params, slots=B,
                               max_seq=MAX)._merge_cache(cache)
        step = jax.jit(jax_serve_step(api))
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        steps = []
        for i in range(STEPS):
            tok, lg, cache = step(params, cache, tok, S + i)
            steps.append((np.asarray(tok)[:, 0].tolist(), np.asarray(lg)))
        return np.asarray(logits), steps
    return lambda: {a: one(*m) for a, m in models.items()}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("partitioned_serve"))
    jax_run = _jax_run(work)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.spawn(_worker, args=(port, work), nprocs=WORLD, join=False)
    jax_res = jax_run()
    while not ctx.join():
        pass
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return SimpleNamespace(ranks=ranks, jax=jax_res)


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_prefill_and_decode_equal_the_meshless_engine(job, arch):
    for r in job.ranks:
        got = r["serve"][arch]
        assert got["logits_spec"] == ("data", None, None)
        assert got["prefill"] <= REL, got["prefill"]
        err, shapes = got["prefill_cache"]
        assert err <= REL and shapes, (r["rank"], err)
        assert got["tokens"] == got["want_tokens"]
        assert max(got["errs"]) <= REL, got["errs"]
        err, shapes = got["decode_cache"]
        assert err <= REL and shapes, (r["rank"], err)
        # the new tokens' positions 8..11 lie in the second kv_seq block
        assert got["tokens"] == job.ranks[0]["serve"][arch]["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_moves_activations_not_weights(job, arch):
    for r in job.ranks:
        got = r["serve"][arch]
        assert all(0 < w < got["superblock_bytes"] for w in got["wire"]), \
            (arch, got["wire"], got["superblock_bytes"])


def _against_jax(job, arch):
    jax_logits, jax_steps = job.jax[arch]
    for r in job.ranks:
        got = r["jax"][arch]
        np.testing.assert_allclose(got["prefill_whole"], jax_logits,
                                   rtol=1e-4, atol=1e-4)
        for k, ((tok_j, lg_j), tok, lg) in enumerate(zip(
                jax_steps, got["tokens"], got["logits"])):
            np.testing.assert_allclose(lg, lg_j, rtol=1e-4, atol=1e-4)
            if tok != tok_j:
                # a tie broken by fp32 rounding; later steps differ
                row = [i for i, (a, b) in enumerate(zip(tok, tok_j))
                       if a != b][0]
                top2 = np.sort(lg_j[row, -1])[-2:]
                assert top2[1] - top2[0] < 1e-5, (k, tok, tok_j)
                break


def test_partitioned_danube_equals_the_jax_single_device_steps(job):
    _against_jax(job, DANUBE)


@pytest.mark.parametrize("arch", JAX_ARCHS[1:])
def test_partitioned_steps_equal_the_jax_single_device_steps(job, arch):
    """The Mamba, MLA and MoE decodes held to the JAX package as well as
    to the meshless engine."""
    _against_jax(job, arch)


def test_bf16_partitioned_prefill_and_decode_equal_the_meshless_engine(job):
    """bf16 parameters and compute: the split contractions' partial sums,
    the flash-decoding maxima and sums and the vocabulary-split rows
    cross the group in bf16."""
    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    for r in job.ranks:
        got = r["bf16"]
        assert got["prefill"] <= BF16_REL, got["prefill"]
        err, shapes = got["prefill_cache"]
        assert err <= BF16_REL and shapes, (r["rank"], err)
        assert all(0 < w < got["superblock_bytes"] for w in got["wire"])
        for k, (tok, tok_w, lg, lw) in enumerate(zip(
                got["tokens"], got["want_tokens"], got["logits"],
                got["want_logits"])):
            assert rel(lg, lw) <= BF16_REL, (k, rel(lg, lw))
            if tok != tok_w:
                # a near-tie that bf16 rounding breaks either way; the
                # later steps follow other histories
                row = [i for i, (a, b) in enumerate(zip(tok, tok_w))
                       if a != b][0]
                top2 = np.sort(lw[row, -1])[-2:]
                assert top2[1] - top2[0] <= BF16_REL * np.abs(lw).max(), \
                    (k, tok, tok_w)
                break
        else:
            err, shapes = got["decode_cache"]
            assert err <= BF16_REL and shapes, (r["rank"], err)


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_shape_only_collectives_equal_the_dispatched_ones(job, step):
    for r in job.ranks:
        real, shape_only = r["collectives"][step]
        assert real["total_count"] > 0
        assert shape_only == real, (r["rank"], step)


def test_out_of_order_entries_place_as_dtensor_reads_them(job):
    for r in job.ranks:
        assert len(r["offsets"]) >= 3
        for spec, back, dtensor_offset, our_offset in r["offsets"]:
            assert back == spec
            assert dtensor_offset == our_offset, (spec, r["coords"])
