"""The port's logical-axis partitioning (``repro_torch.sharding``), shape
cells (``configs/shapes.py``) and boxed trees against the JAX package's.

Every comparison is exact: specs, shapes, dtypes, axes and per-device
bytes.  The JAX side builds its boxed trees with ``jax.eval_shape`` and
its specs with ``tree_shardings`` on ``abstract_mesh``: nothing is
compiled or allocated on either side.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro.models.api import model_api as jax_model_api
from repro.serve import engine as jax_engine  # noqa: F401  (the dry run's)
from repro.sharding import partition as JP
from repro.sharding import abstract_mesh as jax_abstract_mesh
from repro.train import loop as jax_loop
from repro_torch.configs import get_config
from repro_torch.configs import shapes as S
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models.api import model_api
from repro_torch.sharding import partition as P
from repro_torch.train import loop
from repro_torch.train.checkpoint import _flatten_with_names

RULES = {"default": "DEFAULT_RULES", "decode": "DECODE_RULES",
         "platform": "PLATFORM_RULES"}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4-routes": ((4,), ("routes",))}
NAMES = sorted({n for t in RULES.values() for n, _ in getattr(P, t)})

# per-device argument GiB on the 16 x 16 mesh: train_4k (state + batch),
# decode_32k (bf16 parameters + cache, DECODE_RULES)
TABLE_GIB = {
    "h2o-danube-3-4b": (0.29, 0.64), "mistral-large-123b": (6.80, 6.73),
    "minicpm3-4b": (3.75, 1.66), "stablelm-1.6b": (0.20, 3.08),
    "jamba-v0.1-52b": (2.27, 0.71), "mamba2-130m": (0.04, 0.22),
    "internvl2-76b": (4.10, 5.89), "moonshot-v1-16b-a3b": (1.49, 6.33),
    "qwen3-moe-30b-a3b": (1.36, 1.07), "seamless-m4t-medium": (0.42, 1.92)}


def jax_spec(spec) -> tuple:
    return tuple(spec)


def both_meshes(name):
    shape, axes = MESHES[name]
    return jax_abstract_mesh(shape, axes), P.abstract_mesh(shape, axes)


# ---------------------------------------------------------------------------
# Param, unbox, boxed_axes
# ---------------------------------------------------------------------------

class Pair(NamedTuple):
    a: object
    b: object


def test_param_unbox_and_boxed_axes_as_jax():
    t = torch.zeros(2, 3)
    tree = {"w": P.Param(t, ("embed", "mlp")), "n": 7,
            "c": Pair(P.Param(torch.ones(4), ("layers",)), None)}
    box = tree["w"]
    assert P.is_param(box) and not P.is_param(t)
    assert box.shape == (2, 3) and box.dtype == torch.float32
    plain = P.unbox(tree)
    assert plain["w"] is t and plain["n"] == 7 and plain["c"].b is None
    assert torch.equal(plain["c"].a, torch.ones(4))
    axes = P.boxed_axes(tree)
    assert axes == {"w": ("embed", "mlp"), "n": None,
                    "c": Pair(("layers",), None)}

    jtree = {"w": JP.Param(jnp.zeros((2, 3)), ("embed", "mlp")), "n": 7,
             "c": Pair(JP.Param(jnp.ones(4), ("layers",)), None)}
    assert JP.boxed_axes(jtree) == axes


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def test_rule_tables_equal_jax():
    for table in RULES.values():
        assert getattr(P, table) == getattr(JP, table), table
    assert P._DECODE_OVERRIDES == JP._DECODE_OVERRIDES


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
def test_logical_to_mesh_axes_as_jax(rules, mesh_name):
    jmesh, tmesh = both_meshes(mesh_name)
    table_j, table_t = getattr(JP, RULES[rules]), getattr(P, RULES[rules])
    combos = ([(n,) for n in NAMES] + list(itertools.permutations(NAMES, 2))
              + [(None, "embed", "mlp"), ("batch", "seq", "vocab")])
    checked = 0
    for axes in combos:
        try:
            want = jax_spec(JP.logical_to_mesh_axes(axes, table_j, jmesh))
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                P.logical_to_mesh_axes(axes, table_t, tmesh)
            assert str(got.value) == str(e)
            continue
        assert P.logical_to_mesh_axes(axes, table_t, tmesh) == want, axes
        checked += 1
    assert checked > len(NAMES)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_divisible_as_jax(mesh_name):
    jmesh, tmesh = both_meshes(mesh_name)
    names = tuple(jmesh.axis_names)
    entries = [None] + list(names) + [
        tuple(c) for r in (2, 3) for c in itertools.permutations(names, r)]
    for dim in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 512, 1000):
        for entry in entries:
            spec = (entry, None)
            want = jax_spec(JP._divisible((dim, 5), JP.P(*spec), jmesh))
            assert P._divisible((dim, 5), spec, tmesh) == want, (dim, entry)


def test_unknown_axis_raises_the_jax_text():
    with pytest.raises(ValueError, match="no partition rule for logical "
                                         "axis 'nope'"):
        P.logical_to_mesh_axes(("nope",), P.DEFAULT_RULES,
                               make_production_mesh())


def test_with_logical_constraint_resolves_and_keeps_x():
    x = torch.arange(12.0).reshape(4, 3)
    assert P.with_logical_constraint(x, ("nope", None)) is x   # no mesh
    with P.activate(make_production_mesh()) as mesh:
        assert P.current_mesh_and_rules() == (mesh, P.DEFAULT_RULES)
        assert P.with_logical_constraint(x, ("batch", None)) is x
        with pytest.raises(ValueError, match="no partition rule"):
            P.with_logical_constraint(x, ("nope", None))
    assert P.current_mesh_and_rules() is None


def test_local_shape_splits_each_dim_by_its_axes():
    mesh = make_production_mesh(multi_pod=True)
    assert P.local_shape((64, 32, 7), (("pod", "data"), "model", None),
                         mesh) == (2, 2, 7)
    with pytest.raises(ValueError):
        P.local_shape((3,), ("model",), mesh)


# ---------------------------------------------------------------------------
# Boxed trees, specs and bytes of every arch
# ---------------------------------------------------------------------------

def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=JP.is_param)
    return [("/".join(str(k) for k in path), x) for path, x in flat]


def torch_leaves(tree):
    names, leaves, _ = _flatten_with_names(tree)
    return list(zip(names, leaves))


def describe(leaves, dtype_name):
    return [(n, tuple(x.value.shape), dtype_name(x.value.dtype), x.axes)
            for n, x in leaves]


def same_boxes(jtree, ttree):
    want = describe(jax_leaves(jtree), lambda d: np.dtype(d).name)
    got = describe(torch_leaves(ttree),
                   lambda d: str(d).replace("torch.", ""))
    assert got == want


def jax_cell_args(arch, shape_name):
    """The boxed arguments of the JAX dry run's ``build_cell`` (rules,
    args), built without a compile."""
    cfg = jax_get_config(arch)
    cell = jax_shapes.SHAPES[shape_name]
    rules = JP.DEFAULT_RULES
    if cell.step == "decode":
        rules = JP.DECODE_RULES
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    api = jax_model_api(cfg)
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    batch = jax_shapes.input_specs(cfg, shape_name)
    if cell.step == "train":
        return rules, (jax_loop.train_state_boxed(params,
                                                  jax_loop.TrainHyper()),
                       batch)
    if cell.step == "prefill":
        return rules, (params, batch)
    cache = jax.eval_shape(
        lambda: api.init_cache(cell.global_batch, cell.seq_len))
    pos = JP.Param(jax.ShapeDtypeStruct((), jnp.int32), ())
    return rules, (params, cache, batch["token"], pos)


def jax_bytes(args, rules, mesh) -> int:
    total = 0
    for a in args:
        for _, p in jax_leaves(a):
            sh = jax.sharding.NamedSharding(
                mesh, JP._divisible(p.value.shape, JP.logical_to_mesh_axes(
                    p.axes, rules, mesh), mesh))
            total += math.prod(sh.shard_shape(p.value.shape)) \
                * np.dtype(p.value.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_specs_and_bytes_equal_jax(arch):
    # parameters in both dtypes, the cache and the smoke config's trees
    for get_t, get_j in ((get_config, jax_get_config),):
        for pd in ("float32", "bfloat16"):
            cj = dataclasses.replace(get_j(arch), param_dtype=pd)
            ct = dataclasses.replace(get_t(arch), param_dtype=pd)
            same_boxes(jax.eval_shape(jax_model_api(cj).init,
                                      jax.random.PRNGKey(0)),
                       L.abstract(model_api(ct).init, torch.Generator()))
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_smoke_config
    same_boxes(jax.eval_shape(jax_model_api(jax_smoke(arch)).init,
                              jax.random.PRNGKey(0)),
               L.abstract(model_api(get_smoke_config(arch)).init,
                          torch.Generator()))
    same_boxes(jax.eval_shape(
        lambda: jax_model_api(jax_smoke(arch)).init_cache(3, 40)),
        L.abstract(model_api(get_smoke_config(arch)).init_cache, 3, 40))

    gib = {}
    for shape_name in S.SHAPES:
        for multi_pod in (False, True):
            jmesh = jax_abstract_mesh(
                *((((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))))
            rules_j, args_j = jax_cell_args(arch, shape_name)
            _, args_t, tmesh, _, rules_t = dryrun.build_cell(
                arch, shape_name, multi_pod)
            assert rules_t == rules_j
            for aj, at in zip(args_j, args_t, strict=True):
                same_boxes(aj, at)
                want = [jax_spec(s.spec) for s in jax.tree_util.tree_leaves(
                    JP.tree_shardings(aj, jmesh, rules_j),
                    is_leaf=lambda x: isinstance(
                        x, jax.sharding.NamedSharding))]
                got = [P.param_spec(p, tmesh, rules_t)
                       for _, p in torch_leaves(at)]
                assert got == want, (shape_name, multi_pod)
            got_b = sum(dryrun.argument_bytes(a, tmesh, rules_t)
                        for a in args_t)
            assert got_b == jax_bytes(args_j, rules_j, jmesh), shape_name
            if not multi_pod:
                gib[shape_name] = got_b / 2**30
    assert (round(gib["train_4k"], 2), round(gib["decode_32k"], 2)) \
        == TABLE_GIB[arch]


# ---------------------------------------------------------------------------
# Shape cells and the train state
# ---------------------------------------------------------------------------

def test_shapes_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in S.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_shapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_applicable_and_input_specs_as_jax(arch):
    for shape_name in S.SHAPES:
        assert S.cell_applicable(get_config(arch), shape_name) == \
            jax_shapes.cell_applicable(jax_get_config(arch), shape_name)
        assert S.long_context_capable(get_config(arch)) == \
            jax_shapes.long_context_capable(jax_get_config(arch))
        same_boxes(jax_shapes.input_specs(jax_get_config(arch), shape_name),
                   S.input_specs(get_config(arch), shape_name))


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_train_state_boxed_as_jax(compression):
    arch = "jamba-v0.1-52b"
    jparams = jax.eval_shape(jax_model_api(jax_get_config(arch)).init,
                             jax.random.PRNGKey(0))
    tparams = L.abstract(model_api(get_config(arch)).init, torch.Generator())
    jstate = jax_loop.train_state_boxed(
        jparams, jax_loop.TrainHyper(compression=compression))
    tstate = loop.train_state_boxed(
        tparams, loop.TrainHyper(compression=compression))
    assert (tstate.ef is None) == (compression == "none")
    same_boxes(jstate, tstate)
    assert loop.train_state_axes(tstate) == jax_loop.train_state_axes(jstate)
    step = tstate.opt.step
    assert step.axes == () and step.dtype == torch.int32 \
        and step.value.device.type == "meta"
