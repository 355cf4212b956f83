"""The port's dry run on the meta device (``repro_torch.launch.dryrun``)
against the JAX package's cells: every (arch, shape, mesh) record's
status, reason, devices, tokens, parameter counts and per-device
argument bytes; the traced FLOPs of a step on meta tensors against the
same step on real CPU tensors; the CLI."""
from __future__ import annotations

import json

import pytest
import torch
from test_torch_sharding import jax_bytes, jax_cell_args

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro.sharding import abstract_mesh as jax_abstract_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding import unbox
from repro_torch.train.checkpoint import tree_map


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_records_as_jax(arch):
    jcfg = jax_get_config(arch)
    for shape_name in SHAPES:
        cell = jax_shapes.SHAPES[shape_name]
        ok, why = jax_shapes.cell_applicable(jcfg, shape_name)
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, shape_name, multi_pod,
                                  do_probe=False)
            mesh = "pod2x16x16" if multi_pod else "pod16x16"
            assert {k: rec[k] for k in ("arch", "shape", "mesh", "rules")} \
                == {"arch": arch, "shape": shape_name, "mesh": mesh,
                    "rules": "default"}
            if not ok:
                assert rec == {"arch": arch, "shape": shape_name,
                               "mesh": mesh, "rules": "default",
                               "status": "skipped", "reason": why}
                continue
            assert rec["status"] == "ok", rec.get("error")
            jmesh = jax_abstract_mesh(
                *(((2, 16, 16), ("pod", "data", "model")) if multi_pod
                  else ((16, 16), ("data", "model"))))
            rules, args = jax_cell_args(arch, shape_name)
            assert rec["devices"] == jmesh.size
            assert rec["tokens"] == (cell.global_batch * cell.seq_len
                                     if cell.step != "decode"
                                     else cell.global_batch)
            assert rec["argument_bytes_per_device"] == jax_bytes(
                args, rules, jmesh)
            assert rec["param_count"] == jcfg.param_count()
            assert rec["active_param_count"] == jcfg.active_param_count()
            assert "flops_per_device" not in rec


def test_sweep_counts():
    recs = [dryrun.run_cell(a, s, mp, do_probe=False)
            for a in ARCH_IDS for s in SHAPES for mp in (False, True)]
    counts = {st: sum(r["status"] == st for r in recs)
              for st in ("ok", "skipped", "failed")}
    assert counts == {"ok": 66, "skipped": 14, "failed": 0}


def _real(tree, gen):
    def draw(x):
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=gen) * 0.02).to(x.dtype)
        return torch.randint(1, 50, x.shape, generator=gen).to(x.dtype)
    return tree_map(draw, tree)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_traced_flops_equal_a_real_run(arch, step):
    cfg = get_smoke_config(arch)
    cell = ShapeCell("t", 32, 2, step)
    fn, args = dryrun.cell_step(cfg, cell)
    meta = [unbox(a) for a in args]
    assert all(x.device.type == "meta" for a in meta
               for x in dryrun.tree_leaves(a))
    gen = torch.Generator().manual_seed(0)
    real = [_real(a, gen) for a in meta]
    if step == "train":
        state, batch = real
        real = [state._replace(opt=state.opt._replace(
            step=torch.zeros((), dtype=torch.int32))),
            dict(batch, loss_mask=torch.ones_like(batch["loss_mask"]))]
    flops = dryrun.trace_flops(fn, meta)
    assert flops > 0 and flops == dryrun.trace_flops(fn, real)


def test_cli_writes_one_record(tmp_path):
    out = tmp_path / "results.jsonl"
    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k",
                      "--out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["status"] == "ok"
    assert recs[0]["mesh"] == "pod16x16" and recs[0]["flops_per_device"] > 0
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                        "--multi-pod", "--out", str(out)]) == 0
    assert json.loads(out.read_text().splitlines()[1])["mesh"] \
        == "pod2x16x16"


def test_a_failed_cell_gives_rc_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("host read")
    monkeypatch.setattr(dryrun, "cell_step", broken)
    out = tmp_path / "results.jsonl"
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                        "--out", str(out)]) == 1
    rec = json.loads(out.read_text())
    assert rec["status"] == "failed" and rec["error"] == \
        "RuntimeError: host read"


def test_make_test_mesh_refuses_a_world_too_small():
    with pytest.raises(RuntimeError, match="need 4 processes"):
        make_test_mesh((2, 2), ("data", "model"))
    assert not torch.distributed.is_initialized()
