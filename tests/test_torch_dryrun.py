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
    rec = json.loads(out.read_text().splitlines()[1])
    assert rec["mesh"] == "pod2x16x16" and "peak_bytes_per_device" in rec
    assert "flops_per_device" not in rec   # FLOPs on single-pod cells
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k",
                        "--no-trace", "--out", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[2])
    assert rec["status"] == "ok" and not {"flops_per_device",
                                          "peak_bytes_per_device"} & set(rec)


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


READINGS = ("peak_bytes_per_device", "temp_bytes_per_device",
            "output_bytes_per_device")


def _one_super_block(cfg):
    """``cfg`` cut to one super-block (an encoder-decoder's encoder in
    proportion)."""
    from dataclasses import replace

    from repro_torch.models.transformer import superblock_period
    period = superblock_period(cfg)
    over = {"num_layers": period}
    if cfg.is_encoder_decoder:
        over["num_encoder_layers"] = max(
            1, cfg.num_encoder_layers * period // cfg.num_layers)
    return replace(cfg, **over)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_ok_cell_carries_the_readings_in_the_jax_record_shape(
        arch, monkeypatch):
    """Each ok cell records the JAX keys of XLA's readings: the memory
    readings and ``collectives`` shaped as ``parse_collectives``' record
    (here of rank 0's program cut to one super-block and with the FLOPs
    trace left out, for time: the whole sweep's traces take ~11 min)."""
    from repro.launch.dryrun import parse_collectives
    shape = parse_collectives("")
    program = dryrun.rank_program
    monkeypatch.setattr(dryrun, "rank_program", lambda cfg, *a, **k: program(
        _one_super_block(cfg), *a, **k))
    monkeypatch.setattr(dryrun, "trace_flops", lambda step, args: 0.0)
    for shape_name in SHAPES:
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, shape_name, multi_pod)
            if rec["status"] == "skipped":
                assert not set(READINGS) & set(rec)
                continue
            assert rec["status"] == "ok", rec.get("error")
            for k in READINGS:
                assert isinstance(rec[k], int) and rec[k] >= 0, k
            assert rec["peak_bytes_per_device"] >= rec[
                "output_bytes_per_device"] + rec["temp_bytes_per_device"]
            coll = rec["collectives"]
            assert set(coll) == set(shape)
            for op in dryrun.COLLECTIVE_OPS:
                assert set(coll[op]) == set(shape[op])
            assert coll["total_count"] == sum(coll[op]["count"] for op in
                                              dryrun.COLLECTIVE_OPS) > 0
            assert coll["total_operand_bytes"] == sum(
                coll[op]["operand_bytes"] for op in dryrun.COLLECTIVE_OPS)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
def test_full_depth_readings_hold_arguments_and_outputs(shape_name):
    """At the config's full depth the tracker's peak is at least the
    arguments plus the outputs, temp is what is left of it, and the
    readings come with the FLOPs trace."""
    step, args, mesh, cfg, rules = dryrun.build_cell("mamba2-130m",
                                                     shape_name, False)
    got = dryrun.trace_readings(*dryrun.rank_program(
        cfg, SHAPES[shape_name], mesh, rules))
    held, out = got["argument_bytes_traced"], got["output_bytes_per_device"]
    assert held > 0 and out > 0
    assert got["peak_bytes_per_device"] >= held + out
    assert got["temp_bytes_per_device"] == got["peak_bytes_per_device"] \
        - held - out
    rec = dryrun.run_cell("mamba2-130m", shape_name, False)
    assert {k: rec[k] for k in READINGS} == {k: got[k] for k in READINGS}
    assert rec["flops_per_device"] > 0


def test_a_kernel_op_counts_what_the_kernel_allocates():
    """On meta tensors the flash and SSD ops run their plain versions,
    and the tracker counts what the kernels allocate on the card (their
    outputs, the scan's workspace), not a materialised score matrix or
    the chunked scan's decay matrices."""
    from repro_torch import memory
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, workspace_floats
    q = torch.empty(2, 1024, 8, 64, device="meta")
    with memory.LiveBytes() as mem:
        mem.hold(q)
        out = flash_attention(q, q, q)
        assert mem.live == 2 * q.nbytes
    assert mem.peak == 2 * q.nbytes < 2 * 8 * 1024 * 1024 * 4
    assert out.shape == q.shape
    u = torch.empty(2, 512, 4, 16, device="meta")
    a = torch.empty(2, 512, 4, device="meta")
    bm = torch.empty(2, 512, 32, device="meta")
    with memory.LiveBytes() as mem:
        inputs = mem.hold((u, a, bm))
        y, state = ssd_scan(u, a, bm, bm, chunk=128)
        outputs = mem.bytes_of((y, state))
    assert outputs == u.nbytes + 2 * 4 * 32 * 16 * 4
    assert mem.peak == inputs + outputs + memory.rounded(
        4 * workspace_floats(2, 512, 4, 16, 32, 128))
    assert workspace_floats(2, 512, 4, 16, 32, 128) == (
        2 * 4 * 4 * 128 + 2 * 4 * 4 * 32 * 16 * 2)


def test_allocations_round_as_the_caching_allocator_counts():
    from repro_torch import memory
    assert [memory.rounded(n) for n in (0, 1, 512, 513, 4096)] == \
        [0, 512, 512, 1024, 4096]
    with memory.LiveBytes() as mem:
        x = torch.empty(3, device="meta")
        y = x.view(3, 1)             # a view adds nothing
        x.add_(1.0)                  # nor does an in-place op
        assert mem.live == 512
        del x, y
        assert mem.live == 0
    assert mem.peak == 512
