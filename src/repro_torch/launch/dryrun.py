"""Dry run of every (arch x shape x mesh) cell on the meta device, the port
of the JAX package's ``launch/dryrun.py``.

For each cell this builds the boxed inputs on the meta device (the state
or parameters, the batch or the cache: shapes, dtypes and logical axes,
no allocation, nothing drawn), gives every leaf its spec on the
production mesh (``launch/mesh.py`` ``make_production_mesh``: abstract,
no processes) under the cell's rules, and records, under the JAX
record's key names:

  * ``argument_bytes_per_device``: the bytes a device holds of the
    step's arguments under those specs (each leaf's local shard);
  * ``param_count`` / ``active_param_count`` from the config;
  * on single-pod cells, ``flops_per_device``: the step (the train step
    with its remat, the prefill, or one greedy decode step) traced on
    meta tensors at the cell's global shapes under
    ``torch.utils.flop_counter.FlopCounterMode``, divided by the
    devices.  This counts matmul-class FLOPs only (matrix products,
    convolutions, attention), unlike XLA's ``cost_analysis``, which
    counts every op; the two are not compared.

Decode cells run ``DECODE_RULES`` on bf16 parameters, as the JAX
``build_cell`` sets them.  The kernel ops take their plain versions on
meta tensors, which hold no data, so nothing here runs on a device.

Each cell also records, from rank 0's partitioned program (the
rank-local program every rank runs: ``train.loop.make_train_step``'s
``on_blocks``, ``models.partitioned``'s ``prefill_blocks`` under the
cell's rules and ``decode_blocks`` under ``DECODE_RULES``) traced on
meta tensors of rank 0's blocks on the abstract production mesh:

  * ``peak_bytes_per_device``: the most bytes live at once under
    ``repro_torch.memory.LiveBytes`` (each allocation rounded as the
    CUDA caching allocator rounds it; a kernel op counts its outputs
    and its workspace, not its plain version's intermediates);
  * ``output_bytes_per_device``: the results' bytes, less the
    arguments written in place (the decode cache);
  * ``temp_bytes_per_device``: peak less arguments less outputs,
    floored at 0;
  * ``collectives``: what ``repro_torch.distributed`` would dispatch,
    running shape-only on the abstract mesh, in the JAX record's shape
    (``{op: {count, operand_bytes, output_bytes}}``, ``total_count``,
    ``total_operand_bytes``).

The readings and the FLOPs come from one switch (``run_cell``'s
``do_probe``; ``--no-trace`` turns both off): the readings on every ok
cell, the FLOPs on single-pod cells, as the JAX sweep probes them.

These are readings of the program the port dispatches, op by op, and
differ from XLA's: XLA's buffer assignment plans one compiled program
(it fuses ops, so their intermediates may never exist, reuses and
aliases buffers, and counts a donated cache in both arguments and
outputs), where the port's peak is the eager allocator's live bytes,
its temp what is live besides the arguments and results, and its
collectives the ones it calls (no HLO exists, so ``hlo_bytes`` and
``parse_collectives`` have no counterpart).  The arguments are the
rank's blocks and the inputs as the program takes them (the whole
batch, the whole token column), so ``argument_bytes_per_device``
(the specs' shards) is kept as it was.  The program is traced at the
config's full depth (mistral-large's train_4k ~65 s on a CPU host);
the scan-corrected FLOPs probe is not ported: the FLOPs trace unrolls
every layer.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b --shape train_4k
    python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
    python -m repro_torch.launch.dryrun --all          # every cell, both meshes
    python -m repro_torch.launch.dryrun --all --arch qwen3-moe-30b-a3b
    python -m repro_torch.launch.dryrun --all --no-trace

Results append to experiments/dryrun/results_torch.jsonl (one JSON per
cell); rc 1 when a cell fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import distributed as pdist
from repro_torch import memory
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (SHAPES, cell_applicable,
                                        decode_token_specs,
                                        train_batch_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import partitioned as PT
from repro_torch.models.api import model_api
from repro_torch.serve.engine import make_serve_step
from repro_torch.sharding import (DEFAULT_RULES, Param, activate,
                                  local_shape, unbox)
from repro_torch.sharding.partition import (DECODE_RULES, Blocked,
                                            NamedSharding, param_spec)
from repro_torch.train.checkpoint import tree_leaves, tree_map
from repro_torch.train.loop import (TrainHyper, make_train_step,
                                    train_state_boxed)


def argument_bytes(boxed_tree, mesh, rules) -> int:
    """The bytes one device holds of a boxed tree's leaves under their
    specs on ``mesh``."""
    return sum(math.prod(local_shape(p.shape, param_spec(p, mesh, rules),
                                     mesh)) * p.value.element_size()
               for p in tree_leaves(boxed_tree))


def cell_step(cfg, cell):
    """(step, boxed args) of a cell's step for ``cfg``: the train step
    on the boxed train state and batch, the prefill on the parameters
    and batch, or one greedy decode step on the parameters, a
    ``global_batch`` x ``seq_len`` cache, the token and the position.
    ``step(*[unbox(a) for a in args])`` runs it on meta tensors."""
    api = model_api(cfg)
    boxed_params = L.abstract(api.init, torch.Generator())
    if cell.step == "train":
        hyper = TrainHyper()
        return make_train_step(api, hyper), (
            train_state_boxed(boxed_params, hyper),
            train_batch_specs(cfg, cell))
    if cell.step == "prefill":
        return api.prefill, (boxed_params, train_batch_specs(cfg, cell))
    serve_step = make_serve_step(api)
    cache = L.abstract(api.init_cache, cell.global_batch, cell.seq_len)
    pos = Param(torch.empty((), dtype=torch.int32, device="meta"), ())

    def step(params, cache, token, pos):
        # the position is an argument of the JAX step (4 bytes); the
        # port's decode takes a host int, and its FLOPs do not depend on it
        return serve_step(params, cache, token, 0)
    return step, (boxed_params, cache,
                  decode_token_specs(cfg, cell)["token"], pos)


def build_cell(arch_id: str, shape_name: str, multi_pod: bool):
    """(step, boxed args, mesh, cfg, rules) of a cell: decode cells on
    bf16 parameters under ``DECODE_RULES``, as the JAX build_cell sets
    them."""
    cfg = get_config(arch_id)
    cell = SHAPES[shape_name]
    rules = DEFAULT_RULES
    if cell.step == "decode":
        rules = DECODE_RULES
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    step, args = cell_step(cfg, cell)
    return step, args, make_production_mesh(multi_pod=multi_pod), cfg, rules


def trace_flops(step, args) -> int:
    """Matmul-class FLOPs of ``step`` over the (meta) arguments."""
    with FlopCounterMode(display=False) as counter:
        step(*args)
    return int(counter.get_total_flops())


COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def _blocks(boxed_tree, mesh, rules):
    """A boxed tree as rank ``mesh.coordinate``'s ``Blocked`` leaves: meta
    tensors of its local shapes."""
    def one(p):
        spec = param_spec(p, mesh, rules)
        return Blocked(torch.empty(local_shape(p.shape, spec, mesh),
                                   dtype=p.dtype, device="meta"),
                       NamedSharding(mesh, spec))
    return tree_map(one, boxed_tree)


def _local(tree):
    return tree_map(lambda b: b.local, tree)


def rank_program(cfg, cell, mesh, rules, cache_len: int | None = None):
    """(run, arguments) of one rank's partitioned program of a cell on
    meta tensors: the train step on the state's blocks and the whole
    batch, the prefill on the parameters' blocks and the whole batch
    (its cache padded to ``cache_len`` and placed under
    ``DECODE_RULES`` when given, as a server hands it to decode), or one
    decode step on the parameters' and cache's blocks and the whole
    token column.  ``run()`` returns the program's results."""
    api = model_api(cfg)
    boxed = L.abstract(api.init, torch.Generator())
    if cell.step == "train":
        hyper = TrainHyper()
        state = _blocks(train_state_boxed(boxed, hyper), mesh, rules)
        local = _local(state)
        shardings = tree_map(lambda b: b.sharding, state)
        batch = unbox(train_batch_specs(cfg, cell))
        step = make_train_step(api, hyper).on_blocks
        return (lambda: step(local, shardings, batch)), (local, batch)
    params = _blocks(boxed, mesh, rules)
    if cell.step == "prefill":
        batch = unbox(train_batch_specs(cfg, cell))

        def run():
            logits, _, cache = PT.prefill_blocks(cfg, params, batch,
                                                 cache_len=cache_len)
            return logits, _local(cache)
        return run, (_local(params), batch)
    cache = _blocks(L.abstract(api.init_cache, cell.global_batch,
                               cell.seq_len), mesh, rules)
    token = unbox(decode_token_specs(cfg, cell)["token"])

    def run():
        return (PT.decode_blocks(cfg, params, cache, token, 0),
                _local(cache))
    return run, (_local(params), _local(cache), token)


def collectives_record(ops: dict) -> dict:
    """``distributed.count_wire``'s ``ops`` in the JAX record's shape."""
    out = {op: dict(ops.get(op, {"count": 0, "operand_bytes": 0,
                                 "output_bytes": 0}))
           for op in COLLECTIVE_OPS}
    out["total_operand_bytes"] = sum(v["operand_bytes"]
                                     for v in out.values())
    out["total_count"] = sum(v["count"] for k, v in out.items()
                             if isinstance(v, dict))
    return out


def trace_readings(run, args) -> dict:
    """Peak, argument, output and temp bytes of ``run()`` under
    ``memory.LiveBytes``, and its collectives."""
    with pdist.count_wire() as wire, memory.LiveBytes() as mem:
        held = mem.hold(args)
        out = run()
        outputs = mem.bytes_of(out, exclude=args)
        peak = mem.peak
    del out
    return {"peak_bytes_per_device": peak,
            "argument_bytes_traced": held,
            "output_bytes_per_device": outputs,
            "temp_bytes_per_device": max(0, peak - held - outputs),
            "collectives": collectives_record(wire["ops"])}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             do_probe: bool = True) -> dict:
    """One cell's record.  ``do_probe``: the memory and collective
    readings of rank 0's program and, on a single-pod cell, the FLOPs
    trace of the global-shape step."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "rules": "default", "status": "ok"}
    ok, why = cell_applicable(get_config(arch_id), shape_name)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    t0 = time.time()
    try:
        step, args, mesh, cfg, rules = build_cell(arch_id, shape_name,
                                                  multi_pod)
        cell = SHAPES[shape_name]
        rec.update({
            "devices": int(mesh.size),
            "tokens": (cell.global_batch * cell.seq_len
                       if cell.step != "decode" else cell.global_batch),
            "argument_bytes_per_device": sum(
                argument_bytes(a, mesh, rules) for a in args),
            "param_count": int(cfg.param_count()),
            "active_param_count": int(cfg.active_param_count()),
        })
        if do_probe:
            t1 = time.time()
            got = trace_readings(*rank_program(cfg, cell, mesh, rules))
            del got["argument_bytes_traced"]
            rec.update(got)
            rec["readings_s"] = round(time.time() - t1, 2)
        if do_probe and not multi_pod:
            t1 = time.time()
            with activate(mesh, rules):
                flops = trace_flops(step, [unbox(a) for a in args])
            rec["flops_per_device"] = flops / mesh.size
            rec["trace_s"] = round(time.time() - t1, 2)
        rec["build_s"] = round(time.time() - t0, 2)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every cell, both meshes (of --arch only, if given)")
    ap.add_argument("--no-trace", action="store_true",
                    help="record no readings and no FLOPs (neither the "
                         "rank-local program nor the global-shape step "
                         "traced)")
    ap.add_argument("--out", default="experiments/dryrun/results_torch.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cells = []
    if args.all:
        for arch in ([args.arch] if args.arch else ARCH_IDS):
            for shape in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, do_probe=not args.no_trace)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = f"args={rec['argument_bytes_per_device'] / 2**30:.2f}GiB"
            if "peak_bytes_per_device" in rec:
                extra += (f" peak={rec['peak_bytes_per_device'] / 2**30:.2f}"
                          f"GiB collectives="
                          f"{rec['collectives']['total_count']}")
            if "flops_per_device" in rec:
                extra += (f" flops={rec['flops_per_device']:.3g} "
                          f"trace={rec['trace_s']}s")
        elif status == "failed":
            failures += 1
            extra = rec["error"]
        print(f"[{status:7s}] {arch} x {shape} x "
              f"{'multi' if mp else 'single'}-pod {extra}", flush=True)
    if failures:
        print(f"{failures} cell(s) FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
