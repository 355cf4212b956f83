"""Serving launcher of the port: batched token serving of a decoder-only
LM (a VLM's frontend included), or, with ``--placement``, FlexAI
multi-vehicle placement serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --smoke --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --weights experiments/flexai/agent_ub.npz

Token serving (``run_token_serving``): seeded random weights, requests
with random prompts, waves through ``ServeEngine`` (prefill runs flash
attention or the SSD scan), greedy unless ``--temperature`` > 0.  The
traffic is the JAX launcher's (prompts of 3-9 tokens).  An
encoder-decoder config is refused with the JAX launcher's message (rc 1);
``serve_tokens`` serves it through ``ServeEngine`` all the same.
Placement serving: each request is one vehicle's route; placements come
from the bucketed, route-batched greedy scheduler.  Any QoS-shaped flag
(``--qos``, ``--deadline-scale``, ``--arrival-gap``, ``--continuous``,
``--measured-svc``, or a durability flag) sends it to the deadline-aware
wave engine (``repro_torch.serve.qos``), whose routes arrive over a
virtual timeline ``--arrival-gap`` apart:

    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --qos edf --continuous --routes 8 --route-km 0.01 --arrival-gap 0.02

Any durability flag (``--snapshot-dir``, ``--resume``, ``--state-out``,
``--serve-waves``, ``--inject-core``) serves through the crash-recoverable
``DurableQoSEngine`` (``repro_torch.serve.durability``): cadence snapshots,
a restore of the latest one, an injected fault with graceful degradation,
and the serving digest as an npz:

    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --qos edf --routes 4 --rate-scale 0.005 --snapshot-dir D \
        --snapshot-every 4 --trace
    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --resume --snapshot-dir D --state-out out.npz

``--stages S`` (S > 1) serves stage-level placements through the QoS
engine's pipeline waves (``repro_torch.core.pipeline``): the Q-net is a
stage agent's, loaded through ``PipelineFlexAI``, and a placement is
[tasks, S].  Durability flags and ``--shard`` refuse it, as the JAX
launcher does (pipeline waves have their own 2-D mesh path):

    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --qos edf --stages 2 --routes 4 --rate-scale 0.005

``--shard`` splits the routes (plain) or the wave's lanes (QoS) over the
processes of a ``torchrun`` job, or a world of one without it; a
``--resume`` with it continues a one-device snapshot on the mesh.
Defaults are the JAX launcher's (``repro.launch.serve``).  Runs on the
GPU; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _placement_setup(args, params=None):
    """The platform, the Q-net (``params``, else the weights in
    ``args.weights``, else fresh seeded weights; with ``--stages`` > 1 a
    stage agent's, through ``PipelineFlexAI``) and, with ``--shard``, the
    mesh."""
    import torch

    from repro_torch.core.flexai.dqn import init_qnet, load_dqn_npz
    from repro_torch.core.hmai import HMAIPlatform

    plat = HMAIPlatform(capacity_scale=args.rate_scale)
    if params is None and args.stages > 1:
        # stage-level placement needs stage-shaped Q params
        from repro_torch.core.flexai import FlexAIConfig
        from repro_torch.core.pipeline import PipelineFlexAI
        pipe = PipelineFlexAI(plat, FlexAIConfig(seed=args.seed),
                              n_stages=args.stages, device=args.device)
        if args.weights:
            pipe.load_weights(args.weights)
        params = pipe.eval_params()
    if params is None and args.weights:
        params = load_dqn_npz(args.weights)
    if params is None:
        params = init_qnet(3 + 5 * plat.n, plat.n,
                           torch.Generator().manual_seed(args.seed))
    mesh = None
    if args.shard:
        from repro_torch import distributed as pdist
        from repro_torch.kernels.protocol import resolve_device
        mesh = pdist.make_mesh(resolve_device(args.device))
        print(f"placement mesh: {pdist.mesh_size(mesh)} process(es) on "
              f"axis 'routes', rank {pdist.mesh_rank(mesh)}")
    return plat, params, mesh


def _queues(args) -> list:
    """The route queues, seeds seed .. seed+routes-1."""
    from repro_torch.core.environment import (EnvironmentParams,
                                              build_task_queue)
    return [build_task_queue(EnvironmentParams(
        route_km=args.route_km, rate_scale=args.rate_scale,
        seed=args.seed + i)) for i in range(args.routes)]


def serve_placements(args, params=None):
    """Place ``args.routes`` routes in one batch.  Returns (service,
    results, seconds, n_tasks)."""
    from repro_torch.serve.engine import FlexAIPlacementService

    plat, params, mesh = _placement_setup(args, params)
    queues = _queues(args)
    svc = FlexAIPlacementService(plat, params, min_bucket=args.min_bucket,
                                 mesh=mesh, device=args.device)
    t0 = time.perf_counter()
    results = svc.place(queues)
    dt = time.perf_counter() - t0
    return svc, results, dt, sum(len(q) for q in queues)


def _durable_mode(args) -> bool:
    """Any durability-shaped flag sends the QoS engine through
    ``DurableQoSEngine`` (snapshots, resume, fault injection)."""
    return bool(args.snapshot_dir or args.resume or args.state_out
                or args.serve_waves or args.inject_core is not None)


def _qos_config(args):
    from repro_torch.serve.qos import QoSConfig
    return QoSConfig(policy=args.qos or "fifo",
                     deadline_scale=args.deadline_scale
                     if args.deadline_scale is not None else 1.0,
                     slots=args.slots, min_bucket=args.min_bucket,
                     stages=args.stages, continuous=args.continuous,
                     measured_svc=args.measured_svc)


def qos_engine(args, params=None):
    """The deadline-aware wave engine of ``args``, its routes submitted,
    route i arriving at i x ``--arrival-gap`` (default 0.05) virtual
    seconds with Table-5 deadlines scaled by ``--deadline-scale``.  Any
    durability flag makes it a ``DurableQoSEngine``; ``--resume``
    restores the latest snapshot in ``--snapshot-dir`` instead (onto the
    ``--shard`` mesh, if any) and submits nothing."""
    from repro_torch.serve.qos import QoSPlacementEngine

    plat, params, mesh = _placement_setup(args, params)
    if _durable_mode(args):
        from repro_torch.serve.durability import (DurableQoSEngine,
                                                  FaultInjection)
        from repro_torch.train.fault_tolerance import PreemptionGuard
        kw = dict(mesh=mesh, guard=PreemptionGuard(), trace=args.trace,
                  segment_sleep=args.segment_sleep, device=args.device)
        if args.resume:
            eng = DurableQoSEngine.restore(
                args.snapshot_dir, plat,
                snapshot_every=args.snapshot_every or None, **kw)
            print(f"resumed snapshot: now={eng.now:.4f} "
                  f"completed={len(eng.completed)} "
                  f"waves={len(eng.wave_log)}", flush=True)
            return eng
        faults = []
        if args.inject_core is not None:
            faults.append(FaultInjection(
                at_time=args.inject_at, core=args.inject_core,
                factor=args.inject_factor, handled=not args.no_degrade))
        eng = DurableQoSEngine(plat, params, _qos_config(args),
                               snapshot_dir=args.snapshot_dir,
                               snapshot_every=args.snapshot_every,
                               faults=faults, **kw)
    else:
        eng = QoSPlacementEngine(plat, params, _qos_config(args), mesh=mesh,
                                 device=args.device)
    gap = args.arrival_gap if args.arrival_gap is not None else 0.05
    for i, queue in enumerate(_queues(args)):
        eng.submit(queue, arrival=i * gap)
    return eng


def serve_qos_placements(args, params=None):
    """Serve ``args.routes`` routes through the deadline-aware wave
    engine (:func:`qos_engine`).  Returns (engine, seconds)."""
    eng = qos_engine(args, params)
    t0 = time.perf_counter()
    eng.run_until_done()
    return eng, time.perf_counter() - t0


def _qos_mode(args) -> bool:
    """Any QoS- or durability-shaped flag, even one set to its default
    value, sends ``--placement`` to the QoS wave engine: the plain batch
    service has no timeline for it to act on."""
    return (args.qos is not None or args.arrival_gap is not None
            or args.deadline_scale is not None or args.stages > 1
            or args.continuous or args.measured_svc or _durable_mode(args))


def serve_tokens(args, prompt_len=(3, 10), cfg=None):
    """Serve ``args.requests`` random requests on ``args.arch``, prompt
    lengths drawn from [lo, hi) = ``prompt_len``.  A caller may pass the
    ModelConfig itself (``cfg``: the arch's, cut or in another parameter
    dtype).  Returns (engine, seconds)."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.protocol import resolve_device
    from repro_torch.models.api import model_api
    from repro_torch.serve.engine import Request, ServeEngine

    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    api = model_api(cfg)
    device = resolve_device(args.device)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(api, params, slots=args.slots, max_seq=args.max_seq,
                      temperature=args.temperature, qos=args.qos or "fifo",
                      deadline_scale=args.deadline_scale
                      if args.deadline_scale is not None else 1.0,
                      device=device)
    rng = np.random.default_rng(0)
    lo, hi = prompt_len
    for uid in range(args.requests):
        plen = int(rng.integers(lo, hi))
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    eng.run_until_done()
    return eng, time.perf_counter() - t0


def run_token_serving(args) -> int:
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        print("serve launcher currently targets decoder-only archs")
        return 1
    eng, dt = serve_tokens(args, cfg=cfg)
    toks = sum(len(r.generated) for r in eng.finished)
    qs = eng.qos_stats()
    print(f"served {len(eng.finished)} requests, {toks} tokens in "
          f"{dt:.2f}s on {eng.device} ({toks / dt:.1f} tok/s, "
          f"{len(eng.wave_log)} waves)")
    print(f"qos[{qs['policy']}]: miss_rate {qs['miss_rate']:.3f} "
          f"shed {qs['shed']} p50_slack {qs['p50_slack']:.1f} "
          f"p99_slack {qs['p99_slack']:.1f} (steps)")
    for r in eng.finished[:3]:
        print(f"  req {r.uid}: {r.generated[:8]}...")
    return 0


def parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="serve tokens of this model")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    # deadline-aware QoS (both serving modes); with --placement any of
    # these, even set to its default, selects the QoS wave engine
    ap.add_argument("--qos", choices=["fifo", "edf"], default=None,
                    help="wave admission policy (edf: deadline-aware; "
                         "default fifo)")
    ap.add_argument("--deadline-scale", type=float, default=None,
                    help="scales every derived deadline budget "
                         "(default 1.0)")
    ap.add_argument("--arrival-gap", type=float, default=None,
                    help="virtual seconds between route arrivals "
                         "(placement QoS mode; default 0.05)")
    ap.add_argument("--placement", action="store_true",
                    help="serve FlexAI route placements")
    ap.add_argument("--shard", action="store_true",
                    help="split the placement routes (or the QoS wave's "
                         "lanes) over the processes of the torchrun job")
    ap.add_argument("--routes", type=int, default=8)
    ap.add_argument("--route-km", type=float, default=0.03)
    ap.add_argument("--rate-scale", type=float, default=0.05)
    ap.add_argument("--min-bucket", type=int, default=64)
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages a wave (> 1 serves stage-level "
                         "placements through core.pipeline; QoS mode only, "
                         "incompatible with durability flags and --shard)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: refill freed wave lanes at "
                         "segment boundaries instead of draining (QoS mode)")
    ap.add_argument("--measured-svc", action="store_true",
                    help="advance the serving clock by measured segment "
                         "time (per-bucket EMA) instead of the virtual "
                         "constant (QoS mode)")
    ap.add_argument("--weights", type=str, default=None,
                    help="npz of trained EvalNet weights (p0..p5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    # durability and crash recovery (repro_torch.serve.durability); any
    # of these sends --placement to the durable QoS engine
    ap.add_argument("--snapshot-dir", type=str, default=None,
                    help="write crash-recovery snapshots here")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot cadence in service segments (0: only "
                         "the closing or boundary snapshot)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot in --snapshot-dir "
                         "instead of submitting fresh routes")
    ap.add_argument("--serve-waves", type=int, default=0,
                    help="stop after N admission rounds and snapshot "
                         "(0: run to completion)")
    ap.add_argument("--state-out", type=str, default=None,
                    help="write the serving-outcome digest npz here (the "
                         "recovery bit-exactness contract)")
    ap.add_argument("--inject-core", type=int, default=None,
                    help="fault injection: degrade this accelerator")
    ap.add_argument("--inject-at", type=float, default=0.0,
                    help="virtual-clock time the fault fires")
    ap.add_argument("--inject-factor", type=float, default=50.0,
                    help="exec-time degradation factor (large: dead)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="no graceful-degradation response (the "
                         "no-mitigation baseline)")
    ap.add_argument("--segment-sleep", type=float, default=0.0,
                    help="wall sleep a segment (widens the kill window of "
                         "a crash-recovery test)")
    ap.add_argument("--trace", action="store_true",
                    help="print segment, snapshot and fault lines")
    return ap


def run_placement_serving(args) -> int:
    svc, results, dt, n_tasks = serve_placements(args)
    stm = float(np.mean([r["stm_rate"] for r in results]))
    print(f"placed {len(results)} routes / {n_tasks} tasks in {dt:.2f}s "
          f"on {svc.device} ({n_tasks / dt:.0f} tasks/s, "
          f"{svc.dispatches} dispatches, mean stm_rate {stm:.3f})")
    return 0


def run_qos_placement_serving(args) -> int:
    if not _durable_mode(args):
        if args.shard and args.stages > 1:
            print("--shard is single-stage (pipeline waves have their own "
                  "2-D mesh path)")
            return 1
        eng, dt = serve_qos_placements(args)
        print(qos_summary(eng, dt))
        return 0
    from repro_torch.core.hmai import HMAIPlatform
    if args.continuous or args.measured_svc:
        print("--continuous/--measured-svc are incompatible with "
              "durability flags (the snapshot format packs whole-wave "
              "checkpoints and crash replay needs the deterministic "
              "virtual clock)")
        return 1
    if args.stages > 1:
        print("--stages > 1 is incompatible with durability flags "
              "(pipeline waves checkpoint (state, ring); the snapshot "
              "format and fault-masked executors are single-stage)")
        return 1
    cores = HMAIPlatform(capacity_scale=args.rate_scale).n
    if args.inject_core is not None and not 0 <= args.inject_core < cores:
        print(f"--inject-core {args.inject_core} out of range: the "
              f"platform has {cores} accelerators (valid: "
              f"0..{cores - 1})")
        return 1
    from repro_torch import distributed as pdist
    from repro_torch.serve.durability import serving_digest
    eng = qos_engine(args)
    t0 = time.perf_counter()
    if args.serve_waves:
        n = eng.serve_waves(args.serve_waves)
        eng.snapshot()   # a boundary snapshot, so --resume continues here
        if eng.saver is not None:
            eng.saver.wait()
        print(f"partial run: served {n} waves, snapshotted", flush=True)
    else:
        eng.run_until_done()
        if eng.saver is not None:
            eng.snapshot()
            eng.saver.wait()
    print(qos_summary(eng, time.perf_counter() - t0))
    s = eng.stats()
    print(f"durability: snapshots {s['snapshots_written']} segments "
          f"{s['segments_done']} faults {s['faults_fired']} masked "
          f"{s['cores_masked']} interrupted {s['interrupted']} "
          f"snapshot_time_s {s['snapshot_time_s']:.4f}")
    if args.state_out and (eng.mesh is None
                           or pdist.mesh_rank(eng.mesh) == 0):
        np.savez(args.state_out, **serving_digest(eng))
        print(f"state digest -> {args.state_out}")
    return 0


def qos_summary(eng, wall_s: float) -> str:
    """One line of a served QoS run: completed / submitted routes, wall
    and virtual seconds, miss rate, shed, preemptions, refills,
    dispatches, tasks placed a wall second, p50 / p99 latency (virtual
    finish - arrival of completed routes) and slack, mean STM."""
    s = eng.stats()
    lat = np.asarray([r.finish - r.arrival for r in eng.completed])
    tasks = sum(r.n_tasks for r in eng.completed)

    def pct(q):
        return float(np.percentile(lat, q)) if lat.size else 0.0
    return (f"qos[{s['policy']}] served {s['completed']}/{s['submitted']} "
            f"routes in {wall_s:.3f}s wall on {eng.device} "
            f"({s['virtual_time_s']:.4f}s virtual): miss_rate "
            f"{s['miss_rate']:.3f} shed {s['shed']} preemptions "
            f"{s['preemptions']} refills {s['refills']} dispatches "
            f"{s['dispatches']} tasks/s {tasks / max(wall_s, 1e-9):.1f} "
            f"p50_latency {pct(50):.4f}s p99_latency {pct(99):.4f}s "
            f"p50_slack {s['p50_slack_s']:.4f}s "
            f"p99_slack {s['p99_slack_s']:.4f}s mean_stm "
            f"{s['mean_stm_rate']:.3f}")


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not args.placement:
        if args.arch is None:
            ap.error("--arch is required unless --placement is given")
        return run_token_serving(args)
    try:
        if _qos_mode(args):
            return run_qos_placement_serving(args)
        return run_placement_serving(args)
    finally:
        import torch.distributed as dist
        if args.shard and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
