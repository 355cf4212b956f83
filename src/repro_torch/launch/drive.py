"""End-to-end driving pipeline of the port: driving environment -> camera
task queue -> FlexAI scheduling -> virtual-accelerator pools that really
run the perception CNNs through their dataflow kernels.

    PYTHONPATH=src python -m repro_torch.launch.drive

The counterpart of the JAX package's ``examples/serve_driving_pipeline.py``
with its settings as defaults: the pools (``core/virtual_platform.py``)
are calibrated on the device and advertise measured rates; the camera
rates are scaled to that capacity; FlexAI trains on a simulated copy of
the platform, and its greedy placements are then replayed on the real
one, so every frame runs on its pool.  ``--full-width`` runs the pools'
nets at full width and input size (``FULL_WIDTH_POOLS``) instead of the
example's reduced ones.  FlexAI's TD updates go through the fused
TD-update kernel.  Runs on the GPU; ``--device cpu`` runs on the
CPU, where every kernel's plain version stands in for it.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run_pipeline(args, log=print) -> dict:
    """Run the pipeline per ``args``; returns what it measured."""
    from repro_torch.core.environment import (EnvironmentParams,
                                              build_task_queue)
    from repro_torch.core.flexai import (FlexAIConfig, ScanFlexAI,
                                         make_schedule_fn)
    from repro_torch.core.platform import spec_from_platform
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.core.tasks import tasks_to_arrays
    from repro_torch.core import virtual_platform as vp

    log("calibrating virtual accelerator pools (perception CNNs through "
        "their dataflow kernels)...")
    pools = vp.FULL_WIDTH_POOLS if args.full_width else vp.DEFAULT_POOLS
    t0 = time.perf_counter()
    plat = vp.VirtualPlatform(pools, args.seed, run_real=True,
                              device=args.device)
    for pool in plat.pools:
        log(f"  pool {pool.spec.name} [{pool.spec.archetype}]: "
            + ", ".join(f"{k}={v:.1f} fps"
                        for k, v in pool.measured_fps.items()))
    log(f"calibration took {time.perf_counter() - t0:.2f}s on {plat.device}")

    # scale the camera rates to the measured pool capacity
    cap = sum(np.mean(list(p.measured_fps.values())) for p in plat.pools)
    rate_scale = min(1.0, cap / 1800.0)
    log(f"aggregate capacity ~{cap:.0f} fps -> rate_scale={rate_scale:.4f}")
    queue = build_task_queue(EnvironmentParams(
        route_km=args.route_km, rate_scale=rate_scale,
        seed=args.seed))[:args.max_tasks]
    log(f"task queue: {len(queue)} tasks")

    # FlexAI trained on the measured platform (simulated execution)
    sim = vp.VirtualPlatform(pools, args.seed, run_real=False,
                             device=args.device)
    cfg = FlexAIConfig(min_replay=64, eps_decay_steps=3000, update_every=4)
    trainer = ScanFlexAI(sim, cfg, td_kernel=True, device=plat.device)
    t0 = time.perf_counter()
    trainer.train([queue], episodes=args.episodes)
    train_s = time.perf_counter() - t0
    log(f"FlexAI trained: {args.episodes} episodes, {trainer.ts.env_steps} "
        f"env steps, {trainer.ts.updates} TD updates in {train_s:.2f}s")

    # greedy placements on the real platform's rates, replayed through it
    sched = make_schedule_fn(spec_from_platform(plat, plat.device),
                             cfg.backlog_scale)
    _, recs = sched(trainer.eval_params(),
                    tasks_to_arrays(queue).to(plat.device))
    placements = recs.action.cpu().numpy()
    log("running the real pipeline (frames actually execute on pools)...")
    plat.reset()
    t0 = time.perf_counter()
    for task, a in zip(queue, placements):
        plat.execute(task, int(a))
    replay_s = time.perf_counter() - t0
    flexai = plat.summary()
    log(f"FlexAI:   STM={flexai['stm_rate']:.4f} "
        f"R_Balance={flexai['r_balance']:.4f} wall={replay_s:.2f}s "
        f"({len(queue) / replay_s:.1f} tasks/s)")

    plat.reset()
    t0 = time.perf_counter()
    worst = get_scheduler("worst").schedule(plat, queue)
    worst_s = time.perf_counter() - t0
    log(f"worst:    STM={worst['stm_rate']:.4f} "
        f"R_Balance={worst['r_balance']:.4f} wall={worst_s:.2f}s")
    return {"platform": plat, "rate_scale": rate_scale, "tasks": len(queue),
            "trainer": trainer, "train_s": train_s, "placements": placements,
            "flexai": flexai, "replay_s": replay_s, "worst": worst,
            "worst_s": worst_s}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--route-km", type=float, default=0.02)
    ap.add_argument("--max-tasks", type=int, default=400,
                    help="cut the route's queue to this many tasks")
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--full-width", action="store_true",
                    help="pools run the nets at full width and input size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    return ap


def main(argv=None) -> int:
    run_pipeline(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
