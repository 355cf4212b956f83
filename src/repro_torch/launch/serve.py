"""Serving launcher of the port: FlexAI multi-vehicle placement serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --weights experiments/flexai/agent_ub.npz

Each request is one vehicle's route; placements come from the bucketed,
route-batched greedy scheduler (``repro_torch.serve.engine``).  Defaults
are the JAX launcher's (``repro.launch.serve --placement``).  Runs on the
GPU; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def serve_placements(args, params=None):
    """Place ``args.routes`` routes with ``params`` (or the weights in
    ``args.weights``, or fresh seeded weights).  Returns (service,
    results, seconds, n_tasks)."""
    import torch

    from repro_torch.core.environment import (EnvironmentParams,
                                              build_task_queue)
    from repro_torch.core.flexai.dqn import init_qnet, load_dqn_npz
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.serve.engine import FlexAIPlacementService

    plat = HMAIPlatform(capacity_scale=args.rate_scale)
    if params is None and args.weights:
        params = load_dqn_npz(args.weights)
    if params is None:
        params = init_qnet(3 + 5 * plat.n, plat.n,
                           torch.Generator().manual_seed(args.seed))
    svc = FlexAIPlacementService(plat, params, min_bucket=args.min_bucket,
                                 device=args.device)
    queues = [build_task_queue(EnvironmentParams(
        route_km=args.route_km, rate_scale=args.rate_scale,
        seed=args.seed + i)) for i in range(args.routes)]
    t0 = time.perf_counter()
    results = svc.place(queues)
    dt = time.perf_counter() - t0
    return svc, results, dt, sum(len(q) for q in queues)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--placement", action="store_true",
                    help="serve FlexAI route placements (the only serving "
                         "mode of the port so far)")
    ap.add_argument("--routes", type=int, default=8)
    ap.add_argument("--route-km", type=float, default=0.03)
    ap.add_argument("--rate-scale", type=float, default=0.05)
    ap.add_argument("--min-bucket", type=int, default=64)
    ap.add_argument("--weights", type=str, default=None,
                    help="npz of trained EvalNet weights (p0..p5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not args.placement:
        ap.error("--placement is required: the port serves placements only")

    svc, results, dt, n_tasks = serve_placements(args)
    stm = float(np.mean([r["stm_rate"] for r in results]))
    print(f"placed {len(results)} routes / {n_tasks} tasks in {dt:.2f}s "
          f"on {svc.device} ({n_tasks / dt:.0f} tasks/s, "
          f"{svc.dispatches} dispatches, mean stm_rate {stm:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
