"""Serving launcher of the port: batched token serving of a decoder-only
LM, or, with ``--placement``, FlexAI multi-vehicle placement serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --smoke --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --weights experiments/flexai/agent_ub.npz

Token serving (``run_token_serving``): seeded random weights, requests
with random prompts, waves through ``ServeEngine`` (prefill runs flash
attention or the SSD scan), greedy unless ``--temperature`` > 0.  The
traffic is the JAX launcher's (prompts of 3-9 tokens).
Placement serving: each request is one vehicle's route; placements come
from the bucketed, route-batched greedy scheduler.  Defaults are the JAX
launcher's (``repro.launch.serve``).  Runs on the GPU; ``--device cpu``
runs on the CPU.
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


def serve_tokens(args, prompt_len=(3, 10)):
    """Serve ``args.requests`` random requests on ``args.arch``, prompt
    lengths drawn from [lo, hi) = ``prompt_len``.  Returns (engine,
    seconds)."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.protocol import resolve_device
    from repro_torch.models.api import model_api
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = model_api(cfg)
    device = resolve_device(args.device)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(api, params, slots=args.slots, max_seq=args.max_seq,
                      temperature=args.temperature, qos=args.qos,
                      deadline_scale=args.deadline_scale, device=device)
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
    eng, dt = serve_tokens(args)
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
    ap.add_argument("--qos", choices=["fifo", "edf"], default="fifo",
                    help="token-engine admission")
    ap.add_argument("--deadline-scale", type=float, default=1.0)
    ap.add_argument("--placement", action="store_true",
                    help="serve FlexAI route placements")
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
        if args.arch is None:
            ap.error("--arch is required unless --placement is given")
        return run_token_serving(args)

    svc, results, dt, n_tasks = serve_placements(args)
    stm = float(np.mean([r["stm_rate"] for r in results]))
    print(f"placed {len(results)} routes / {n_tasks} tasks in {dt:.2f}s "
          f"on {svc.device} ({n_tasks / dt:.0f} tasks/s, "
          f"{svc.dispatches} dispatches, mean stm_rate {stm:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
