"""End-to-end pipeline on the PyTorch/CUDA port: driving environment ->
camera task queue -> FlexAI scheduling -> virtual-accelerator pools that
really run the perception CNNs through their dataflow kernels.

    PYTHONPATH=src python examples/serve_driving_pipeline_torch.py  # GPU
    PYTHONPATH=src python examples/serve_driving_pipeline_torch.py \
        --device cpu

The twin of ``examples/serve_driving_pipeline.py``, step for step and with
its settings.  Each pool (``repro_torch/core/virtual_platform.py``) runs
every convolution through its archetype's kernel (MconvMC, SconvOD,
SconvIC) and advertises the rates it measured; FlexAI's loop trainer
learns on a simulated copy of the platform, then places the queue on the
real one, where every frame runs on its pool.  The Q-net's weights are
drawn from a CPU generator and moved to the device.  Without a visible
GPU it raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.environment import EnvironmentParams, build_task_queue
from repro_torch.core.flexai import FlexAIAgent, FlexAIConfig
from repro_torch.core.flexai.dqn import init_qnet, params_from_numpy
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.virtual_platform import DEFAULT_POOLS, VirtualPlatform
from repro_torch.kernels.protocol import resolve_device


def calibrate(device, *, pools=DEFAULT_POOLS, log=print) -> VirtualPlatform:
    """The pools, calibrated on ``device``, running frames for real."""
    log("calibrating virtual accelerator pools (perception CNNs through "
        "their dataflow kernels)...")
    t0 = time.perf_counter()
    plat = VirtualPlatform(pools, run_real=True, device=device)
    for pool in plat.pools:
        log(f"  pool {pool.spec.name} [{pool.spec.archetype}]: "
            + ", ".join(f"{k}={v:.0f} fps"
                        for k, v in pool.measured_fps.items()))
    log(f"calibration took {time.perf_counter() - t0:.1f}s")
    return plat


def task_queue(plat, *, route_km=0.02, seed=0, max_tasks=400, log=print):
    """The route's camera queue at rates scaled to the pools' measured
    capacity.  Returns (queue, rate_scale)."""
    cap = sum(np.mean(list(p.measured_fps.values())) for p in plat.pools)
    rate_scale = min(1.0, cap / 1800.0)
    log(f"aggregate capacity ~{cap:.0f} fps -> rate_scale={rate_scale:.4f}")
    queue = build_task_queue(EnvironmentParams(
        route_km=route_km, rate_scale=rate_scale, seed=seed))[:max_tasks]
    log(f"task queue: {len(queue)} tasks")
    return queue, rate_scale


def train_agent(queue, device, *, pools=DEFAULT_POOLS, episodes=2,
                min_replay=64, eps_decay_steps=3000, update_every=4,
                params=None):
    """FlexAI's loop trainer on a simulated copy of the pools (calibrated
    anew, frames not run).  The Q-net starts from weights drawn from a CPU
    generator seeded with the config's seed, or from ``params`` (six
    arrays, p0..p5).  Returns (agent, the simulated platform)."""
    sim = VirtualPlatform(pools, run_real=False, device=device)
    cfg = FlexAIConfig(min_replay=min_replay,
                       eps_decay_steps=eps_decay_steps,
                       update_every=update_every)
    agent = FlexAIAgent(sim, cfg, device=device)
    if params is None:
        params = init_qnet(agent.state_dim, agent.n_actions,
                           torch.Generator().manual_seed(cfg.seed))
    agent.learner.eval_p = agent.learner.targ_p = params_from_numpy(
        params, device)
    agent.train(sim, [queue], episodes=episodes)
    return agent, sim


def pipeline(device, *, pools=DEFAULT_POOLS, route_km=0.02, seed=0,
             max_tasks=400, episodes=2, params=None, log=print) -> dict:
    """The example end to end: calibrate, build the queue, train FlexAI on
    the simulated copy, then place the queue on the real pools (every
    frame runs) and time it; the ``worst`` scheduler the same.  Returns
    the platforms, queue, agent, each run's summary and placements, and
    the FlexAI run's wall seconds."""
    device = resolve_device(device)
    plat = calibrate(device, pools=pools, log=log)
    queue, rate_scale = task_queue(plat, route_km=route_km, seed=seed,
                                   max_tasks=max_tasks, log=log)
    agent, sim = train_agent(queue, device, pools=pools, episodes=episodes,
                             params=params)

    log("running the real pipeline (frames actually execute on pools)...")
    plat.reset()
    t0 = time.perf_counter()
    summary = agent.schedule(plat, queue)
    wall = time.perf_counter() - t0
    placements = [r.accel_index for r in plat.records]
    log(f"FlexAI:   STM={summary['stm_rate']:.2f} "
        f"R_Balance={summary['r_balance']:.2f} wall={wall:.1f}s")

    plat.reset()
    worst = get_scheduler("worst").schedule(plat, queue)
    log(f"worst:    STM={worst['stm_rate']:.2f} "
        f"R_Balance={worst['r_balance']:.2f}")
    return {"platform": plat, "sim": sim, "rate_scale": rate_scale,
            "queue": queue, "agent": agent, "flexai": summary,
            "placements": placements, "wall_s": wall, "worst": worst,
            "worst_placements": [r.accel_index for r in plat.records]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    pipeline(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
