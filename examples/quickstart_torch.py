"""Quickstart on the PyTorch/CUDA port: the public API in a few functions.

    PYTHONPATH=src python examples/quickstart_torch.py     # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py``, with its settings:

1. builds a tiny decoder LM, trains it a few steps on the synthetic stream,
2. serves greedy completions (on the GPU the prefill runs the flash
   attention kernel),
3. schedules a driving-automation task queue with FlexAI on simulated HMAI.

The LM's and the Q-net's weights are drawn from CPU generators and then
moved to the device, so a GPU run and a CPU run start from the same
weights.  Without a visible GPU it raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core.environment import EnvironmentParams, build_task_queue
from repro_torch.core.flexai import FlexAIAgent, FlexAIConfig
from repro_torch.core.flexai.dqn import init_qnet, params_from_numpy
from repro_torch.core.hmai import HMAIPlatform
from repro_torch.kernels.protocol import resolve_device
from repro_torch.models.api import model_api
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.checkpoint import tree_map
from repro_torch.train.data import DataConfig, batch_fn
from repro_torch.train.loop import (TrainHyper, init_train_state,
                                    make_train_step)

CFG = ModelConfig(name="quickstart", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                  attention_impl="naive")


# ---- 1. train a tiny LM ---------------------------------------------------
def train_lm(device, *, steps=60, params=None, log=print):
    """``steps`` AdamW steps of ``CFG`` on the synthetic stream (B 4, S 32)
    from weights drawn from a CPU generator seeded with 0, or from
    ``params`` (a NumPy tree, such as the JAX package's unboxed init).
    Returns (final TrainState, every step's loss)."""
    device = resolve_device(device)
    api = model_api(CFG)
    hyper = TrainHyper(peak_lr=3e-3, warmup_steps=5, total_steps=60)
    if params is None:
        params = tree_map(lambda t: t.to(device),
                          api.init(torch.Generator().manual_seed(0)))
    else:
        params = lm_params_from_numpy(params, device)
    state = init_train_state(params, hyper)
    step = make_train_step(api, hyper)
    bat = batch_fn(CFG, DataConfig(batch_size=4, seq_len=32))
    losses = []
    for i in range(steps):
        state, metrics = step(state, bat(i))
        losses.append(metrics["loss"])
        if i % 20 == 0:
            log(f"train step {i}: loss={float(metrics['loss']):.3f}")
    return state, [float(x) for x in losses]


# ---- 2. serve it ----------------------------------------------------------
def serve(params, device, *, prompt=(5, 12, 19), max_new_tokens=8):
    """Greedy completion of ``prompt`` by ``ServeEngine`` (2 slots,
    max_seq 48).  Returns (generated tokens, the engine)."""
    eng = ServeEngine(model_api(CFG), params, slots=2, max_seq=48,
                      device=resolve_device(device))
    eng.submit(Request(uid=0, prompt=np.array(prompt, np.int32),
                       max_new_tokens=max_new_tokens))
    eng.run_until_done()
    return list(eng.finished[0].generated), eng


# ---- 3. FlexAI on the simulated HMAI --------------------------------------
def flexai(device, *, route_km=0.05, rate_scale=0.05, episodes=3,
           min_replay=64, eps_decay_steps=4000, max_tasks=None, params=None,
           log=print) -> dict:
    """FlexAI's loop trainer on the HMAI simulator at capacity
    ``rate_scale``: ``episodes`` over the route's queue (cut to
    ``max_tasks``), then greedy scheduling of it.  The Q-net starts from
    weights drawn from a CPU generator seeded with the config's seed, or
    from ``params`` (six arrays, p0..p5).  Returns the agent, the queue
    and the schedule's summary."""
    device = resolve_device(device)
    queue = build_task_queue(EnvironmentParams(route_km=route_km,
                                               rate_scale=rate_scale))
    queue = queue[:max_tasks]
    plat = HMAIPlatform(capacity_scale=rate_scale)
    cfg = FlexAIConfig(min_replay=min_replay, eps_decay_steps=eps_decay_steps)
    agent = FlexAIAgent(plat, cfg, device=device)
    if params is None:
        params = init_qnet(agent.state_dim, agent.n_actions,
                           torch.Generator().manual_seed(cfg.seed))
    agent.learner.eval_p = agent.learner.targ_p = params_from_numpy(
        params, device)
    agent.train(plat, [queue], episodes=episodes)
    plat.reset()
    summary = agent.schedule(plat, queue)
    log(f"FlexAI on {summary['tasks']} tasks: "
        f"STM rate={summary['stm_rate']:.2f}, "
        f"R_Balance={summary['r_balance']:.2f}")
    return {"agent": agent, "queue": queue, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    device = resolve_device(ap.parse_args(argv).device)
    state, _ = train_lm(device)
    tokens, _ = serve(state.params, device)
    print("generated:", tokens)
    flexai(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
