"""Training launcher of the port: an LM of the registry, or FlexAI on
the step-loop engine.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --smoke --steps 100 --ckpt-dir CKPT

``--arch`` runs the fault-tolerant LM training loop with the JAX
launcher's defaults and output lines: seeded weights (``init_lm`` /
``init_encdec`` from ``torch.Generator(device).manual_seed(0)``), AdamW
with warmup ``max(steps // 20, 1)`` and cosine decay, ``--compression``
of the gradients, a checkpoint every ``--ckpt-every`` steps and on
SIGTERM, and a restart from the latest checkpoint in ``--ckpt-dir``
(which the JAX launcher's checkpoints restore into too, by leaf name).
``--smoke`` takes the arch's reduced config.

    PYTHONPATH=src python -m repro_torch.launch.train --flexai --td-kernel

``--flexai`` trains the FlexAI scheduling agent with the JAX launcher's defaults
(``repro.launch.train --flexai``) and writes the shared p0..p5 npz with
``--weights``.  ``--dp`` trains one agent data-parallel over
``--dp-lanes`` routes an episode (default 4); ``--shard`` splits those
lanes over the processes of a ``torchrun`` job (NCCL on the card), or a
world of one without ``torchrun``:

    torchrun --nproc_per_node 1 -m repro_torch.launch.train --flexai \
        --dp --shard --td-kernel

``--td-kernel`` runs every TD update through the fused CUDA kernel
(``repro_torch.kernels.dqn_update``): the single-lane launch, or with
``--dp`` the grads variant, one launch for all lanes.  Runs on the GPU;
``--device cpu`` runs on the CPU, where the kernel's plain version stands
in for it.

``--snapshot-dir`` writes a full-state trainer snapshot every
``--snapshot-every`` episodes (the whole ``TrainState``: nets, Adam, the
replay rings, the counters and the generator's state; the episode; the
model-selection best), and ``--resume`` continues from the latest one
for ``--episodes`` more, bit for bit as an uninterrupted run:

    PYTHONPATH=src python -m repro_torch.launch.train --flexai --td-kernel \
        --episodes 2 --snapshot-dir D
    PYTHONPATH=src python -m repro_torch.launch.train --flexai --td-kernel \
        --episodes 2 --snapshot-dir D --resume
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCH_IDS


def build_queues(args):
    """The training routes (seeds seed .. seed+routes-1) and the
    validation route (seed+50), as the JAX launcher builds them."""
    from repro_torch.core.environment import (Area, EnvironmentParams,
                                              build_task_queue)

    def queue(seed):
        return build_task_queue(EnvironmentParams(
            area=Area(args.area), route_km=args.route_km,
            rate_scale=args.rate_scale, seed=seed))

    return [queue(args.seed + i) for i in range(args.routes)], \
        queue(args.seed + 50)


def _trainer_snapshot(trainer, episode: int) -> dict:
    """The checkpoint tree of a ``ScanFlexAI``: the whole ``TrainState``
    (its generator as its state bytes), the episode cursor and the
    model-selection best, so a resumed run continues bit for bit.  The
    leaf names are the JAX launcher's."""
    has_best = trainer._best_params is not None
    return {
        "ts": trainer.ts,
        "episode": np.int32(episode),
        "best_stm": np.float64(trainer._best_stm),
        "has_best": np.bool_(has_best),
        "best_p": (trainer._best_params if has_best
                   else trainer.eval_params()),
    }


def train_flexai(args):
    """Train per ``args``, from the latest snapshot with ``--resume``;
    returns (trainer, history, seconds, first episode)."""
    from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
    from repro_torch.core.hmai import HMAIPlatform

    cfg = FlexAIConfig(lr=args.lr, gamma=0.98, min_replay=256,
                       update_every=2, eps_decay_steps=40_000,
                       target_sync_every=500, seed=args.seed)
    plat = HMAIPlatform(capacity_scale=args.rate_scale)
    mesh = None
    if args.shard:
        from repro_torch import distributed as pdist
        from repro_torch.kernels.protocol import resolve_device
        mesh = pdist.make_mesh(resolve_device(args.device))
        print(f"training mesh: {pdist.mesh_size(mesh)} process(es) on axis "
              f"'routes', rank {pdist.mesh_rank(mesh)}")
    lanes = args.dp_lanes if args.dp else 1
    trainer = ScanFlexAI(plat, cfg, lanes=lanes, mesh=mesh, dp=args.dp,
                         td_kernel=args.td_kernel, device=args.device)
    print(f"device {trainer.device}; TD update: "
          + ("fused CUDA kernel" if args.td_kernel and
             trainer.device.type == "cuda" else
             "plain PyTorch (the kernel's CPU route)" if args.td_kernel
             else "autograd")
          + (" (grads variant, one launch for all lanes)"
             if args.dp and args.td_kernel and
             trainer.device.type == "cuda" else ""))
    if args.weights and os.path.exists(args.weights):
        trainer.load_weights(args.weights)
        print(f"resumed weights from {args.weights}")
    saver, start_ep = None, 0
    if args.snapshot_dir:
        from repro_torch.train import checkpoint as ckpt_lib
        saver = ckpt_lib.AsyncCheckpointer(args.snapshot_dir)
        path = (ckpt_lib.latest_checkpoint(args.snapshot_dir)
                if args.resume else None)
        if path is not None:
            snap = ckpt_lib.restore_checkpoint(
                path, _trainer_snapshot(trainer, 0))
            trainer.ts = snap["ts"]
            start_ep = int(snap["episode"])
            if snap["has_best"]:
                trainer._best_stm = float(snap["best_stm"])
                trainer._best_params = snap["best_p"]
            print(f"resumed trainer snapshot at episode {start_ep}")

    def on_episode(ep, tr):
        if saver is not None and args.snapshot_every > 0 \
                and (ep + 1) % args.snapshot_every == 0:
            saver.save(ep + 1, _trainer_snapshot(tr, ep + 1))

    queues, val_q = build_queues(args)
    n_tasks = sum(len(q) for q in queues)
    mode = f"dp lanes={lanes}" if args.dp else "single-lane"
    print(f"flexai {mode}: {args.routes} routes / {n_tasks} tasks, "
          f"{args.episodes} episodes, area={args.area}")
    t0 = time.perf_counter()
    # --episodes counts new episodes; the trainer's is the end index
    history = trainer.train(queues, episodes=start_ep + args.episodes,
                            eval_queue=val_q, eval_every=args.eval_every,
                            on_episode=on_episode, start_episode=start_ep)
    if saver is not None:
        saver.wait()
    if trainer.device.type == "cuda":
        import torch
        torch.cuda.synchronize(trainer.device)
    return trainer, history, time.perf_counter() - t0, start_ep


def train_lm(args) -> int:
    """Train ``--arch`` per ``args``, restarting from the latest
    checkpoint in ``--ckpt-dir``; prints the JAX launcher's lines."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.protocol import resolve_device
    from repro_torch.models.api import model_api
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.data import DataConfig, batch_fn
    from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                                   elastic_restore,
                                                   run_with_fault_tolerance)
    from repro_torch.train.loop import (TrainHyper, init_train_state,
                                        make_train_step)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = model_api(cfg)
    hyper = TrainHyper(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps, compression=args.compression)
    data = DataConfig(batch_size=args.batch_size, seq_len=args.seq_len)
    bat = batch_fn(cfg, data)
    step = make_train_step(api, hyper)

    params = api.init(torch.Generator(device).manual_seed(0))
    state = init_train_state(params, hyper)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"steps={args.steps} compression={hyper.compression}")

    restored, start = elastic_restore(args.ckpt_dir, state)
    if restored is not None:
        state = restored
        print(f"restored checkpoint at step {start}")

    guard = PreemptionGuard()
    losses = []

    def on_metrics(s, m):
        losses.append(float(m["loss"]))
        if s % args.log_every == 0:
            print(f"step {s}: loss={losses[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f}",
                  flush=True)

    res = run_with_fault_tolerance(
        step, state, bat, num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, start_step=start, guard=guard,
        on_metrics=on_metrics)
    print(f"done: steps={res.completed_steps} interrupted={res.interrupted} "
          f"final_loss={losses[-1] if losses else float('nan'):.4f}")
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--flexai", action="store_true",
                    help="train the FlexAI scheduling agent instead of an "
                         "LM arch")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel trainer (one synchronized agent "
                         "over a route batch)")
    ap.add_argument("--dp-lanes", type=int, default=4)
    ap.add_argument("--shard", action="store_true",
                    help="split the DP lanes over the processes of the "
                         "torchrun job (a world of one without torchrun)")
    ap.add_argument("--area", default="UB",
                    help="driving area (UB/UHW/HW)")
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--routes", type=int, default=4)
    ap.add_argument("--route-km", type=float, default=0.15)
    ap.add_argument("--rate-scale", type=float, default=0.05)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--td-kernel", action="store_true",
                    help="run the TD update through the fused CUDA kernel "
                         "(with --dp its grads variant)")
    ap.add_argument("--weights", default=None,
                    help="npz checkpoint to resume from / save to")
    ap.add_argument("--snapshot-dir", default=None,
                    help="directory of full-state trainer snapshots "
                         "(TrainState, episode, best)")
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="snapshot cadence in episodes (0: off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume bit-exactly from the latest snapshot in "
                         "--snapshot-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="[arch] the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_ckpt"),
                    help="[arch] checkpoint directory (default: "
                         "repro_ckpt in the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not args.flexai:
        if args.arch is None:
            ap.error("--arch is required (unless --flexai)")
        return train_lm(args)
    if args.shard and not args.dp:
        ap.error("--shard requires --dp: sharding splits the DP route "
                 "batch (use --dp-lanes for its width)")
    if args.weights and not args.weights.endswith(".npz"):
        args.weights += ".npz"

    from repro_torch.kernels.dqn_update import kernel as td_kernel
    launches0 = td_kernel.launches
    trainer, history, dt, start_ep = train_flexai(args)
    for ep, h in enumerate(history):
        if "eval_stm" in h:
            print(f"  episode {start_ep + ep + 1}: eval_stm={h['eval_stm']}")
    steps = int(np.sum(trainer.ts.env_steps))
    print(f"trained {steps} env steps in {dt:.2f}s "
          f"({steps / max(dt, 1e-9):.0f} steps/s on {trainer.device}), "
          f"{int(np.sum(trainer.ts.updates))} TD updates, "
          f"{td_kernel.launches - launches0} TD kernel launches, "
          f"best_eval_stm={trainer.best_eval_stm}")
    if args.weights:
        os.makedirs(os.path.dirname(args.weights) or ".", exist_ok=True)
        trainer.save_weights(args.weights)
        np.save(args.weights[: -len(".npz")] + "_losses.npy",
                np.asarray(trainer.losses, np.float64))
        print(f"saved weights to {args.weights}")
    if args.shard:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
