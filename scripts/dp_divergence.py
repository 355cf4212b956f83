"""Where the data-parallel trainer's trajectory on the card parts from the
same trajectory on the CPU.

    PYTHONPATH=src python scripts/dp_divergence.py

Runs the first 300 steps of ``launch/train.py --dp``'s four default
routes at ``min_replay`` 64 from the DP episode's initial weights, with
the same injected draws, on the CPU and on the card, the card once
through the plain TD version and once through the grads kernel.  Every
TD update's inputs are recorded.  For each card run against the CPU it
prints the first step where an action differs, the largest parameter
difference going into a few updates, and the first update where the two
devices pick a different double-DQN target ``argmax_a Q_eval(s')`` for a
batch row, with that row's Q margin on the CPU.  The argmax is
recomputed here from each update's inputs by the plain version's ops on
each device: for the plain run those are the trainer's own bits, for
the kernel run the card's side is the plain ops' (the kernel's sums run
in another order).  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys

import numpy as np
import torch

import repro_torch.kernels.dqn_update as td
from repro_torch.core.flexai import dqn, engine
from repro_torch.core.hmai import HMAIPlatform
from repro_torch.core.platform import spec_from_platform
from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
from repro_torch.launch import train as train_launch

STEPS, LANES, D, A = 300, 4, 58, 11


def run(dev, kernel, cfg, plat, batch, draws, p0):
    """The DP trainer's episode on ``dev``; returns its records and the
    ``(eval_p, batch)`` that went into each TD update, on ``dev``."""
    name = "dqn_td_grads_lanes" if kernel else "dqn_td_grads_lanes_ref"
    inner, seen = getattr(td, name), []

    def recorded(eval_p, targ_p, b, **kw):
        seen.append((dqn.DQNParams(*[p.clone() for p in eval_p]),
                     {k: v.clone() for k, v in b.items()}))
        return inner(eval_p, targ_p, b, **kw)

    setattr(td, name, recorded)
    try:
        fn = engine.make_dp_train_fn(spec_from_platform(plat, dev), cfg,
                                     LANES, td_kernel=kernel)
    finally:
        setattr(td, name, inner)
    ts = engine.dp_train_init(D, A, cfg.replay_capacity, LANES, device=dev)
    p = dqn.DQNParams(*[w.to(dev) for w in p0])
    ts = ts._replace(eval_p=p, targ_p=p, opt=dqn.adam_init(p))
    out = fn(ts, batch, draws)
    return out[2].action.cpu(), out[4], seen


def target_argmax(eval_p, b):
    """Each lane's target argmax, by the plain version's own ops."""
    q = torch.stack([dqn.qnet_apply(eval_p, s) for s in b["s_next"]])
    return q.argmax(-1), q


def compare(label, cpu, card):
    act_c, upd, seen_c = cpu
    act_g, upd_g, seen_g = card
    diff = (act_c != act_g).any(0).nonzero()
    first_act = int(diff[0]) if len(diff) else None
    steps = upd.nonzero()[:, 0].tolist()   # the step of each update
    # the updates before the first action difference sample the same
    # transitions on both devices (their states equal up to rounding)
    n = sum(s < (STEPS if first_act is None else first_act) for s in steps)
    errs = [max(float((a.cpu() - b).abs().max()) for a, b in zip(pg, pc))
            for (pc, _), (pg, _) in zip(seen_c[:n], seen_g[:n])]
    state_err = max(float((bg[k].cpu() - bc[k]).abs().max())
                    for (_, bc), (_, bg) in zip(seen_c[:n], seen_g[:n])
                    for k in ("s", "s_next")) if n else 0.0
    print(f"{label}: {len(seen_c)} updates in {STEPS} steps; first action "
          f"difference at step {first_act}, after {n} updates; their TD "
          f"batches' states differ by at most {state_err:.3e}")
    marks = sorted({0, 25, 50, 100, 150, 200, n - 1} & set(range(n)))
    print("  max param difference going into update "
          + ", ".join(f"{u} (step {steps[u]}) {errs[u]:.3e}" for u in marks))
    jump = next((u for u in range(1, n) if errs[u] > 1e-5), None)
    if jump is not None:
        print(f"  first update going in past 1e-5: {jump} (step "
              f"{steps[jump]}, {errs[jump - 1]:.3e} -> {errs[jump]:.3e})")
    grow = max(range(1, n), key=lambda u: errs[u] / max(errs[u - 1], 1e-12),
               default=None)
    if grow is not None:
        print(f"  largest growth over one update: into update {grow} (step "
              f"{steps[grow]}, {errs[grow - 1]:.3e} -> {errs[grow]:.3e})")
    for u in range(n):
        a_c, q_c = target_argmax(*seen_c[u])
        a_g, _ = target_argmax(*seen_g[u])
        bad = (a_c != a_g.cpu()).nonzero()
        if len(bad):
            lane, row = bad[0].tolist()
            q = q_c[lane, row]
            margin = float(q[a_c[lane, row]] - q[a_g[lane, row]])
            print(f"  first target argmax difference: update {u} (step "
                  f"{steps[u]}), lane {lane} row {row}, {len(bad)} rows; "
                  f"CPU Q margin {margin:.3e}; param difference going in "
                  f"{errs[u]:.3e}")
            return
    print(f"  no target argmax difference in those {n} updates")


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_divergence: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    targs = train_launch.parser().parse_args(
        ["--flexai", "--dp", "--episodes", "0", "--device", "cuda"])
    trainer = train_launch.train_flexai(targs)[0]   # weights, no episode
    cfg = dataclasses.replace(trainer.cfg, min_replay=64)
    plat = HMAIPlatform(capacity_scale=targs.rate_scale)
    queues = train_launch.build_queues(targs)[0]
    batch = stack_task_arrays([tasks_to_arrays(q[:STEPS]) for q in queues])
    rng = np.random.default_rng(3)
    sizes = np.minimum(np.arange(1, STEPS + 1), cfg.replay_capacity)
    draws = engine.Draws(
        torch.tensor(rng.random((LANES, STEPS)), dtype=torch.float32),
        torch.tensor(rng.integers(0, plat.n, (LANES, STEPS))),
        torch.tensor(np.stack([[rng.integers(0, s, cfg.batch_size)
                                for s in sizes] for _ in range(LANES)])))
    p0 = trainer.ts.eval_p
    cpu = run("cpu", False, cfg, plat, batch, draws, p0)
    for label, kernel in (("card plain vs CPU", False),
                          ("card kernel vs CPU", True)):
        compare(label, cpu, run("cuda", kernel, cfg, plat, batch, draws, p0))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
