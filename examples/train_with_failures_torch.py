"""Fault-tolerant training demo on the PyTorch/CUDA port: train a ~1M-param
LM, kill it mid-run, restart from the checkpoint, and verify the final
state matches an uninterrupted run (deterministic step-indexed data).

    PYTHONPATH=src python examples/train_with_failures_torch.py  # on the GPU
    PYTHONPATH=src python examples/train_with_failures_torch.py --device cpu

The twin of ``examples/train_with_failures.py``, with its settings.  The
weights are drawn from a CPU generator seeded with 0 and then moved to the
device, so a GPU run and a CPU run start from the same weights.  Without a
visible GPU it raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from repro_torch.kernels.protocol import resolve_device
from repro_torch.models.api import model_api
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_params_from_numpy
from repro_torch.train.checkpoint import tree_leaves, tree_map
from repro_torch.train.data import DataConfig, batch_fn
from repro_torch.train.fault_tolerance import (elastic_restore,
                                               run_with_fault_tolerance)
from repro_torch.train.loop import (TrainHyper, init_train_state,
                                    make_train_step)

CFG = ModelConfig(name="ft-demo", family="dense", num_layers=2, d_model=96,
                  num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=256,
                  attention_impl="naive")
HYPER = TrainHyper(peak_lr=3e-3, warmup_steps=5, total_steps=60)
DATA = DataConfig(batch_size=4, seq_len=32)


def fresh_state(device, params=None):
    """The demo's initial ``TrainState`` on ``device``: weights drawn from
    a CPU generator seeded with 0, or ``params`` (a NumPy tree, such as
    the JAX package's unboxed init) carried across."""
    if params is None:
        drawn = model_api(CFG).init(torch.Generator().manual_seed(0))
        params = tree_map(lambda t: t.to(device), drawn)
    else:
        params = lm_params_from_numpy(params, device)
    return init_train_state(params, HYPER)


def run(state, ckpt_dir, *, num_steps=60, ckpt_every=20, **kw):
    """``run_with_fault_tolerance`` with the demo's step and data; ``kw``
    passes ``fail_at_step`` / ``start_step`` on."""
    return run_with_fault_tolerance(
        make_train_step(model_api(CFG), HYPER), state, batch_fn(CFG, DATA),
        num_steps=num_steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, **kw)


def demo(device, *, params=None, num_steps=60, ckpt_every=20,
         fail_at_step=37, log=print) -> dict:
    """An uninterrupted run; a run with a fault injected at
    ``fail_at_step``; the latter's last checkpoint restored and resumed to
    ``num_steps``.  Returns both final states, the restored step and
    whether they agree (rtol 1e-5, the JAX example's check)."""
    device = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="ft_demo_")
    try:
        ref = run(fresh_state(device, params), os.path.join(tmp, "ref"),
                  num_steps=num_steps, ckpt_every=ckpt_every)
        log("reference run complete")
        crash = os.path.join(tmp, "crash")
        try:
            run(fresh_state(device, params), crash, num_steps=num_steps,
                ckpt_every=ckpt_every, fail_at_step=fail_at_step)
        except RuntimeError as e:
            log(f"simulated failure: {e}")
        restored, start = elastic_restore(crash,
                                          fresh_state(device, params))
        log(f"restored from step {start}; resuming...")
        res = run(restored, crash, num_steps=num_steps,
                  ckpt_every=ckpt_every, start_step=start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(np.allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)
             for a, b in zip(tree_leaves(ref.final_state.params),
                             tree_leaves(res.final_state.params)))
    log(f"restart == uninterrupted: {ok}")
    return {"ref": ref, "resumed": res, "start": start, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when no GPU is visible)")
    args = ap.parse_args(argv)
    return 0 if demo(args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
