#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises:

1. build      - compile every CUDA kernel source of ``src/repro_torch``
                (six libraries: the TD update, the three conv dataflows,
                flash attention and the SSD scan), one nvcc per source, all
                started together
2. card       - the card's name and power limit (nvidia-smi)
3. kernels    - the TD kernel (one cluster of 8 blocks; its plan printed)
                against its plain PyTorch version on the card, at the main
                path's widths, timed with CUDA events; then its lane launch
                (one cluster a lane) at L = 4, both variants as the
                trainers call them (grads with the nets shared, Adam with a
                net a lane), timed at L = 1, 4 and 16; then both launches
                at the stage agent's width (D = 70), the Adam variant timed
4. conv       - the three conv-dataflow kernels against their plain
                version (the JAX tests' shapes, Cin = 11, Ho = 513 with
                row_tile 8, 11x11 stride 4, even-H SAME stride 2, bf16),
                then timed at the largest-MAC layers of YOLO and SSD
                (each kernel's plan printed: tile and split count G; two
                calls of each checked bit-equal), and the host and device
                time of a call at a conv of the example's pools
5. attention  - the flash-attention kernel against its plain version (the
                JAX tests' shapes, ragged S 77 and 1,000, D 64 and 128, GQA
                and MQA, causal and not, stablelm's serving waves at S
                1,491 and 590, the zoo's heads at S 1,491 and 77: danube
                D 120, qwen3-moe 32 over 4, moonshot 16 of 128, mistral 96
                over 8, jamba 32 over 8; seamless's encoder, not causal,
                at S 1 and 372; internvl2's 64 over 8 at D 128 and S
                556; the quickstart twin's served prefill at B 2, S 3
                (shorter than a tile), 4 over 2, D 16; fp32 and bf16),
                minicpm3's MLA
                route (V 64 zero-padded to 96) against plain attention of
                the unpadded V, then timed at B 4, S 1024, H 32, D 64,
                bf16, causal, beside SDPA
6. ssd        - the SSD scan (three kernels a call; its plan printed at
                the timing shape and mamba2's serving wave) against its
                plain version (the JAX tests' shapes, a ragged tail,
                mamba2's widths, jamba's 128 heads of state 16), then
                timed at B 4, S 1024, H 24, P 64, N 128, chunk 256, bf16
7. small      - the CUDA trainer and placement service against the same
                code on the CPU, on a small route with the same draws
8. lm-small   - stablelm-1.6b, mamba2-130m, h2o-danube-3-4b,
                qwen3-moe-30b-a3b and minicpm3-4b at full width cut to 2
                layers, internvl2-76b to 1, seamless-m4t-medium to 2 encoder +
                2 decoder layers, same weights, a 300-token prompt (after
                256 seeded N(0, 1) patches for internvl2; over 75 such
                source frames for seamless): CUDA (kernels) against the
                CPU (plain versions), prefill logits and 8 greedy tokens,
                flash launched once an attention layer of the card's
                prefill; qwen3's expert choices card vs CPU, on the
                CPU's router inputs and on each run's own, each
                difference a router tie.  It runs in a spawned process of
                its own beside phases 9-10i (its weights' draws and CPU
                legs are host work), as do phase 16's launcher runs,
                phase 17's dry run and phase 19's quickstart; each is
                held where its phase stands (phase 8 before phase 14),
                so that the script stays well inside its time limit;
                each phase's start is stamped on standard error
9. train      - main path 1: one FlexAI training episode with the fused TD
                kernel, at the training launcher's defaults (seed-0 route);
                the TD kernel's device time there as its launches x its
                time at B 64 from phase 3
10. serve     - main path 1: 8 routes placed by the trained Q-net, at
                rate 0.025 (half the launcher's default: the smoke's
                time limit; the service pads a route to a power of
                two, so its steps fall from 28,672 to 14,336)
10a. baselines - fig 12's quick configuration (two UB queues, cut to
                their first 2,500 tasks, HMAI n = 11 at rate 0.05): the worst,
                ATA and Min-Min scans, GA and SA at Table 11's sizes and
                FlexAI's greedy run (the weights of phase 9), each one
                batched dispatch with host syncs forbidden inside; STM,
                R_Balance, makespan, energy, MS and ms per task; a brake
                task from each final state and its braking distance (fig
                14's constants); a 300-task prefix held to the CPU; ATen
                ops a step of each, without a trace and with an
                all-ones one
10b. variability - 40 scenarios (5 families x 8) of a 798-task route
                through FlexAI (health-aware, and fault-blind replayed
                under the traces) and every baseline with ``health=``,
                STM per family; one degradation episode through the TD
                kernel under a random fault trace, its launches counted
10c. dp       - main path 6: one data-parallel episode through
                ``launch/train.py --dp --td-kernel --rate-scale 0.025``
                (4 lanes on the launcher's routes of seeds 0-3): one
                grads-kernel launch a TD update for all lanes; its first
                300 steps held to the CPU with the same draws
10d. population - main path 7: the degradation fine-tune of
                ``benchmarks/scenarios.py`` (4 population lanes from phase
                9's weights, eps 0.25 -> 0.02 over 2,000 steps, min_replay
                128, seed 47) over phase 10b's 40 scenarios, the first 5
                of an epoch's 10 lane batches (the smoke's time limit)
                under their health traces: one Adam-kernel
                launch a step for all lanes; each lane's STM on the base
                route and on the fleet
10e. sharded  - main path 8: a one-process NCCL mesh: the DP trainer with
                and without it, bit for bit, and the placement service
                with and without it, on the first 1,000 tasks of each
                route
10f. qos      - main path 9: the QoS placement engine on phase 9's
                weights, the quick arm of ``benchmarks/serve_load.py``
                (a 204-task base route, 18 requests, EDF, 4 slots, chunk
                8): Poisson load 2.0 drained and continuous, Gamma
                burstiness 4 continuous, 6 requests on the measured
                service clock, one line an arm; 12 requests at load 1.5
                on 3 slots with and without phase 10e's mesh, digests
                equal; the drain trace on the card and on the CPU, digests
                equal (a placement may part only at a CPU Q margin below
                1e-5); then ``launch/serve.py
                --placement --qos edf --continuous``
10g. durability - main path 10: crash-recoverable QoS serving
                (``serve/durability.py``) on phase 9's weights over
                ``benchmarks/recovery.py``'s quick arms (16 synthetic
                routes, EDF, 2 slots, chunk 16): wall time with snapshots
                off and on (every 64 segments), a run cut after half its
                waves and restored from disk (digest equal), the busiest
                core failing x50 handled and unhandled (handled misses
                fewer), the handled arm on the CPU (digests equal, final
                states included); then in subprocesses the serve launcher
                SIGKILLed after its third snapshot and resumed, two waves
                resumed with ``--shard`` on a one-process NCCL mesh (both
                digests equal to an uninterrupted run's), and
                ``launch/train.py --td-kernel`` 1 episode + ``--resume``
                1 against 2 (weights bit-equal); one line an arm
10h. stages   - main path 11: the stage pipeline (``core/pipeline.py``):
                the stage plan at S = 2 and 3; EFT over
                ``benchmarks/pipeline.py``'s configuration (UB routes of
                seeds 700 / 701, their first 768 tasks drained) at S = 1
                and 2, the flat wavefront bit-equal to the task-major
                reference on the card and the makespans equal to the JAX
                package's on the CPU; stage-FlexAI training through the TD
                kernel at D = 70: a single-lane episode on the seed-700
                route (cut to 768 tasks), a population and a DP episode
                of 4 lanes (seeds 700-703, cut to 384 tasks), launches =
                updates,
                each one's first 150 tasks (302 flat steps) held to the
                CPU with the same draws; the trained net's greedy stage
                placements card vs CPU; QoS pipeline waves (the 10f drain
                trace at ``stages=2``) card vs CPU, preemption on and off;
                ``launch/serve.py --placement --qos edf --stages 2``
10i. stage mesh - main path 12: the stage pipeline's mesh half.  Two
                spawned processes on one gloo (2, 1) ``("stages",
                "routes")`` mesh, both computing on the card, the finish
                ring hopping through host memory: the stage-sharded
                wavefront with ``eft`` over 10h's drained routes and with
                ``flexai`` (10h's trained stage net) over its greedy
                routes, records, rings and ``combine_stage_states`` equal
                to 10h's flat engine bit for bit, the EFT makespans equal
                to the JAX package's; then on a one-process NCCL mesh the
                sharded population stage trainer (bit-equal to 10h's
                population) and the mesh DP stage trainer (within 1e-3 of
                10h's DP), launches = updates
11. perception - main path 2: YOLO at 416x416, SSD at 512x512 and a GOTURN
                pair at 227x227, full width, batch 1, through each conv
                dataflow, held to the plain path; ms per frame
12. pipeline  - main path 3: ``launch/drive.py`` at its defaults: pools
                calibrated on the card, FlexAI trained (TD kernel) and its
                placements replayed on the pools, against ``worst``; the
                TD kernel's device time there, as in phase 9
13. pipeline, full width - main path 4: ``launch/drive.py --full-width``:
                the same with the pools' nets at full width and input
                size, so each pool's rate is its dataflow kernel's
14. lm-serve  - main path 5: token serving (``launch/serve.py``) of
                stablelm-1.6b and of mamba2-130m at full width and depth,
                seeded weights, 8 requests of 256-1536-token prompts, 32
                greedy tokens each, 4 slots, max_seq 4096, FIFO; every
                prefill's 24 layers launch flash attention (stablelm) or
                the SSD scan (mamba2) once; that kernel's device time
                inside one longest-wave prefill is summed from CUDA events
                around each of its launches
15. lm zoo    - main path 5 for the rest of the zoo, the same traffic at
                full width: h2o-danube-3-4b uncut, minicpm3-4b cut to 16
                layers, qwen3-moe and moonshot in bf16 parameters cut to
                12, jamba cut to one 8-layer super-block, mistral-large
                and internvl2-76b to 4 layers, seamless-m4t-medium uncut
                (through ``serve_tokens``: the
                launcher's CLI refuses an encoder-decoder); the engine's
                frontends are zeros; each run's flash and SSD launches =
                its attention (encoder's included) and Mamba layers x
                waves,
                its parameter dtype and count and peak device memory
                printed; each model freed before the next
16. lm-train  - main path 13: LM training (``train/``, ``lm_loss`` /
                ``encdec_loss``) on the plain attention and scan branches,
                as the JAX models train: both kernel ops refuse CUDA
                inputs that require grad; stablelm-1.6b and mamba2-130m
                at full width cut to 2 layers, CPU-drawn weights, one
                ``lm_batch_at_step`` batch (B 2, S 128): loss and every
                gradient leaf card vs CPU in fp32 compute and in bf16;
                stablelm-1.6b uncut through
                ``make_train_step``, 6 steps at B 4, S 512 (step ms, peak
                memory); ``launch/train.py --arch mamba2-130m`` 8 steps,
                then restarted to 12 (in the background since phase 8);
                examples/train_with_failures_torch.py's ``demo``: a
                fault at step 37, restored and resumed, against an
                uninterrupted run; no kernel launched on the path
17. mesh      - main path 14: qwen3-moe-30b-a3b at full width cut to 2
                layers (phase 8's weights), ``moe_impl="shard_map"``,
                served by two spawned processes sharing the card on a
                gloo (1, 2) ``("data", "model")`` mesh, each holding 64
                of the 128 experts a layer (``moe.shard_experts``):
                (a) against the one-process GSPMD engine on the card at
                the first capacity factor where it drops nothing (EP
                drops none either): prefill logits, 8 greedy tokens
                (each difference after a router tie), the engine's wave
                log, flash launches = attention layers x waves on each
                rank, the expert bytes halved, one EP MoE layer's ms;
                (b) the same EP run on the card and on the CPU at the
                config's factor 1.25 in fp32 compute: equal drop counts,
                logits within the gate; (c) ``python -m
                repro_torch.launch.dryrun --all --no-trace`` (66 ok,
                14 skipped, 0 failed) and ``--all --arch
                qwen3-moe-30b-a3b`` (FLOPs traced on the meta
                device, and rank 0's peak / temp / output bytes and
                collectives), both started in the background with phase
                8
18. partitioned - main path 15: the LM train step on a process mesh
                (``make_train_step`` on a state of ``DTensor`` leaves
                placed by the logical-axis specs), two spawned processes
                sharing the card on a gloo group with "cuda" meshes (the
                shards stay on the card), started after phase 10d: (a)
                h2o-danube-3-4b at full width, 2 layers, fp32 compute, B
                4, S 512, two steps on (2, 1) and on (1, 2) against the
                one-process step; (b) mamba2-130m uncut, two steps on (2,
                1), saved, ``elastic_restore`` onto (1, 2) and onto one
                process (bit-equal), a third step from each; (c)
                qwen3-moe-30b-a3b's smoke config at capacity factor 0.5
                (it drops choices), two steps on (2, 1) against the
                one-process step, the drop counts equal (its MoE layers
                route the tokens of both ranks, recomputed by remat in
                the backward on the autograd engine's CUDA thread); the
                loss, grad norm, aux loss, leaves and moments held;
                step ms, the bytes a rank holds, its peak memory and
                gloo's payload printed; no kernel on the train path;
                then (d) partitioned serving in the same processes:
                danube (2 layers), mamba2-130m uncut and qwen3-moe's
                smoke config, fp32 compute, a 2 x 1,024-token prefill
                (``models.partitioned``, ``DEFAULT_RULES``: flash
                attention and the SSD scan on each rank's rows, launches
                counted) and 8 greedy ``make_serve_step`` steps under
                ``DECODE_RULES`` on (2, 1) and (1, 2) against the
                one-process engine: tokens equal, logits and cache
                blocks within 1e-5; each rank's collectives equal the
                dry run's shape-only ones and its allocator rise over
                the prefill and a decode step within 15 % of the dry
                run tracker's peak less arguments
19. examples  - main path 16: the twins of the JAX examples
                (``examples/*_torch.py``) at their settings, uncut.  The
                quickstart, in a spawned process since phase 8: its LM
                trained 60 steps, losses held to the same function on
                the CPU (fp32 compute within 1e-4, the example's bf16
                within twice the CPU's own bf16 distance from fp32),
                served (8 greedy tokens equal to the CPU's; flash
                launches = 2 x waves, each held to the plain version on
                its own inputs; no other kernel), then FlexAI's
                loop trainer on the simulated HMAI (3 episodes of its
                10,282-task queue; its first 300 training actions equal
                to a CPU agent's from the same weights, each difference
                a tie of the card's Q values); then the driving pipeline:
                pools calibrated on the card, FlexAI trained on a
                simulated copy and its placements of 400 tasks run on the
                pools, against ``worst``; each dataflow kernel's
                launches = the convolutions its pool ran (calibration and
                every frame, at phase 11's counts a frame).  The failures
                twin runs in phase 16c

The launch counters are set to 0 just before each main path and read just
after it.  Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without a CUDA device.
"""
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) and
# bf16 (dense tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# device time of each redesigned kernel before its redesign, at the shapes
# its entry is timed at, as PERF.md section 6 records it (NVIDIA H100 80GB
# HBM3, 700 W): the conv kernels at YOLO's / SSD's largest layers (SconvOD
# at YOLO's only), flash attention at B 4, S 1024, H 32, D 64, bf16,
# causal, the TD update (and its grads variant) at B 64, the SSD scan at
# B 4, S 1024, H 24, P 64, N 128, chunk 256, bf16.  A record, not
# measured by this script: it is printed on a line of its own, never in
# the kernels line.
PREV_MS = {"sconv_od": 0.6557, "mconv_mc": [0.2317, 0.3799],
           "sconv_ic": [0.3966, 0.6367], "flash_attention": 0.8845,
           "dqn_td": 0.3723, "dqn_td_grads": 0.3429, "ssd_scan": 0.7421}
D, A, H1, H2 = 58, 11, 256, 64   # n = 11 accelerators: D = 3 + 5n, A = n
T_START = time.perf_counter()


def stamp(what):
    """The seconds since the script started, before phase ``what``, on
    standard error (flushed), so that a run stopped at its time limit
    still shows the phase it was in and how long each before it took."""
    print(f"chip_smoke +{time.perf_counter() - T_START:.1f} s: {what}",
          file=sys.stderr, flush=True)


D_STAGE = 70                      # the stage agent's observation: 4 + 6n
SMALL = dict(route_km=0.01, rate_scale=0.012, max_times_turn=2,
             max_times_reverse=1, max_duration_turn=4.0,
             max_duration_reverse=5.0, seed=2)


def close(got, want, rtol, atol, what):
    """Max abs error of got vs want; raises past atol + rtol * |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: max abs error {float(err.max())} "
                             f"beyond rtol {rtol} / atol {atol}")
    return float(err.max())


def device_ms(fn, n=60, block=4, warm=5):
    """Median device time of one call of ``fn``, over ``n`` calls timed
    each with a pair of CUDA events.  The calls go in blocks of
    ``block``, each block behind a sleep kernel that keeps the card busy
    while the host enqueues it, so the events time the device's work and
    not the host's launch overhead.  (Blocks stay small so a plain
    version of ~100 launches a call cannot fill the launch queue, which
    would stall the host until the sleep ends.)  Also returns the median
    host wall time of a synchronised call."""
    import torch
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    times = []
    for _ in range(n // block):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(block)]
        torch.cuda._sleep(int(min(4e9, 3 * block * wall * 2e9)))
        for e0, e1 in ev:
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        times += [e0.elapsed_time(e1) for e0, e1 in ev]
    return statistics.median(times), wall * 1e3


def td_bound_ms(b, fold_adam, lanes=1, shared_nets=False, D=D):
    """Least time for one TD update (of ``lanes`` lanes) on the card at
    state width ``D``: each input read once, each output written once,
    over HBM bandwidth; the arithmetic over the fp32 peak.
    ``shared_nets``: the two nets are read once for all lanes (the DP
    trainer's grads launch).  Returns (ms, "bytes" or "operations")."""
    p = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A
    nets_in, nets_out = (4, 3) if fold_adam else (2, 1)
    nets_read = (2 + lanes * (nets_in - 2)) * p if shared_nets else \
        lanes * nets_in * p
    nbytes = 4 * (nets_read + lanes * (2 * b * D + 3 * b + nets_out * p + 1
                                       + (1 if fold_adam else 0)))
    macs = (3 * b * (D * H1 + H1 * H2 + H2 * A)     # 3 forwards
            + b * H2 * H1                            # dh1
            + b * (D * H1 + H1 * H2 + H2 * A))       # dW1, dW2, dW3
    flops = lanes * (2 * macs + p * (12 if fold_adam else 3))  # clip, Adam
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def td_inputs(torch, rng, d):
    """``params(scale=None)`` and ``batch(b)`` makers of random TD
    operands at state width ``d`` on the card."""
    from repro_torch.core.flexai import dqn
    dev = torch.device("cuda")
    shapes = [(d, H1), (H1,), (H1, H2), (H2,), (H2, A), (A,)]

    def params(scale=None):
        return dqn.params_from_numpy(
            [rng.uniform(-0.15, 0.15, s) if scale is None
             else rng.random(s) * scale for s in shapes], dev)

    def batch(b):
        t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=dev)  # noqa: E731
        return {"s": t(rng.normal(size=(b, d))),
                "a": t(rng.integers(0, A, b), torch.int32),
                "r": t(rng.normal(size=b) * 3.0),
                "s_next": t(rng.normal(size=(b, d))),
                "done": t(rng.random(b) < 0.2)}

    return params, batch


def phase_kernels(torch, rng):
    from repro_torch.core.flexai import dqn
    from repro_torch.kernels.dqn_update import (dqn_td_grads_fused,
                                                dqn_td_update_fused)
    dev = torch.device("cuda")
    params, batch = td_inputs(torch, rng, D)
    max_err, timing = 0.0, {}
    for b in (64, 100, 128):
        ep, tp, bt = params(), params(), batch(b)
        opt = dqn.AdamState(torch.tensor(6, dtype=torch.int32, device=dev),
                            dqn.DQNParams(*[m - 1e-3 for m in params(2e-3)]),
                            params(1e-6))
        loss, grads = dqn_td_grads_fused(ep, tp, bt)
        loss_r, grads_r = dqn.dqn_td_grads(ep, tp, bt)
        torch.cuda.synchronize()
        errs = [close(loss, loss_r, 1e-5, 1e-6, f"B={b} grads loss")]
        errs += [close(g, r, 1e-5, 1e-6, f"B={b} grad p{i}")
                 for i, (g, r) in enumerate(zip(grads, grads_r))]
        new_p, new_opt, loss = dqn_td_update_fused(ep, tp, opt, bt, lr=1e-3)
        ref_p, ref_opt, loss_r = dqn.dqn_td_update(ep, tp, opt, bt, lr=1e-3)
        torch.cuda.synchronize()
        errs.append(close(loss, loss_r, 1e-5, 1e-6, f"B={b} update loss"))
        for i in range(6):
            # Adam's m_hat / sqrt(v_hat) amplifies rounding where |g| is
            # near eps: params at atol 1e-6 (about lr x 1e-3)
            errs.append(close(new_p[i], ref_p[i], 0, 1e-6,
                              f"B={b} param p{i}"))
            errs.append(close(new_opt.mu[i], ref_opt.mu[i], 1e-5, 1e-7,
                              f"B={b} mu p{i}"))
            errs.append(close(new_opt.nu[i], ref_opt.nu[i], 1e-5, 1e-12,
                              f"B={b} nu p{i}"))
        assert int(new_opt.step) == 7
        max_err = max(max_err, *errs)
        print(f"kernel check B={b}: both variants within tolerance, "
              f"max abs error {max(errs):.3e}")
        if b == 64:   # the main path's batch (FlexAIConfig.batch_size)
            timing["update"] = device_ms(
                lambda: dqn_td_update_fused(ep, tp, opt, bt, lr=1e-3))
            timing["update_plain"] = device_ms(
                lambda: dqn.dqn_td_update(ep, tp, opt, bt, lr=1e-3))
            timing["grads"] = device_ms(lambda: dqn_td_grads_fused(ep, tp, bt))
            timing["grads_plain"] = device_ms(
                lambda: dqn.dqn_td_grads(ep, tp, bt))
    for k, (ms, wall) in timing.items():
        print(f"  B=64 {k}: {ms:.4f} ms on the device, {wall:.4f} ms per "
              f"synchronised call")
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    timing["plan"] = td_kernel.td_plan(64, D, A)
    print(f"  TD plan at B=64: {timing['plan']}")
    timing["lanes"], lane_err = phase_td_lanes(torch, params, batch)
    timing["stage"], stage_err = phase_td_stage(torch, rng)
    return max(max_err, lane_err, stage_err), timing


def phase_td_stage(torch, rng):
    """The TD kernel at the stage agent's width (D = 70, A = 11: the
    observation of ``pipeline.stage_state_dim(11)``), B 64, against its
    plain version: the single-lane launch of both variants, and the lane
    launch at L = 4 as the stage trainers call it (grads with the nets
    shared, Adam with a net a lane).  Then the single-lane Adam variant,
    the stage trainer's launch, timed beside the plain version."""
    from repro_torch.core.flexai import dqn
    from repro_torch.kernels.dqn_update import (dqn_td_grads_fused,
                                                dqn_td_grads_lanes,
                                                dqn_td_grads_lanes_ref,
                                                dqn_td_update_fused,
                                                dqn_td_update_lanes,
                                                dqn_td_update_lanes_ref)
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    dev = torch.device("cuda")
    params, batch = td_inputs(torch, rng, D_STAGE)
    lanes = 4

    def stack(trees):
        return type(trees[0])(*[torch.stack(x) for x in zip(*trees)])

    def opt(lead):
        mu = [dqn.DQNParams(*[m - 1e-3 for m in params(2e-3)])
              for _ in range(max(lead, 1))]
        nu = [params(1e-6) for _ in range(max(lead, 1))]
        if not lead:
            return dqn.AdamState(torch.tensor(6, dtype=torch.int32,
                                              device=dev), mu[0], nu[0])
        return dqn.AdamState(torch.arange(lead, dtype=torch.int32,
                                          device=dev) + 3,
                             stack(mu), stack(nu))

    def check(tag, upd, ref, grads, grads_r):
        (new_p, new_opt, loss), (ref_p, ref_opt, loss_r) = upd, ref
        errs = [close(loss, loss_r, 1e-5, 1e-6, f"{tag} update loss"),
                close(grads[0], grads_r[0], 1e-5, 1e-6, f"{tag} grads loss")]
        for i in range(6):
            errs += [close(new_p[i], ref_p[i], 0, 1e-6, f"{tag} param p{i}"),
                     close(new_opt.mu[i], ref_opt.mu[i], 1e-5, 1e-7,
                           f"{tag} mu p{i}"),
                     close(new_opt.nu[i], ref_opt.nu[i], 1e-5, 1e-12,
                           f"{tag} nu p{i}"),
                     close(grads[1][i], grads_r[1][i], 1e-5, 1e-6,
                           f"{tag} grad p{i}")]
        return errs

    ep, tp, bt, op = params(), params(), batch(64), opt(0)
    errs = check("D=70", dqn_td_update_fused(ep, tp, op, bt, lr=1e-3),
                 dqn.dqn_td_update(ep, tp, op, bt, lr=1e-3),
                 dqn_td_grads_fused(ep, tp, bt), dqn.dqn_td_grads(ep, tp, bt))
    nets = [params() for _ in range(2 * lanes)]
    eps, tps = stack(nets[:lanes]), stack(nets[lanes:])
    bts = [batch(64) for _ in range(lanes)]
    bl = {k: torch.stack([b[k] for b in bts]) for k in bts[0]}
    ol = opt(lanes)
    errs += check("D=70 L=4", dqn_td_update_lanes(eps, tps, ol, bl, lr=1e-3),
                  dqn_td_update_lanes_ref(eps, tps, ol, bl, lr=1e-3),
                  dqn_td_grads_lanes(ep, tp, bl),
                  dqn_td_grads_lanes_ref(ep, tp, bl))
    torch.cuda.synchronize()
    err = max(errs)
    print(f"kernel check D={D_STAGE}, A={A}, B=64 (the stage agent): "
          f"single-lane and L={lanes} lane launches, both variants, within "
          f"tolerance, max abs error {err:.3e}; plan "
          f"{td_kernel.td_plan(64, D_STAGE, A)}")
    out = {"update": device_ms(
        lambda: dqn_td_update_fused(ep, tp, op, bt, lr=1e-3)),
        "update_plain": device_ms(
        lambda: dqn.dqn_td_update(ep, tp, op, bt, lr=1e-3)),
        "update_lanes": device_ms(
        lambda: dqn_td_update_lanes(eps, tps, ol, bl, lr=1e-3))[0],
        "grads_lanes": device_ms(
        lambda: dqn_td_grads_lanes(ep, tp, bl))[0],
        "plan": td_kernel.td_plan(64, D_STAGE, A),
        "bound": td_bound_ms(64, True, D=D_STAGE)}
    print(f"  D={D_STAGE} B=64 update: {out['update'][0]:.4f} ms on the "
          f"device ({out['update'][1]:.4f} ms a synchronised call), plain "
          f"{out['update_plain'][0]:.4f} ms, bound {out['bound'][0]:.6f} ms "
          f"({out['bound'][1]}); L={lanes}: update {out['update_lanes']:.4f}"
          f" ms, grads (nets shared) {out['grads_lanes']:.4f} ms")
    return out, err


def phase_td_lanes(torch, params, batch):
    """The lane-batched launch (one cluster a lane) against its plain
    version at L = 4, both variants as the trainers call them: grads with
    the nets shared (the DP trainer, lane stride 0), Adam with a net,
    moments and step a lane (the population trainer); then both timed at
    L = 1, 4 and 16 beside the plain version at L = 4."""
    from repro_torch.core.flexai import dqn
    from repro_torch.kernels.dqn_update import (dqn_td_grads_lanes,
                                                dqn_td_grads_lanes_ref,
                                                dqn_td_update_lanes,
                                                dqn_td_update_lanes_ref)
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    dev = torch.device("cuda")

    def stack(trees):
        return type(trees[0])(*[torch.stack(x) for x in zip(*trees)])

    def case(lanes):
        nets = [params() for _ in range(2 * lanes)]
        opt = dqn.AdamState(
            torch.arange(lanes, dtype=torch.int32, device=dev) + 3,
            stack([dqn.DQNParams(*[m - 1e-3 for m in params(2e-3)])
                   for _ in range(lanes)]),
            stack([params(1e-6) for _ in range(lanes)]))
        bts = [batch(64) for _ in range(lanes)]
        return (nets[0], nets[1], stack(nets[:lanes]), stack(nets[lanes:]),
                {k: torch.stack([b[k] for b in bts]) for k in bts[0]}, opt)

    ep, tp, eps, tps, bt, opt = case(4)
    loss, grads = dqn_td_grads_lanes(ep, tp, bt)
    loss_r, grads_r = dqn_td_grads_lanes_ref(ep, tp, bt)
    new_p, new_opt, uloss = dqn_td_update_lanes(eps, tps, opt, bt, lr=1e-3)
    ref_p, ref_opt, uloss_r = dqn_td_update_lanes_ref(eps, tps, opt, bt,
                                                      lr=1e-3)
    torch.cuda.synchronize()
    errs = [close(loss, loss_r, 1e-5, 1e-6, "L=4 grads loss"),
            close(uloss, uloss_r, 1e-5, 1e-6, "L=4 update loss")]
    for i in range(6):
        errs += [close(grads[i], grads_r[i], 1e-5, 1e-6, f"L=4 grad p{i}"),
                 close(new_p[i], ref_p[i], 0, 1e-6, f"L=4 param p{i}"),
                 close(new_opt.mu[i], ref_opt.mu[i], 1e-5, 1e-7,
                       f"L=4 mu p{i}"),
                 close(new_opt.nu[i], ref_opt.nu[i], 1e-5, 1e-12,
                       f"L=4 nu p{i}")]
    assert torch.equal(new_opt.step, opt.step + 1)
    err = max(errs)
    print(f"kernel check L=4 lanes, B=64: grads (nets shared) and update "
          f"(a net a lane) within tolerance, max abs error {err:.3e}")
    out = {"plan": td_kernel.td_plan(64, D, A, lanes=4)}
    print(f"  TD plan at L=4: {out['plan']}")
    for lanes in (1, 4, 16):
        ep, tp, eps, tps, bt, opt = case(lanes)
        out[lanes] = {
            "grads": device_ms(lambda: dqn_td_grads_lanes(ep, tp, bt))[0],
            "update": device_ms(lambda: dqn_td_update_lanes(
                eps, tps, opt, bt, lr=1e-3))[0]}
        if lanes == 4:
            out["plain"] = {
                "grads": device_ms(
                    lambda: dqn_td_grads_lanes_ref(ep, tp, bt))[0],
                "update": device_ms(lambda: dqn_td_update_lanes_ref(
                    eps, tps, opt, bt, lr=1e-3))[0]}
    for v in ("grads", "update"):
        print(f"  lanes, B=64 {v}: " + ", ".join(
            f"L={n} {out[n][v]:.4f} ms" for n in (1, 4, 16))
            + f" on the device; plain at L=4 {out['plain'][v]:.4f} ms; "
            f"L=4 / (4 x L=1) = {out[4][v] / (4 * out[1][v]):.3f}")
    return out, err


def phase_small(torch, rng, dev="cuda"):
    """CUDA trainer (fused kernel) and service vs the same on the CPU."""
    import numpy as np

    from repro_torch.core import environment as env
    from repro_torch.core.flexai import FlexAIConfig, dqn
    from repro_torch.core.flexai import engine
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import (kind_feature_table,
                                           platform_init, spec_from_platform,
                                           state_vector)
    from repro_torch.core.tasks import TaskArrays, tasks_to_arrays
    from repro_torch.serve.engine import FlexAIPlacementService

    plat = HMAIPlatform(capacity_scale=SMALL["rate_scale"])
    n = plat.n
    queue = env.build_task_queue(env.EnvironmentParams(**SMALL))
    cfg = FlexAIConfig(min_replay=16, batch_size=16, update_every=1,
                       target_sync_every=8, replay_capacity=512)
    t_len = len(queue)
    size = np.minimum(np.arange(1, t_len + 1), cfg.replay_capacity)
    draws = engine.Draws(
        torch.tensor(rng.random(t_len), dtype=torch.float32),
        torch.tensor(rng.integers(0, n, t_len)),
        torch.tensor(np.stack([rng.integers(0, s, cfg.batch_size)
                               for s in size])))
    params = engine.train_init(3 + 5 * n, n, 8).eval_p
    out = {}
    for d in ("cpu", dev):
        run = engine.make_train_fn(spec_from_platform(plat, d), cfg,
                                   td_kernel=True)
        ts = engine.train_init(3 + 5 * n, n, cfg.replay_capacity, device=d)
        p = dqn.DQNParams(*[w.to(d) for w in params])
        ts = ts._replace(eval_p=p, targ_p=p, opt=dqn.adam_init(p))
        ts, _, recs, losses, upd = run(ts, tasks_to_arrays(queue), draws)
        out[d] = (ts, recs.action.cpu(), losses.cpu(), upd)
    (ts_c, act_c, loss_c, upd_c), (ts_g, act_g, loss_g, upd_g) = \
        out["cpu"], out[dev]
    assert torch.equal(act_c, act_g), "CUDA trainer took other actions"
    assert torch.equal(upd_c, upd_g) and int(upd_g.sum()) > 50
    close(loss_g[upd_g], loss_c[upd_c], 1e-4, 1e-7, "trainer losses")
    for i, (g, c) in enumerate(zip(ts_g.eval_p, ts_c.eval_p)):
        close(g, c, 0, 1e-4, f"trained param p{i}")
    print(f"small trainer: {t_len} tasks, {int(upd_g.sum())} kernel "
          f"updates on {dev} match the CPU run (actions equal, losses "
          f"rtol 1e-4, params atol 1e-4)")

    queues = [env.build_task_queue(env.EnvironmentParams(
        **{**SMALL, "seed": s})) for s in (8, 12, 31)]
    res = {d: FlexAIPlacementService(plat, ts_c.eval_p, device=d)
           .place(queues) for d in ("cpu", dev)}
    spec = spec_from_platform(plat)
    feat = torch.as_tensor(kind_feature_table())
    for q, rc, rg in zip(queues, res["cpu"], res[dev]):
        diff = np.nonzero(rc["placements"] != rg["placements"])[0]
        if len(diff):
            # a matmul-rounding tie: the CPU's Q margin must be tiny
            k = int(diff[0])
            ta = tasks_to_arrays(q)
            state = platform_init(n)
            if k:
                state = engine.make_schedule_fn(spec, batched=True)(
                    ts_c.eval_p, TaskArrays(*[f[None, :k] for f in ta]))[0]
            sv = state_vector(spec, feat, 1.0, state,
                              TaskArrays(*[f[k:k + 1] for f in ta]))
            qv = dqn.qnet_apply(ts_c.eval_p, sv)[0]
            margin = float(qv[rc["placements"][k]] - qv[rg["placements"][k]])
            assert margin < 1e-4, f"placement {k} differs, margin {margin}"
        else:
            assert rc["stm_rate"] == rg["stm_rate"]
    print(f"small service: {dev} placements match the CPU's on 3 routes")


# (n, h, w, cin, cout, k, stride): the JAX kernel tests' shapes, then the
# edge cases each kernel must get right
CONV_CASES = [
    (1, 8, 8, 4, 8, 3, 1), (2, 12, 10, 8, 16, 5, 1), (1, 6, 6, 3, 5, 1, 1),
    (2, 16, 16, 16, 32, 3, 1),
    (2, 15, 11, 11, 4, 3, 1),      # Cin = 11: a partial 8-channel tile
    (1, 515, 8, 2, 4, 3, 1),       # Ho = 513 = 64 x 8 + 1, row_tile 8
    (1, 227, 227, 3, 201, 11, 4),  # 11x11 stride 4 (GOTURN, full width)
    (1, 17, 17, 25, 51, 3, 2),     # odd widths, stride 2
]
CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}


def conv_bound_ms(x, w, out):
    """Least time for one conv on the card: x, w read once and out written
    once over HBM bandwidth; 2 * N*Ho*Wo * KH*KW*Cin * Cout FLOPs over the
    fp32 peak.  Returns (ms, "bytes" or "operations")."""
    kh, kw, cin, cout = w.shape
    flops = 2 * out.shape[0] * out.shape[1] * out.shape[2] * kh * kw * cin \
        * cout
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def largest_conv(name):
    """The conv layer of ``name`` at full width with the most MACs, as
    (k, cin, cout, out_hw, stride, padded input hw)."""
    from repro_torch.models.perception.nets import PERCEPTION_SPECS
    from repro_torch.models.perception.stats import convnet_stats
    spec, width = PERCEPTION_SPECS[name]
    layer = max((l for l in convnet_stats(spec, width)["per_layer"]
                 if l["kind"] == "conv"), key=lambda l: l["macs"])
    k, s, out = layer["k"], layer["stride"], layer["hw"]
    return k, layer["c_in"], layer["c_out"], out, s, (out - 1) * s + k


# a conv of the pools at the example's settings: YOLO at width 0.1 on a
# 64x64 batch of 4, a 3x3 layer 51 -> 102 at 2x2 output (K = 459, the
# longest reduction among its common convs)
LAUNCH_CASE = (4, 4, 4, 51, 102, 3, 1)


def conv_launch_us(torch, blocks=5, n=200):
    """Each dataflow's ``conv2d_cuda`` at LAUNCH_CASE: (host microseconds
    per call, enqueued and not synchronised, the median of ``blocks``
    blocks of ``n`` calls, short enough that the launch queue never fills;
    device microseconds per call, ``device_ms``).  Takes only the
    binding's public call, so it times an older checkout's package too."""
    from repro_torch.kernels.conv_dataflow import DATAFLOWS
    from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
    b, h, wd, ci, co, k, s = LAUNCH_CASE
    x = torch.zeros(b, h, wd, ci, device="cuda")
    w = torch.zeros(k, k, ci, co, device="cuda")
    res = {}
    for df in DATAFLOWS:
        def call():
            conv_kernel.conv2d_cuda(x, w, dataflow=df, stride=s)
        host = []
        for _ in range(blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            host.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        res[df] = (statistics.median(host), device_ms(call)[0] * 1e3)
    return res


def phase_conv(torch, rng, card):
    """Each conv kernel against the plain version on the card, then timed
    (kernel, plain, F.conv2d without TF32) at YOLO's and SSD's largest
    layers.  Returns {dataflow: {...}} for the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv_dataflow import (DATAFLOWS, conv2d,
                                                   conv2d_ref)
    from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
    from repro_torch.models.perception.cnn import same_pads
    dev = torch.device("cuda")
    res = {df: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
           for df in DATAFLOWS}

    def inputs(n, h, w_, ci, co, k):
        x = torch.tensor(rng.normal(size=(n, h, w_, ci)), dtype=torch.float32)
        w = torch.tensor(rng.normal(size=(k, k, ci, co)) * 0.2,
                         dtype=torch.float32)
        return x.to(dev), w.to(dev)

    for case in CONV_CASES:
        x, w = inputs(*case[:6])
        for dtype in ("float32", "bfloat16"):
            xd, wd = x.to(getattr(torch, dtype)), w.to(getattr(torch, dtype))
            want = conv2d_ref(xd, wd, case[6])
            for df in DATAFLOWS:
                got = conv2d(xd, wd, dataflow=df, stride=case[6])
                torch.cuda.synchronize()
                assert got.dtype == xd.dtype and got.shape == want.shape
                err = close(got, want, *CONV_TOL[dtype],
                            f"{df} {dtype} case {case}")
                key = "max_abs_err" if dtype == "float32" else \
                    "max_abs_err_bf16"
                res[df][key] = max(res[df][key], err)
    # even H, stride 2: the JAX wrapper's SAME, and the CNN's XLA SAME
    x, w = inputs(2, 32, 32, 5, 9, 3)
    lo, hi = same_pads(32, 3, 2)
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    for df in DATAFLOWS:
        for xin, pad in ((x, "SAME"), (xp, "VALID")):
            got = conv2d(xin, w, dataflow=df, stride=2, padding=pad)
            want = conv2d(xin, w, dataflow="ref", stride=2, padding=pad)
            torch.cuda.synchronize()
            assert got.shape == (2, 16, 16, 9)
            res[df]["max_abs_err"] = max(res[df]["max_abs_err"], close(
                got, want, 1e-4, 1e-4, f"{df} even-H stride 2 {pad}"))
    for df in DATAFLOWS:
        print(f"conv check {df}: {len(CONV_CASES) + 1} shapes within "
              f"tolerance, max abs error f32 {res[df]['max_abs_err']:.3e} "
              f"(rtol/atol 1e-4), bf16 {res[df]['max_abs_err_bf16']:.3e} "
              f"(5e-2)")

    for net in ("yolo", "ssd"):
        k, cin, cout, out_hw, s, hp = largest_conv(net)
        x = torch.tensor(rng.normal(size=(1, hp, hp, cin)),
                         dtype=torch.float32, device=dev)
        w = torch.tensor(rng.normal(size=(k, k, cin, cout))
                         / math.sqrt(k * k * cin), dtype=torch.float32,
                         device=dev)
        want = conv2d_ref(x, w, s)
        plain = device_ms(lambda: conv2d_ref(x, w, s))
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib = F.conv2d(xn, wn, stride=s).permute(0, 2, 3, 1)
            close(lib, want, 1e-4, 1e-4, f"F.conv2d at {net}'s layer")
            library = device_ms(lambda: F.conv2d(xn, wn, stride=s))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        bound, bound_by = conv_bound_ms(x, w, want)
        shape = f"{k}x{k} {cin}->{cout} stride {s}, {hp}x{hp} -> {out_hw}" \
            f"x{out_hw}, batch 1, f32"
        print(f"{net}'s largest conv ({shape}): bound {bound:.5f} ms "
              f"({bound_by}), plain {plain[0]:.4f} ms, F.conv2d (no TF32) "
              f"{library[0]:.4f} ms on {card}")
        for df in DATAFLOWS:
            splits = conv_kernel.conv_splits(df, x.shape, w.shape, s)
            plan = conv_kernel.conv_plan(df, x.shape, w.shape, s)
            got = conv_kernel.conv2d_cuda(x, w, dataflow=df, stride=s)
            close(got, want, 1e-4, 1e-4, f"{df} at {net}'s layer")
            # split sums in a fixed order: the same bits
            again = conv_kernel.conv2d_cuda(x, w, dataflow=df, stride=s)
            assert torch.equal(got, again), f"{df} at {net}: not bit-equal"
            ms = device_ms(lambda: conv_kernel.conv2d_cuda(
                x, w, dataflow=df, stride=s))
            print(f"  {df}: {ms[0]:.4f} ms on the device "
                  f"({bound / ms[0] * 100:.1f}% of the bound), "
                  f"{ms[1]:.4f} ms per synchronised call, two calls "
                  f"bit-equal; plan: {plan}")
            res[df][net] = {"layer": shape, "ms": ms[0], "call_ms": ms[1],
                            "plain_ms": plain[0], "bound_ms": bound,
                            "bound_by": bound_by, "library_ms": library[0],
                            "splits": splits, "plan": plan}
    launch = conv_launch_us(torch)
    print(f"a conv of the example's pools, {LAUNCH_CASE} (n, h, w, cin, "
          f"cout, k, stride): host us per call (not synchronised) / device "
          f"us: " + ", ".join(f"{df} {hu:.2f} / {du:.2f}"
                              for df, (hu, du) in launch.items()))
    b, h, wd, ci, co, k, s = LAUNCH_CASE
    for df, (hu, du) in launch.items():
        res[df]["launch_host_us"], res[df]["launch_device_us"] = hu, du
        print(f"  {df}'s plan there: " + conv_kernel.conv_plan(
            df, (b, h, wd, ci), (k, k, ci, co), s))
    return res


def phase_perception(torch, rng, card):
    """Full-width YOLO, SSD and a GOTURN pair through each dataflow,
    batch 1, held to the plain path (dataflow "ref") on the card.
    Returns {dataflow: {net: (launches per frame, ms per frame)}}."""
    from repro_torch.kernels.conv_dataflow import DATAFLOWS
    from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
    from repro_torch.models.perception import nets
    from repro_torch.models.perception.stats import convnet_stats
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    img = lambda hw: torch.tensor(  # noqa: E731
        rng.normal(size=(1, hw, hw, 3)), dtype=torch.float32, device=dev)
    yolo, ssd = nets.init_yolo(gen, device=dev), nets.init_ssd(gen, device=dev)
    goturn = nets.init_goturn(gen, device=dev)
    x_yolo, x_ssd, prev, curr = img(416), img(512), img(227), img(227)
    runs = {
        "yolo": lambda df: nets.yolo_apply(yolo, x_yolo, dataflow=df),
        "ssd": lambda df: nets.ssd_apply(ssd, x_ssd, dataflow=df),
        "goturn": lambda df: nets.goturn_apply(goturn, prev, curr,
                                               dataflow=df),
    }
    shapes = {"goturn": (1, 4)}
    for net in ("yolo", "ssd"):
        last = convnet_stats(*nets.PERCEPTION_SPECS[net])["per_layer"][-1]
        shapes[net] = (1, last["hw"], last["hw"], last["c_out"])
    res = {df: {} for df in DATAFLOWS}
    print(f"perception at full width, batch 1 (ms per frame on {card}; "
          f"device time, then the synchronised call):")
    for net, run in runs.items():
        ref = run("ref")
        torch.cuda.synchronize()
        assert tuple(ref.shape) == shapes[net] and bool(ref.isfinite().all())
        scale = float(ref.abs().max())
        # one frame per sleep block: a frame is ~240 launches through the
        # kernels and ~1,000 through the plain path, and a block of 4
        # would fill the launch queue and stall the host behind the sleep
        plain = device_ms(lambda: run("ref"), n=8, block=1, warm=2)
        line = [f"  {net}: plain {plain[0]:.3f} / {plain[1]:.3f}"]
        for df in DATAFLOWS:
            for k in conv_kernel.launches:
                conv_kernel.launches[k] = 0
            out = run(df)
            torch.cuda.synchronize()
            n_launch = conv_kernel.launches[df]
            err = float((out - ref).abs().max()) / scale
            if not (err <= 1e-3 and bool(out.isfinite().all())):
                raise AssertionError(f"{net} through {df}: error {err} of "
                                     f"max|ref| {scale}, beyond 1e-3")
            ms = device_ms(lambda: run(df), n=8, block=1, warm=2)
            res[df][net] = {"launches_per_frame": n_launch,
                            "ms_per_frame": ms[0], "call_ms": ms[1],
                            "plain_ms": plain[0], "rel_err": err}
            line.append(f"{df} {ms[0]:.3f} / {ms[1]:.3f} ({n_launch} "
                        f"launches, err {err:.1e} of max|ref|)")
        print(", ".join(line))
    return res


def phase_pipeline(torch, card, full_width=False):
    """``launch/drive.py`` on the card, at its defaults or with
    ``--full-width``.  Returns what ``run_pipeline`` returned."""
    from repro_torch.launch import drive
    argv = ["--device", "cuda"] + (["--full-width"] if full_width else [])
    args = drive.parser().parse_args(argv)
    print(f"pipeline (launch/drive.py {' '.join(argv)}) on {card}:")
    res = drive.run_pipeline(args, log=lambda m: print("  " + m))
    plat = res["platform"]
    assert plat.device.type == "cuda" and plat.n == 3
    for pool in plat.pools:
        fps = pool.measured_fps
        assert set(fps) == {"yolo", "ssd", "goturn"}
        assert all(math.isfinite(v) and v > 0 for v in fps.values())
    for key in ("flexai", "worst"):
        assert res[key]["tasks"] == res["tasks"] > 0
    assert res["trainer"].ts.updates > 0
    # the redesigned dataflows' pools beside SconvOD's, whose kernel this
    # run shares with the last: its rate is the control for host noise
    fps = {p.spec.archetype: p.measured_fps for p in plat.pools}
    ctrl = fps["SconvOD"]
    print(f"  pool fps ({' / '.join(ctrl)}): " + "; ".join(
        f"{df} " + " / ".join(f"{fps[df][k]:.1f}" for k in ctrl)
        + ("" if df == "SconvOD" else " (x" + " / x".join(
            f"{fps[df][k] / ctrl[k]:.2f}" for k in ctrl) + " SconvOD's)")
        for df in ("MconvMC", "SconvIC", "SconvOD")))
    return res


def bound_ms(tensors, flops, dtype):
    """Least time on the card: each tensor in ``tensors`` (inputs and
    outputs) moved once over HBM bandwidth, ``flops`` at the peak for the
    inputs' type.  Returns (ms, "bytes" or "operations")."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# (b, s, h, kh, d, causal): the JAX kernel tests' shapes, then ragged
# lengths, head dim 128, stablelm's heads and its serving waves' shapes,
# then the heads of the rest of the zoo at a serving wave's length and a
# ragged short prompt: h2o-danube (D 120, zero-padded to the kernel's
# 128), qwen3-moe (32 over 4), moonshot (16 of 128), mistral-large (96
# over 8); jamba's attention layer has mistral's group shape, 32 over 8;
# seamless's encoder, not causal, at the serving engine's one-frame
# source and at the longest wave's 1,491 // 4 frames; internvl2's 64 heads
# over 8 at a 300-token prompt after its 256 patches; the quickstart
# twin's served prefill (one 3-token prompt in 2 slots, shorter than a
# tile)
ATTN_CASES = [
    (1, 64, 4, 4, 32, True), (2, 128, 4, 2, 16, True),
    (1, 64, 2, 1, 32, False), (2, 96, 8, 8, 64, True),
    (1, 77, 4, 2, 64, True), (2, 1000, 4, 1, 64, False),
    (1, 1000, 8, 2, 128, True), (1, 77, 4, 4, 128, False),
    (2, 300, 32, 32, 64, True),
    (4, 1491, 32, 32, 64, True), (2, 590, 32, 32, 64, True),  # stablelm waves
    (4, 1491, 32, 8, 120, True), (1, 77, 32, 8, 120, True),   # danube
    (4, 1491, 32, 4, 64, True), (1, 77, 32, 4, 64, True),     # qwen3-moe
    (4, 1491, 16, 16, 128, True), (1, 77, 16, 16, 128, True),  # moonshot
    (4, 1491, 96, 8, 128, True), (1, 77, 96, 8, 128, True),   # mistral
    (4, 1491, 32, 8, 128, True),                              # jamba
    (4, 1, 16, 16, 64, False), (4, 372, 16, 16, 64, False),   # seamless
    (1, 556, 64, 8, 128, True),                               # internvl2
    (2, 3, 4, 2, 16, True),                                   # quickstart
]
# (b, s): minicpm3's MLA prefill (40 heads, q/k dim 96, V dim 64 padded
# to 96 by attention_core), against the plain attention of the unpadded V
MLA_CASES = [(4, 1491), (1, 77)]
# (rtol, atol).  bf16: the plain versions sum in fp32 and round once to
# bf16.  The SSD kernel does the same; the flash kernel feeds P to the
# tensor cores as a bf16 pair hi + lo (2^-17 of each weight, where a single
# bf16 P would move outputs of few-key rows by up to 2^-9 of |v|, past
# atol), so both sides stay within about one bf16 step (2^-7 of the value)
# of each other; a dropped or doubled KV tile or chunk moves an output far
# more than that
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}


def mla_route_check(torch, rng):
    """``attention_core`` on MLA's shapes (V narrower than q/k: zero-padded
    into the flash kernel, the output's first 64 columns kept) against
    ``attention_ref`` of the unpadded V at scale 1/sqrt(96).  Returns the
    max abs error per dtype."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.attention import attention_core
    cfg = get_config("minicpm3-4b")
    h, dqk, dv = cfg.num_heads, cfg.head_dim, cfg.v_head_dim
    err = {"float32": 0.0, "bfloat16": 0.0}
    for b, s in MLA_CASES:
        q, k, v = (torch.tensor(rng.normal(size=(b, s, h, d)),
                                dtype=torch.float32, device="cuda")
                   for d in (dqk, dqk, dv))
        for dtype in err:
            qd, kd, vd = (x.to(getattr(torch, dtype)) for x in (q, k, v))
            got = attention_core(qd, kd, vd, cfg, causal=True)
            g = lambda x: x.transpose(1, 2).reshape(b * h, s, -1)  # noqa: E731
            want = attention_ref(g(qd), g(kd), g(vd), causal=True,
                                 scale=1.0 / math.sqrt(dqk))
            want = want.reshape(b, h, s, dv).transpose(1, 2)
            torch.cuda.synchronize()
            assert got.dtype == qd.dtype and tuple(got.shape) == (b, s, h,
                                                                  dv)
            err[dtype] = max(err[dtype], close(
                got, want, *KERNEL_TOL[dtype], f"flash MLA {dtype} {(b, s)}"))
    return err


def phase_attention(torch, rng, card):
    """The flash kernel against its plain version on the card, then timed
    at B 4, S 1024, H 32, D 64, bf16, causal (kernel, plain, SDPA)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops
    dev = torch.device("cuda")
    err = {"float32": 0.0, "bfloat16": 0.0}
    for b, s, h, kh, d, causal in ATTN_CASES:
        qkv = [torch.tensor(rng.normal(size=(b, s, n, d)),
                            dtype=torch.float32, device=dev)
               for n in (h, kh, kh)]
        for dtype in err:
            q, k, v = (x.to(getattr(torch, dtype)) for x in qkv)
            got = ops.flash_attention(q, k, v, causal=causal)
            want = flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert got.dtype == q.dtype and got.shape == q.shape
            err[dtype] = max(err[dtype], close(
                got, want, *KERNEL_TOL[dtype],
                f"flash {dtype} {(b, s, h, kh, d, causal)}"))
    print(f"attention check: {len(ATTN_CASES)} shapes x 2 dtypes within "
          f"tolerance, max abs error f32 {err['float32']:.3e} (rtol/atol "
          f"1e-4), bf16 {err['bfloat16']:.3e} (rtol 1e-2, atol 1e-3)")
    mla = mla_route_check(torch, rng)
    print(f"attention MLA route (minicpm3: H 40, q/k D 96, V 64 padded): "
          f"{len(MLA_CASES)} shapes x 2 dtypes within tolerance, max abs "
          f"error f32 {mla['float32']:.3e}, bf16 {mla['bfloat16']:.3e}")
    for dtype in err:
        err[dtype] = max(err[dtype], mla[dtype])

    b, s, h, d = 4, 1024, 32, 64
    q, k, v = (torch.tensor(rng.normal(size=(b, s, h, d)),
                            dtype=torch.bfloat16, device=dev)
               for _ in range(3))
    out = fk.flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    close(out, want, *KERNEL_TOL["bfloat16"], "flash at the timing shape")
    ms = device_ms(lambda: fk.flash_attention_cuda(q, k, v, causal=True))
    plain = device_ms(lambda: flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    close(lib.transpose(1, 2), want, 5e-2, 5e-2, "SDPA at the timing shape")
    library = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    flops = 4 * d * b * h * s * (s + 1) // 2      # causal pairs, q.k and p.v
    bound, bound_by = bound_ms((q, k, v, out), flops, q.dtype)
    bound32 = flops / FP32_FLOPS * 1e3
    print(f"flash at B {b}, S {s}, H {h}, D {d}, bf16, causal: kernel "
          f"{ms[0]:.4f} ms ({ms[1]:.4f} ms per synchronised call), plain "
          f"{plain[0]:.4f} ms, SDPA {library[0]:.4f} ms, bound "
          f"{bound:.5f} ms ({bound_by}; fp32 CUDA cores {bound32:.4f} ms) on "
          f"{card}")
    return {"max_abs_err": err["float32"], "max_abs_err_bf16":
            err["bfloat16"], "ms": ms[0], "call_ms": ms[1],
            "plain_ms": plain[0], "library_ms": library[0],
            "bound_ms": bound, "bound_by": bound_by,
            "bound_fp32_ms": bound32,
            "shape": f"B {b}, S {s}, H {h}, D {d}, bf16, causal"}


# (b, s, h, p, n, chunk): the JAX kernel tests' shapes, a ragged tail, a
# chunk that is not a multiple of 64, mamba2's widths at a ragged prompt,
# jamba's (128 heads, state 16) at a serving wave and a short prompt
SSD_CASES = [
    (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 1, 8, 16, 16),
    (2, 45, 3, 16, 8, 16), (1, 333, 2, 24, 16, 100),
    (2, 1437, 24, 64, 128, 256),
    (4, 1491, 128, 64, 16, 256), (1, 77, 128, 64, 16, 256),  # jamba
]


def ssd_inputs(torch, rng, b, s, h, p, n, dtype):
    import numpy as np
    t = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
    return (t(rng.normal(size=(b, s, h, p)) * 0.3).to(dtype),
            -t(np.abs(rng.normal(size=(b, s, h))) * 0.2),
            t(rng.normal(size=(b, s, n)) * 0.5).to(dtype),
            t(rng.normal(size=(b, s, n)) * 0.5).to(dtype))


def ssd_flops(b, s, h, p, n, q):
    """FLOPs the SSD function needs: per chunk of c rows, C.B^T over the
    c(c+1)/2 causal pairs once per batch row (it does not depend on the
    head), and per head the product of the masked scores with u over the
    same pairs, the chunk state B^T u and the off-diagonal C S_prev."""
    total = 0
    for start in range(0, s, q):
        c = min(q, s - start)
        pairs = c * (c + 1) // 2
        total += b * 2 * pairs * n + b * h * (2 * pairs * p + 4 * c * n * p)
    return total


def phase_ssd(torch, rng, card):
    """The SSD kernel against its plain version on the card, then timed at
    B 4, S 1024, H 24, P 64, N 128, chunk 256, bf16."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_ref as plain_ssd
    err = {"float32": 0.0, "bfloat16": 0.0}
    for b, s, h, p, n, chunk in SSD_CASES:
        for dtype in err:
            u, a, Bm, Cm = ssd_inputs(torch, rng, b, s, h, p, n,
                                      getattr(torch, dtype))
            y, st = ops.ssd_scan(u, a, Bm, Cm, chunk=chunk)
            yr, sr = plain_ssd(u, a, Bm, Cm, chunk=chunk)
            torch.cuda.synchronize()
            assert y.dtype == u.dtype and st.shape == (b, h, n, p)
            what = f"ssd {dtype} {(b, s, h, p, n, chunk)}"
            err[dtype] = max(err[dtype],
                             close(y, yr, *KERNEL_TOL[dtype], what + " y"),
                             close(st, sr, *KERNEL_TOL[dtype],
                                   what + " state"))
    print(f"ssd check: {len(SSD_CASES)} shapes x 2 dtypes within tolerance, "
          f"max abs error f32 {err['float32']:.3e} (rtol/atol 1e-4), bf16 "
          f"{err['bfloat16']:.3e} (rtol 1e-2, atol 1e-3)")

    b, s, h, p, n, q = 4, 1024, 24, 64, 128, 256
    u, a, Bm, Cm = ssd_inputs(torch, rng, b, s, h, p, n, torch.bfloat16)
    y, st = sk.ssd_scan_cuda(u, a, Bm, Cm, chunk=q)
    yr, sr = plain_ssd(u, a, Bm, Cm, chunk=q)
    close(y, yr, *KERNEL_TOL["bfloat16"], "ssd at the timing shape")
    close(st, sr, *KERNEL_TOL["bfloat16"], "ssd state at the timing shape")
    ms = device_ms(lambda: sk.ssd_scan_cuda(u, a, Bm, Cm, chunk=q))
    plain = device_ms(lambda: plain_ssd(u, a, Bm, Cm, chunk=q))
    flops = ssd_flops(b, s, h, p, n, q)
    bound, bound_by = bound_ms((u, a, Bm, Cm, y, st), flops, u.dtype)
    bound32 = flops / FP32_FLOPS * 1e3
    plan = sk.ssd_plan(b, s, h, p, n, q)
    serving_plan = sk.ssd_plan(4, 1491, h, p, n, q)
    print(f"  SSD plan at the timing shape: {plan}")
    print(f"  SSD plan at mamba2's 1,491-token serving wave: {serving_plan}")
    print(f"ssd at B {b}, S {s}, H {h}, P {p}, N {n}, chunk {q}, bf16: "
          f"kernel {ms[0]:.4f} ms ({ms[1]:.4f} ms per synchronised call), "
          f"plain {plain[0]:.4f} ms, bound {bound:.5f} ms ({bound_by}; fp32 "
          f"CUDA cores {bound32:.4f} ms) on {card}")
    return {"max_abs_err": err["float32"], "max_abs_err_bf16":
            err["bfloat16"], "ms": ms[0], "call_ms": ms[1],
            "plain_ms": plain[0], "library_ms": None, "bound_ms": bound,
            "bound_by": bound_by, "bound_fp32_ms": bound32,
            "shape": f"B {b}, S {s}, H {h}, P {p}, N {n}, chunk {q}, bf16",
            "plan": plan, "serving_plan": serving_plan}


LM_ARCHS = ("stablelm-1.6b", "mamba2-130m")
# the rest of the zoo held to the CPU at 2 layers (LM_SMALL_LAYERS): SWA
# GQA at head dim 120, MoE (128 experts, top 8), MLA, a VLM's 256
# projected patches, an encoder-decoder (2 + 2 layers) on 300 // 4 = 75
# source frames; the frontends seeded N(0, 1)
LM_SMALL_ARCHS = LM_ARCHS + ("h2o-danube-3-4b", "qwen3-moe-30b-a3b",
                             "minicpm3-4b", "internvl2-76b",
                             "seamless-m4t-medium")
# internvl2 at 1 layer (2 until phase 17 joined the smoke's time): at 2
# layers its weights' draw and CPU leg at d_model 8,192 took 69.6 s of
# the phase on an H100 host
LM_SMALL_LAYERS = {"internvl2-76b": 1}


def bf16_steps(gap, x):
    """``gap`` in steps of bfloat16 (8 significant bits) at |x|."""
    return gap / 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126)))
                         - 7)


def kept_experts(logits, k, cap):
    """Each token's experts that got one of their ``cap`` slots: the top
    k of its router logits [N, E] (ties to the lower id), slots handed
    out in token order (first tokens win), as ``models/moe.py`` does."""
    import numpy as np
    seen, out = {}, []
    for row in np.argsort(-logits, axis=-1, kind="stable")[:, :k]:
        kept = set()
        for e in row.tolist():
            if seen.get(e, 0) < cap:
                kept.add(e)
            seen[e] = seen.get(e, 0) + 1
        out.append(kept)
    return out


def routing_diff(cpu, card, cfg):
    """Router logits [N, E] of each MoE layer in order, on the CPU and on
    the card, each run on its own hidden states.  A token whose kept
    experts differ in a layer (a different top k, or a slot lost to
    capacity after an earlier token's change) feeds every later layer
    another input, so its rows there are left out.  Every top-k
    difference must be a tie within its row's card-vs-CPU logit
    difference (the CPU's logits of two swapped experts at most twice it
    apart).  Returns (tokens whose top k differ, tokens whose kept
    experts differ, the largest CPU gap in bf16 steps, the largest logit
    difference on the rows compared)."""
    import numpy as np

    from repro_torch.models import moe
    k = cfg.num_experts_per_token
    moved, n_top, n_kept, steps, noise_max = set(), 0, 0, 0.0, 0.0
    for a, b in zip(cpu, card):
        a, b = a.double().numpy(), b.double().numpy()
        rows = [r for r in range(a.shape[0]) if r not in moved]
        if rows:
            noise_max = max(noise_max,
                            float(np.abs(a[rows] - b[rows]).max()))
        ta = np.argsort(-a, axis=-1, kind="stable")[:, :k]
        tb = np.argsort(-b, axis=-1, kind="stable")[:, :k]
        for r in rows:
            lost, won = set(ta[r]) - set(tb[r]), set(tb[r]) - set(ta[r])
            if lost:
                gap = max(abs(a[r, i] - a[r, j]) for i in lost for j in won)
                noise = float(np.abs(a[r] - b[r]).max())
                assert gap <= 2 * noise, f"token {r}: experts {lost} -> " \
                    f"{won} at a CPU gap {gap}, logits {noise} apart"
                steps = max(steps, bf16_steps(gap, np.abs(a[r]).max()))
                n_top += 1
        cap = moe._capacity(cfg, a.shape[0])
        changed = {r for r, (x, y) in enumerate(zip(
            kept_experts(a, k, cap), kept_experts(b, k, cap))) if x != y}
        n_kept += len(changed - moved)
        moved |= changed
    return n_top, n_kept, steps, noise_max


def same_input_routing(torch, cfg, params, inputs, cpu_logits, dev):
    """The router on the card fed the CPU run's router inputs, layer by
    layer, against the CPU's logits: each top-k difference a tie of the
    CPU's bf16 logits at most 2 bf16 steps apart (each side's bf16
    logit may round one step the other way).  Returns (differences,
    their largest gap in bf16 steps, the largest logit difference)."""
    import numpy as np

    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    specs = T.block_specs(cfg)
    layers = [l for l in range(cfg.num_layers) if cfg.is_moe_layer(l)]
    k, n, steps, noise = cfg.num_experts_per_token, 0, 0.0, 0.0
    for l, xf, a in zip(layers, inputs, cpu_logits):
        p = T._layer(params["blocks"], l // len(specs))
        p = p[f"pos{l % len(specs)}"]["moe"]
        b = moe._route(p, cfg, xf.to(dev))[0].double().cpu().numpy()
        a = a.double().numpy()
        noise = max(noise, float(np.abs(a - b).max()))
        ta = np.argsort(-a, axis=-1, kind="stable")[:, :k]
        tb = np.argsort(-b, axis=-1, kind="stable")[:, :k]
        for r in range(a.shape[0]):
            lost, won = set(ta[r]) - set(tb[r]), set(tb[r]) - set(ta[r])
            if lost:
                gap = max(bf16_steps(abs(a[r, i] - a[r, j]),
                                     max(abs(a[r, i]), abs(a[r, j])))
                          for i in lost for j in won)
                assert gap <= 2, f"layer {l} token {r}: experts {lost} -> " \
                    f"{won} at {gap} bf16 steps"
                steps = max(steps, gap)
                n += 1
    return n, steps, noise


def lm_small_batch(torch, cfg):
    """The 300-token prompt and, for a frontend config, seeded N(0, 1)
    ``frontend_embeds`` [1, T, d_model] (T: the VLM's patches, or the
    encoder-decoder's 300 // encoder_seq_ratio frames).  Returns (batch,
    the decoder's cache rows the prefill fills)."""
    import numpy as np
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.tensor(rng.integers(1, cfg.vocab_size,
                                                 (1, 300)),
                                    dtype=torch.int32)}
    rows = 300
    if cfg.frontend is not None:
        t = (300 // cfg.encoder_seq_ratio if cfg.is_encoder_decoder
             else cfg.num_frontend_tokens)
        batch["frontend_embeds"] = torch.tensor(
            rng.standard_normal((1, t, cfg.d_model)), dtype=torch.float32)
        rows += 0 if cfg.is_encoder_decoder else t
    return batch, rows


def lm_greedy_run(api, p, batch, rows, dev):
    """A prefill of ``batch`` then 8 greedy decode steps on ``dev``, the
    router logits and inputs of every MoE call recorded.  Returns (row
    0's: the prefill's last logits, the 8 tokens, each step's top-2 logit
    margin,
    the prefill's router logits, each step's, the prefill's router
    inputs), on the host, and the prefill's flash launches."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import moe
    route = moe._route
    routers, inputs = [], []

    def recording(p, c, xf):
        out = route(p, c, xf)
        routers.append(out[0].float().cpu())
        inputs.append(xf.detach().cpu())
        return out

    moe._route = recording
    try:
        flash0 = fk.launches
        logits, cache = api.prefill(p, _tree_to(batch, dev))
        flash = fk.launches - flash0
        prefill_routers, prefill_inputs = list(routers), list(inputs)
        first = logits[:1, -1].float().cpu()
        # the prefill cache at offset 0 of a longer zero cache (KV) or as
        # it is (SSM state), as the serving engine merges it
        full = api.init_cache(batch["tokens"].shape[0], rows + 8,
                              device=dev)
        for key, entry in full.items():
            for z, c in zip(entry, cache[key]):
                if z.shape == c.shape:
                    z.copy_(c)
                else:
                    z[:, :, : c.shape[2]] = c
        toks, margins, step_routers = [], [], []
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for t in range(8):
            toks.append(int(tok[0, 0]))
            routers.clear()
            logits, full = api.decode_step(p, full, tok, rows + t)
            step_routers.append(list(routers))
            top2 = logits[0, -1].float().topk(2).values
            margins.append(float(top2[0] - top2[1]))
            tok = logits[:, -1].argmax(-1, keepdim=True)
    finally:
        moe._route = route
    return (first, toks, margins, prefill_routers, step_routers,
            prefill_inputs), flash


def greedy_agreement(cfg, ref, got, what):
    """Hold one ``lm_greedy_run`` to another: the prefill's last logits
    within 2e-2 of max|logit| and finite, then the 8 greedy tokens equal;
    at a first difference the reference's top-2 margin must be below
    1e-2, or (MoE) a routing difference must come before it, each
    top-k difference a router tie (``routing_diff``) in the prefill and
    in the decode steps fed equal tokens.  Returns (the logit gap,
    max|logit|, the tie's text, the MoE routing numbers or None)."""
    (lc, tc, mc, rc, sc, _), (lg, tg, _, rg, sg, _) = ref, got
    scale = float(lc.abs().max())
    err = float((lg - lc).abs().max())
    assert err <= 2e-2 * scale and bool(lg.isfinite().all()), \
        f"{what}: prefill logits differ by {err} of max|logit| {scale}"
    diff = [i for i, (x, y) in enumerate(zip(tc, tg)) if x != y]
    n_tok = diff[0] if diff else 8
    routed, routing = [], None    # steps a routing difference came before
    if cfg.num_experts:
        assert len(rc) == len(rg) > 0
        n, kept, steps, noise = routing_diff(rc, rg, cfg)
        # decode steps fed the same token on both: 0 .. n_tok - 1
        step_diff = [routing_diff(sc[t], sg[t], cfg) for t in range(n_tok)]
        routed = ([-1] if kept else []) + [
            t for t in range(n_tok) if step_diff[t][1]]
        routing = (n, kept, steps, noise, step_diff)
    tie = ""
    if diff:
        # token i is the argmax of the logits after step i - 1
        i = diff[0]
        margin = mc[i - 1] if i else float(
            lc.topk(2).values[0, 0] - lc.topk(2).values[0, 1])
        before = [t for t in routed if t < i]
        assert margin < 1e-2 or before, f"{what}: token {i} " \
            f"differs, margin {margin}"
        where = ("the prefill" if before and before[-1] < 0 else
                 f"decode step {before[-1]}" if before else "")
        tie = (f" up to a logit tie at {i}" if margin < 1e-2 else
               f" up to token {i}, after a routing difference in "
               f"{where} (margin {margin:.3f})")
    return err, scale, tie, routing


def phase_lm_small(torch, dev="cuda"):
    """Each LM at full width cut to 2 layers (an encoder-decoder to 2 + 2),
    the same seeded weights (drawn on the CPU) on the card and on the
    CPU: a 300-token prompt's last-position logits (after a frontend's
    seeded embeddings) within 2e-2 of max|logit|, then 8 greedy tokens
    equal (at a first difference the CPU's top-2 logit margin must be
    below 1e-2).  The card's prefill must launch flash once an attention
    layer, the encoder's included (not causal, at 75 frames).  MoE: the
    expert choices of the prefill and of each decode step card vs
    CPU, each difference a router tie (``routing_diff``); a first token
    difference may also follow such a tie in an earlier decode step,
    which sends the token through other experts."""
    import gc
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.api import model_api
    for arch in LM_SMALL_ARCHS:
        t_arch = time.perf_counter()
        cfg = replace(get_config(arch),
                      num_layers=LM_SMALL_LAYERS.get(arch, 2))
        if cfg.is_encoder_decoder:
            cfg = replace(cfg, num_encoder_layers=2)
        api = model_api(cfg)
        params = api.init(torch.Generator().manual_seed(1))
        batch, rows = lm_small_batch(torch, cfg)
        runs, secs = {}, {"init": time.perf_counter() - t_arch}
        for run in ("cpu", dev):
            t_run = time.perf_counter()
            p = _tree_to(params, run)
            runs[run], flash = lm_greedy_run(api, p, batch, rows, run)
            secs[run] = time.perf_counter() - t_run
        card_params = p
        if dev == "cuda":
            attn = cfg.pattern.count("A") + cfg.num_encoder_layers * int(
                cfg.is_encoder_decoder)
            assert flash == attn, f"{arch}: {flash} flash launches in the " \
                f"card's prefill, expected {attn}"
        err, scale, tie, routing = greedy_agreement(cfg, runs["cpu"],
                                                    runs[dev], arch)
        k = cfg.num_experts_per_token
        if routing is not None:
            n, kept, steps, noise, step_diff = routing
            same = same_input_routing(torch, cfg, card_params,
                                      runs["cpu"][5], runs["cpu"][3], dev)
            print(f"  {arch} router on the same inputs (the CPU's, each "
                  f"layer): {same[0]} of {2 * 300} (token, layer) top-{k} "
                  f"choices differ card vs CPU, each a tie of the CPU's bf16 "
                  f"logits {same[1]:.2f} bf16 steps apart at most; logits "
                  f"{same[2]:.3e} apart at most")
            print(f"  {arch} routing of each run: {n} of {2 * 300} prefill "
                  f"(token, layer) top-{k} expert choices differ card vs CPU "
                  f"({kept} tokens' kept experts, capacity included), "
                  f"{sum(d[0] for d in step_diff)} of "
                  f"{2 * len(step_diff)} in the "
                  f"decode steps fed equal tokens; each a tie within its "
                  f"row's card-vs-CPU logit difference (at most "
                  f"{max([noise] + [d[3] for d in step_diff]):.3e} on the "
                  f"rows compared); the CPU's gap between swapped experts "
                  f"up to {max([steps] + [d[2] for d in step_diff]):.2f} "
                  f"bf16 steps")
        tg = runs[dev][1]
        shape = ("2 + 2 encoder layers" if cfg.is_encoder_decoder
                 else f"{cfg.num_layers} layers") + (", full width, "
                                                     "300-token prompt")
        if cfg.frontend is not None:
            shape += (f" + {tuple(batch['frontend_embeds'].shape)} seeded "
                      f"N(0, 1) frontend_embeds")
        print(f"lm-small {arch} ({shape}): prefill logits within "
              f"{err / scale:.2e} of max|logit| {scale:.3f}; greedy tokens "
              f"equal{tie} over 8 steps ({tg}); card prefill flash launches "
              f"{flash}; {time.perf_counter() - t_arch:.1f} s (weights "
              f"{secs['init']:.1f}, CPU leg {secs['cpu']:.1f}, card leg "
              f"{secs[dev]:.1f})")
        del card_params, p
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()


def aten_ops(fn):
    """The number of ATen operator calls one call of ``fn`` dispatches
    (each a host dispatch; most launch a kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def kernel_ms_in(torch, mod, fname, fn, wall_ms, n=3):
    """Device time of the launches of ``mod.fname`` inside one call of
    ``fn``: CUDA events around each launch, summed, with the call queued
    behind a sleep kernel (so the events time the device's work, not the
    host's); median over ``n`` calls.  Returns (ms, launches a call)."""
    orig = getattr(mod, fname)
    evs, sums = [], []

    def timed(*args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = orig(*args, **kw)
        e1.record()
        evs.append((e0, e1))
        return out

    setattr(mod, fname, timed)
    try:
        for _ in range(n):
            evs.clear()
            torch.cuda._sleep(int(min(4e9, 3 * wall_ms * 2e6)))
            fn()
            torch.cuda.synchronize()
            sums.append(sum(a.elapsed_time(b) for a, b in evs))
    finally:
        setattr(mod, fname, orig)
    return statistics.median(sums), len(evs)


def lm_split(torch, eng, plen, kernel):
    """Host and device time of one prefill of ``slots`` x ``plen`` tokens
    and of one decode step against a ``max_seq`` cache, on the engine's
    model and weights, and the device time of ``kernel`` = (module,
    function) launches inside the prefill.  Host: until the call returns
    (PyTorch returns before the device is done); device: CUDA events
    around calls queued behind a sleep kernel (``device_ms``)."""
    api, params = eng.api, eng.params
    dev = eng.device
    batch = {"tokens": torch.ones(eng.slots, plen, dtype=torch.int32,
                                  device=dev)}
    cache = api.init_cache(eng.slots, eng.max_seq, device=dev)
    tok = torch.ones(eng.slots, 1, dtype=torch.int32, device=dev)

    def host_ms(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    prefill = lambda: api.prefill(params, batch)  # noqa: E731
    decode = lambda: api.decode_step(params, cache, tok, plen)  # noqa: E731
    pre_dev, pre_wall = device_ms(prefill, n=6, block=1, warm=2)
    k_ms, k_n = kernel_ms_in(torch, *kernel, prefill, pre_wall)
    return {"plen": plen, "prefill_ops": aten_ops(prefill),
            "decode_ops": aten_ops(decode),
            "prefill_host_ms": host_ms(prefill),
            "prefill_device_ms": pre_dev,
            "prefill_kernel_ms": k_ms, "prefill_kernel_launches": k_n,
            "decode_host_ms": host_ms(decode),
            "decode_device_ms": device_ms(decode, n=8, block=1, warm=2)[0]}


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# phase 8 and phase 16c's launcher runs go in the background (CPU work:
# weights drawn and LMs run on the host, processes starting), each given
# this many seconds from its start
BACKGROUND_TIMEOUT_S = 420


def lm_small_worker(log_path, src):
    """Phase 8 in a spawned process of its own, its lines to
    ``log_path``: its weights' draws and CPU legs (~140 s on an H100
    host) are host work that the card phases do not wait on."""
    import contextlib
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(4)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        phase_lm_small(torch)
        print(f"lm-small phase {time.perf_counter() - t0:.1f} s in a "
              f"process of its own (start-up not included), beside phases "
              f"9-10")


def lm_small_start(work_dir):
    """Start ``lm_small_worker`` (a daemon: it ends with this script).
    Returns its handle for ``lm_small_check``."""
    import multiprocessing
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    log = os.path.join(work_dir, "lm_small.log")
    proc = multiprocessing.get_context("spawn").Process(
        target=lm_small_worker, args=(log, src), daemon=True)
    proc.start()
    return {"proc": proc, "log": log, "t0": time.perf_counter()}


def lm_small_check(run):
    """Wait for phase 8's process, print its lines; fails if it failed or
    outlived ``BACKGROUND_TIMEOUT_S``."""
    proc = run["proc"]
    proc.join(max(BACKGROUND_TIMEOUT_S - (time.perf_counter() - run["t0"]),
                  1))
    try:
        text = ""
        if os.path.exists(run["log"]):
            with open(run["log"]) as f:
                text = f.read()
        assert not proc.is_alive(), "phase 8 did not end:\n" + text[-2000:]
        assert proc.exitcode == 0, \
            f"phase 8 failed (exit code {proc.exitcode}):\n" + text[-3000:]
    finally:
        background_stop({"lm-small": run})
    print(text, end="")


def background_stop(runs):
    """Kill what ``lm_small_start`` and ``launcher_start`` started and is
    still running."""
    for run in runs.values():
        proc = run.get("proc")
        if proc is None:
            continue
        if hasattr(proc, "poll"):            # subprocess.Popen
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        elif proc.is_alive():                # multiprocessing.Process
            proc.kill()
            proc.join()


def phase_lm_serve(torch, arch, card, counters, kernel=None, cfg=None):
    """Main path 5 for one config: ``launch/serve.py`` at full width, 8
    requests with prompts of 256-1536 tokens, 32 greedy tokens, 4 slots,
    max_seq 4096.  ``cfg`` replaces the arch's config (a cut depth or
    bf16 parameters), as a caller of ``serve_tokens`` may.  ``counters``
    are reset before and read after.  ``kernel`` = (module, function) of
    the arch's kernel, timed inside one prefill (None: not timed).  The
    engine, its parameters and caches are freed before the return.
    Returns the run's numbers and launch counts."""
    import gc

    from repro_torch.launch import serve as serve_launch
    argv = ["--arch", arch, "--requests", "8", "--max-new", "32", "--slots",
            "4", "--max-seq", "4096", "--device", "cuda"]
    args = serve_launch.parser().parse_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for reset, _ in counters.values():
        reset()
    torch.cuda.synchronize()
    eng, dt = serve_launch.serve_tokens(args, prompt_len=(256, 1537),
                                        cfg=cfg)
    launches = {k: read() for k, (_, read) in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = eng.api.cfg
    numel = sum(t.numel() for t in _leaves(eng.params))
    qs = eng.qos_stats()
    toks = sum(len(r.generated) for r in eng.finished)
    assert qs["finished"] == 8 and qs["truncated"] == 0 and toks == 8 * 32
    vocab = cfg.vocab_size
    assert all(0 <= t < vocab for r in eng.finished for t in r.generated)
    waves = len(eng.wave_log)
    wt = eng.wave_times
    prefill_ms = [w["prefill_s"] * 1e3 for w in wt]
    steps = sum(w["decode_steps"] for w in wt)
    decode_ms = sum(w["decode_s"] for w in wt) * 1e3 / max(steps, 1)
    enc = cfg.num_encoder_layers if cfg.is_encoder_decoder else 0
    depth = f"{enc} encoder + " if enc else ""
    print(f"lm-serve {arch} (full width, {depth}{cfg.num_layers} layers, "
          f"{numel:,} {cfg.param_dtype} parameters, param_count "
          f"{cfg.param_count():,}) on {card}: {waves} waves (prompt lengths "
          f"{[w['plen'] for w in wt]}), prefill ms per wave "
          f"{[round(x, 2) for x in prefill_ms]}, decode {decode_ms:.2f} ms "
          f"per step over {steps} steps, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s), max_memory_allocated {peak_gb:.2f} GB, "
          f"launches {launches}")
    out = {"waves": waves, "prefill_ms": prefill_ms,
           "plens": [w["plen"] for w in wt], "decode_ms_per_step":
           decode_ms, "steps": steps, "tokens": toks, "seconds": dt,
           "tok_per_s": toks / dt, "launches": launches,
           "layers": cfg.num_layers, "encoder_layers": enc,
           "param_dtype": cfg.param_dtype, "param_count": cfg.param_count(),
           "parameters": numel, "max_memory_gb": peak_gb,
           "pattern": cfg.pattern}
    if kernel is not None:
        split = lm_split(torch, eng, max(wt, key=lambda w: w["plen"])["plen"],
                         kernel)
        out.update(split)
        print(f"  {arch} split (host: the call returns, not synchronised; "
              f"device: CUDA events with the call queued ahead): prefill at "
              f"{split['plen']} tokens host {split['prefill_host_ms']:.2f} "
              f"ms, device {split['prefill_device_ms']:.2f} ms, "
              f"{split['prefill_ops']} aten ops; decode step host "
              f"{split['decode_host_ms']:.2f} ms, device "
              f"{split['decode_device_ms']:.2f} ms, {split['decode_ops']} "
              f"aten ops")
        share = split["prefill_kernel_ms"] / split["prefill_device_ms"] * 100
        print(f"  {arch} {kernel[1]} inside that prefill: "
              f"{split['prefill_kernel_launches']} launches, "
              f"{split['prefill_kernel_ms']:.2f} ms of the "
              f"{split['prefill_device_ms']:.2f} ms device time ({share:.1f}%"
              f"; CUDA events around each launch, summed)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The rest of the zoo served at full width on main path 5 (seamless, an
# encoder-decoder, through serve_tokens: the launcher's CLI refuses it, as
# the JAX launcher does): (arch, config changes).  qwen3-moe (30.5 B) and
# moonshot (28.1 B) fit one 80 GB card only with bf16 parameters, as the
# JAX package's launch/dryrun.py sets them; jamba (52 B), mistral-large
# (123 B) and internvl2-76b (76 B) do not fit in fp32 at any
# width-preserving cut but depth: jamba keeps one period-8 super-block
# (MMMMAMMM, MoE at the odd layers), mistral 4 of its 88 layers,
# internvl2 4 of its 80 (8 each until phase 17 joined the smoke's time).
# The smoke's time limit cuts the deepest of the rest: qwen3-moe and
# moonshot to 8 of their 48 layers, minicpm3 to 8 of its 62 (uncut
# until the smoke passed its limit on a slow host: their decode steps,
# host-bound at ~2 ms a layer, took ~40 s of the phase; 12 / 12 / 16
# until phase 18's serving leg joined the smoke's time).  The frontends
# are the serving engine's: all-zero embeddings (256 patches for
# internvl2, one source frame for seamless, whose encoder then runs flash
# at S = 1)
LM_ZOO = (
    ("h2o-danube-3-4b", {}),
    ("minicpm3-4b", {"num_layers": 8}),
    ("qwen3-moe-30b-a3b", {"param_dtype": "bfloat16", "num_layers": 8}),
    ("moonshot-v1-16b-a3b", {"param_dtype": "bfloat16", "num_layers": 8}),
    ("jamba-v0.1-52b", {"num_layers": 8}),
    ("mistral-large-123b", {"num_layers": 4}),
    ("internvl2-76b", {"num_layers": 4}),
    ("seamless-m4t-medium", {}),
)


def phase_lm_zoo(torch, card, counters):
    """Main path 5 for the rest of the zoo: each config of ``LM_ZOO``
    served as stablelm and mamba2 are; each prefill must launch flash
    attention once an attention layer (an encoder's included) and the SSD
    scan once a Mamba layer, and nothing else."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    runs = {}
    for arch, change in LM_ZOO:
        run = phase_lm_serve(torch, arch, card, counters,
                             cfg=replace(get_config(arch), **change))
        want = {k: 0 for k in run["launches"]}
        want["flash_attention"] = (run["pattern"].count("A")
                                   + run["encoder_layers"]) * run["waves"]
        want["ssd_scan"] = run["pattern"].count("M") * run["waves"]
        assert run["launches"] == want, \
            f"{arch}: launches {run['launches']}, expected {want}"
        runs[arch] = run
    return runs


# main path 13 (phase 16): LM training.  (a) full width cut to 2 layers,
# card vs CPU, each in fp32 compute and in the config's bf16: the flash
# and the SSD model's plain branches (qwen3-moe-30b-a3b, held here too,
# took 55-69 s of a smoke past 900 s, so it left for the card tests);
# (b) stablelm-1.6b uncut through
# make_train_step; (c) the launcher with a restart, and
# examples/train_with_failures_torch.py's fault at step 37
LM_TRAIN_ARCHS = ("stablelm-1.6b", "mamba2-130m")
LM_TRAIN_BATCH = dict(batch_size=2, seq_len=128)     # (a)
LM_TRAIN_FULL = dict(batch_size=4, seq_len=512)      # (b)
LM_TRAIN_STEPS = 6
# (a)'s gate on each gradient leaf, card vs CPU, as a share of the CPU
# leaf's max|g|: fp32 sums in another order; in bf16 the LM tests' 5e-2,
# or, for a leaf the CPU's own bf16 rounding moves further (a per-channel
# leaf summed over the batch with cancellation), twice its distance from
# the CPU's fp32 leaf (tests/test_torch_lm_loss.py's rule)
LM_TRAIN_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
LM_TRAIN_LAUNCH = ["--arch", "mamba2-130m", "--batch-size", "4",
                   "--seq-len", "512", "--ckpt-every", "4"]


def lm_loss_grads(torch, api, params, batch, dev):
    """One ``api.loss`` + backward on ``dev``.  Returns (loss, grads on
    the CPU in fp32 by leaf name)."""
    from repro_torch.train.checkpoint import _flatten_with_names
    from repro_torch.train.loop import value_and_grad
    loss, _, grads = value_and_grad(
        api.loss, _tree_to(params, dev),
        {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
    names, leaves, _ = _flatten_with_names(grads)
    return float(loss), {n: g.float().cpu() for n, g in zip(names, leaves)}


def lm_train_small(torch, counters, dev="cuda"):
    """(a): each of ``LM_TRAIN_ARCHS`` at full width cut to 2 layers, one
    set of CPU-drawn weights, one ``lm_batch_at_step`` batch: loss and
    gradients of the card against the CPU's, in fp32 compute and in the
    config's bf16 (``LM_TRAIN_TOL``).  The card's steps launch no
    kernel."""
    import gc
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.api import model_api
    from repro_torch.train.data import DataConfig, lm_batch_at_step
    out = {}
    for arch in LM_TRAIN_ARCHS:
        t_arch = time.perf_counter()
        base = replace(get_config(arch), num_layers=2)
        params = model_api(base).init(torch.Generator().manual_seed(1))
        batch = lm_batch_at_step(base, DataConfig(**LM_TRAIN_BATCH), 0)
        ref32, res = None, {}
        for dtype in ("float32", "bfloat16"):
            cfg = replace(base, dtype=dtype)
            api = model_api(cfg)
            t0 = time.perf_counter()
            lc, gc_ = lm_loss_grads(torch, api, params, batch, "cpu")
            t_cpu = time.perf_counter() - t0
            for reset, _ in counters.values():
                reset()
            t0 = time.perf_counter()
            lg, gg = lm_loss_grads(torch, api, params, batch, dev)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            launches = {k: read() for k, (_, read) in counters.items()}
            assert not any(launches.values()), \
                f"{arch} {dtype}: the loss path launched {launches}"
            tol = LM_TRAIN_TOL[dtype]
            assert abs(lg - lc) <= (1e-4 if dtype == "float32" else 5e-2) \
                * abs(lc) and math.isfinite(lg), f"{arch} {dtype}: loss " \
                f"{lg} on the card, {lc} on the CPU"
            worst = (0.0, None)
            for name, c in gc_.items():
                d = float((gg[name] - c).abs().max())
                scale = float(c.abs().max())
                bound = tol * scale
                if ref32 is not None:
                    bound = max(bound, 2 * float((c - ref32[name]).abs()
                                                 .max()))
                assert d <= bound and bool(gg[name].isfinite().all()), \
                    f"{arch} {dtype} grad {name}: card vs CPU {d} of " \
                    f"max|g| {scale} (bound {bound})"
                rel = d / max(scale, 1e-30)
                if rel >= worst[0]:
                    worst = (rel, name)
            res[dtype] = {"loss_cpu": lc, "loss_card": lg,
                          "worst_leaf": worst[1], "worst_rel": worst[0],
                          "cpu_s": t_cpu, "card_s": t_card}
            print(f"lm-train {arch} 2 layers full width, {dtype} compute, "
                  f"B {LM_TRAIN_BATCH['batch_size']} S "
                  f"{LM_TRAIN_BATCH['seq_len']}: loss card {lg:.6f} CPU "
                  f"{lc:.6f}; {len(gc_)} gradient leaves within "
                  f"{tol:g} of max|g_cpu|"
                  + (" (or the CPU's bf16 distance from fp32)"
                     if ref32 is not None else "")
                  + f", worst {worst[0]:.3e} at {worst[1]}; CPU leg "
                  f"{t_cpu:.1f} s, card leg {t_card:.1f} s")
            ref32 = gc_ if dtype == "float32" else None
            del gg
            gc.collect()
        out[arch] = res
        del params, ref32, gc_
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {arch}: {time.perf_counter() - t_arch:.1f} s")
    return out


def lm_train_refusals(torch, counters):
    """Both kernel ops refuse a CUDA input that requires grad, before
    any launch."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    for reset, _ in counters.values():
        reset()
    q = torch.randn(1, 64, 2, 64, device="cuda")
    u = torch.randn(1, 64, 2, 16, device="cuda")
    a = -torch.rand(1, 64, 2, device="cuda")
    bm = torch.randn(1, 64, 8, device="cuda")
    for name, fn, args in (
            ("flash_attention", lambda *x: flash_attention(*x, causal=True),
             [q, q, q]),
            ("ssd_scan", lambda *x: ssd_scan(*x, chunk=32), [u, a, bm, bm])):
        for i in range(len(args)):
            bad = list(args)
            bad[i] = bad[i].clone().requires_grad_()
            try:
                fn(*bad)
            except RuntimeError as e:
                assert "no backward" in str(e), e
            else:
                raise AssertionError(f"{name} took a grad input {i}")
    launches = {k: read() for k, (_, read) in counters.items()}
    assert not any(launches.values()), launches
    print("lm-train: flash_attention and ssd_scan refuse CUDA inputs that "
          "require grad (each input in turn), no launch")


def lm_train_full(torch, counters, card, dev="cuda"):
    """(b): stablelm-1.6b uncut (24 layers, fp32 parameters, bf16
    compute, remat "full") through ``make_train_step`` for
    ``LM_TRAIN_STEPS`` steps at ``LM_TRAIN_FULL``, the launcher's
    hyperparameters (lr 1e-3, warmup max(steps // 20, 1)): finite losses,
    the state on the card, step ms synchronised after one warm step, peak
    memory."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.api import model_api
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.data import DataConfig, batch_fn
    from repro_torch.train.loop import (TrainHyper, init_train_state,
                                        make_train_step)
    cfg = get_config("stablelm-1.6b")
    api = model_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=max(LM_TRAIN_STEPS // 20, 1),
                       total_steps=LM_TRAIN_STEPS)
    state = init_train_state(api.init(torch.Generator(dev).manual_seed(0)),
                             hyper)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    step = make_train_step(api, hyper)
    bat = batch_fn(cfg, DataConfig(**LM_TRAIN_FULL))
    for reset, _ in counters.values():
        reset()
    losses, ms = [], []
    for i in range(LM_TRAIN_STEPS):
        b = bat(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = {k: read() for k, (_, read) in counters.items()}
    assert not any(launches.values()), f"the train step launched {launches}"
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), losses
    for part in (state.params, state.opt.mu, state.opt.nu):
        assert all(t.device.type == dev for t in tree_leaves(part))
    assert int(state.opt.step) == LM_TRAIN_STEPS
    steady = ms[1:]
    tokens = LM_TRAIN_FULL["batch_size"] * LM_TRAIN_FULL["seq_len"]
    mean_ms = statistics.mean(steady)
    print(f"lm-train stablelm-1.6b uncut ({cfg.num_layers} layers, "
          f"{n_params:,} {cfg.param_dtype} parameters, {cfg.dtype} compute, "
          f"remat {cfg.remat}) B {LM_TRAIN_FULL['batch_size']} S "
          f"{LM_TRAIN_FULL['seq_len']}, {LM_TRAIN_STEPS} steps on {card}: "
          f"losses {[round(x, 4) for x in losses]}; step ms (synchronised) "
          f"first {ms[0]:.1f}, then mean {mean_ms:.1f} median "
          f"{statistics.median(steady):.1f} min {min(steady):.1f} "
          f"({tokens / mean_ms * 1e3:.0f} tokens/s); max_memory_allocated "
          f"{peak_gb:.2f} GB")
    out = {"layers": cfg.num_layers, "parameters": n_params,
           "losses": losses, "step_ms": ms, "mean_step_ms": mean_ms,
           "tokens_per_s": tokens / mean_ms * 1e3, "peak_gb": peak_gb}
    del state, m, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launcher_start(dev="cuda"):
    """(c)'s launcher half, started early: a thread runs ``launch/
    train.py --arch mamba2-130m`` at full width, 8 steps with a
    checkpoint every 4, then again with ``--steps 12`` (it must restore
    step 8), each a process of its own, while the card phases run (the
    two processes took ~57 s of phase 16, mostly their start-up).
    ``launcher_check`` waits for it; ``background_stop`` kills it.
    Returns its handle."""
    import tempfile
    import threading
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "src")}
    tmp = tempfile.mkdtemp(prefix="lm_launch_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] \
        + LM_TRAIN_LAUNCH + ["--ckpt-dir", os.path.join(tmp, "launch"),
                             "--device", dev]
    run = {"tmp": tmp, "outs": [], "seconds": [], "proc": None}

    def go():
        try:
            for steps in ("8", "12"):
                t0 = time.perf_counter()
                run["proc"] = subprocess.Popen(
                    cmd + ["--steps", steps], env=env, text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                out, _ = run["proc"].communicate(timeout=BACKGROUND_TIMEOUT_S)
                assert run["proc"].returncode == 0, \
                    f"the launcher at --steps {steps} failed:\n{out[-3000:]}"
                run["outs"].append(out)
                run["seconds"].append(time.perf_counter() - t0)
        except BaseException as e:  # raised again by launcher_check
            run["error"] = e
    run["thread"] = threading.Thread(target=go, daemon=True)
    run["thread"].start()
    return run


def launcher_check(run):
    """Wait for ``launcher_start``'s runs and hold them: finite losses,
    step 8 restored, 12 steps done.  Returns their seconds."""
    import shutil
    try:
        run["thread"].join(BACKGROUND_TIMEOUT_S)
        assert not run["thread"].is_alive(), "the launcher runs did not end"
        if "error" in run:
            raise run["error"]
    finally:
        background_stop({"launcher": run})
        shutil.rmtree(run["tmp"], ignore_errors=True)
    first, second = run["outs"]
    assert "nan" not in first + second, "a non-finite loss"
    assert "done: steps=8 interrupted=False" in first, first[-2000:]
    assert "restored checkpoint at step 8" in second, second[-2000:]
    assert "done: steps=12 interrupted=False" in second, second[-2000:]
    for text in (first, second):
        for line in text.splitlines():
            if line.startswith(("arch=", "restored", "step ", "done:")):
                print(f"  launcher: {line}")
    s1, s2 = run["seconds"]
    print(f"lm-train launcher (mamba2-130m, full width, B 4, S 512; run in "
          f"the background beside phases 9-10): 8 steps in {s1:.1f} s, then "
          f"restored at 8 and on to 12 in {s2:.1f} s (each a process: "
          f"start-up included)")
    return [s1, s2]


def lm_train_restarts(torch, counters, card, launcher, dev="cuda"):
    """(c): ``launcher_start``'s runs held (``launcher_check``); then
    examples/train_with_failures_torch.py's ``demo`` on the card: a run
    with a fault injected at step 37, restored from step 20 and resumed,
    against an uninterrupted one (the example's rtol 1e-5; bit-equality
    and a second uninterrupted run's reported)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.train.checkpoint import tree_leaves
    import train_with_failures_torch as ft
    out = {"launcher_s": launcher_check(launcher)}
    lines = []
    tmp = tempfile.mkdtemp(prefix="lm_train_")
    try:
        for reset, _ in counters.values():
            reset()
        t0 = time.perf_counter()
        demo = ft.demo(dev, log=lines.append)
        again = ft.run(ft.fresh_state(dev), os.path.join(tmp, "again"))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: read() for k, (_, read) in counters.items()}
    assert not any(launches.values()), launches
    assert "simulated failure: injected fault at step 37" in lines, lines
    assert demo["start"] == 20, demo["start"]
    a = [t.cpu().numpy() for t in tree_leaves(demo["ref"].final_state.params)]
    b = [t.cpu().numpy()
         for t in tree_leaves(demo["resumed"].final_state.params)]
    c = [t.cpu().numpy() for t in tree_leaves(again.final_state.params)]
    ok = all(np.allclose(x, y, rtol=1e-5) for x, y in zip(a, b))
    bit = all(np.array_equal(x, y) for x, y in zip(a, b))
    rerun_bit = all(np.array_equal(x, y) for x, y in zip(a, c))
    diff = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    assert ok and demo["ok"], f"restart != uninterrupted: max|diff| {diff}"
    print(f"lm-train restart (examples/train_with_failures_torch.py on the "
          f"card: 60 steps, fault at 37, restored at {demo['start']}): "
          f"restart == uninterrupted within rtol 1e-5: {ok}; bit-equal: "
          f"{bit} (max|diff| {diff:.3e}); a second uninterrupted run "
          f"bit-equal to the first: {rerun_bit}; {dt:.1f} s on {card}")
    out.update(restart_ok=ok, restart_bit_equal=bit,
               rerun_bit_equal=rerun_bit, restart_max_diff=diff)
    return out


def phase_lm_train(torch, card, counters, launcher):
    """Main path 13: LM training (``train/``, ``models.*_loss``), on the
    plain attention and scan branches: no kernel launch on its path.
    ``launcher``: ``launcher_start``'s handle."""
    t0 = time.perf_counter()
    lm_train_refusals(torch, counters)
    small = lm_train_small(torch, counters)
    full = lm_train_full(torch, counters, card)
    restarts = lm_train_restarts(torch, counters, card, launcher)
    dt = time.perf_counter() - t0
    print(f"lm-train phase {dt:.1f} s on {card}")
    return {"small": small, "full": full, "restarts": restarts,
            "seconds": dt}


# main path 14 (phase 17): the mesh.  qwen3-moe at full width cut to 2
# layers (phase 8's CPU-drawn weights), moe_impl "shard_map", served by
# two spawned processes that share the card on a gloo (1, 2) ("data",
# "model") mesh, each holding its 64 of the 128 experts a layer.
# (a) against the one-process GSPMD engine on the card at the first
# factor of EP_FACTORS where the GSPMD path drops no choice; (b) the
# same EP run on the card and on the CPU (the two processes computing on
# the CPU) at the config's own factor, fp32 compute, so that no router
# tie moves a drop; (c) the dry run on this host.
EP_ARCH = "qwen3-moe-30b-a3b"
EP_FACTORS = (1.25, 2.5, 5.0, 10.0, 20.0)
EP_SERVE = dict(requests=8, max_new=8, slots=4, max_seq=1024)
EP_PROMPTS = (64, 513)
EP_TIMEOUT_S = 180
# the whole dry-run sweep traces each single-pod cell's step: ~302 s of
# traces on a CPU host (past 60 s), so the phase traces qwen3-moe's cells
# only and sweeps every cell untraced
DRYRUN_TIMEOUT_S = 150


def ep_requests(cfg):
    """The EP serve's requests: (uid, prompt) with prompt lengths drawn
    from ``EP_PROMPTS``, as ``serve_tokens`` draws them."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = []
    for uid in range(EP_SERVE["requests"]):
        plen = int(rng.integers(*EP_PROMPTS))
        out.append((uid, rng.integers(1, cfg.vocab_size, plen)
                    .astype(np.int32)))
    return out


def ep_batch(torch, cfg):
    """Phase 8's 300-token prompt twice (B 2), so that a decode step's
    two tokens split over the two ranks.  Returns (batch, rows)."""
    batch, rows = lm_small_batch(torch, cfg)
    return {k: v.repeat(2, *[1] * (v.dim() - 1))
            for k, v in batch.items()}, rows


def ep_serve(torch, api, params, dev, mesh=None):
    """The EP serve's requests through a ``ServeEngine`` on ``dev`` (on
    ``mesh`` when given), flash launches counted from 0.  Returns the
    engine's tokens, wave log and prompt lengths, and the launches."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding import activate
    eng = ServeEngine(api, params, slots=EP_SERVE["slots"],
                      max_seq=EP_SERVE["max_seq"], device=dev)
    for uid, prompt in ep_requests(api.cfg):
        eng.submit(Request(uid=uid, prompt=prompt,
                           max_new_tokens=EP_SERVE["max_new"]))
    fk.launches = 0
    if mesh is None:
        eng.run_until_done()
    else:
        with activate(mesh):
            eng.run_until_done()
    return {"tokens": {r.uid: list(r.generated) for r in eng.finished},
            "waves": list(eng.wave_log),
            "plens": [w["plen"] for w in eng.wave_times],
            "flash": fk.launches}


def expert_bytes(params):
    """Bytes of the expert stacks of a model's tree."""
    from repro_torch.models import moe
    total = 0
    for block in params["blocks"].values():
        if "moe" in block:
            total += sum(block["moe"][k].numel()
                         * block["moe"][k].element_size()
                         for k in moe.EXPERT_LEAVES)
    return total


def ep_worker(rank, port, work_dir, src, dev):
    """One of phase 17's two processes: gloo between them, the model on
    ``dev`` (and, for (b), on the CPU too); writes what it computed."""
    sys.path.insert(0, src)
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.protocol import synchronize
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.api import model_api
    from repro_torch.sharding import activate
    if dev == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(4)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_test_mesh((1, 2), ("data", "model"))
        base = replace(get_config(EP_ARCH), num_layers=2,
                       moe_impl="shard_map")
        local = moe.shard_experts(
            model_api(base).init(torch.Generator().manual_seed(1)), base,
            mesh)
        card = _tree_to(local, dev)
        out = {"expert_bytes": expert_bytes(card)}
        # (b) the config's factor, fp32 compute: the card, then the CPU
        cfg_b = replace(base, dtype="float32")
        batch, rows = ep_batch(torch, cfg_b)
        for name, run_dev, p in (("card", dev, card), ("cpu", "cpu", local)):
            t0 = time.perf_counter()
            with activate(mesh), moe.count_drops() as drops:
                run, _ = lm_greedy_run(model_api(cfg_b), p, batch, rows,
                                       run_dev)
            out[f"b_{name}"] = (run[:5] + (None,), drops["dropped"],
                                time.perf_counter() - t0)
        del local
        # (a) at the factor the GSPMD path drops nothing at
        path = os.path.join(work_dir, "factor.json")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            assert time.perf_counter() - t0 < EP_TIMEOUT_S, "no factor"
            time.sleep(0.2)
        with open(path) as f:
            factor = json.load(f)["factor"]
        api = model_api(replace(base, moe_capacity_factor=factor))
        with activate(mesh), moe.count_drops() as drops:
            run, flash = lm_greedy_run(api, card, batch, rows, dev)
            serve = ep_serve(torch, api, card, dev, mesh)
        out.update(a_run=run[:5] + (None,), a_flash=flash, serve=serve,
                   a_drops=drops["dropped"])
        # one EP MoE layer at the longest wave, the exchange inside
        x = torch.randn(EP_SERVE["slots"], max(serve["plens"]),
                        base.d_model, generator=torch.Generator()
                        .manual_seed(2)).to(dev, torch.bfloat16)
        layer = T._layer(card["blocks"]["pos0"]["moe"], 0)
        times = []
        with activate(mesh):
            for _ in range(4):
                dist.barrier()
                synchronize(torch.device(dev))
                t0 = time.perf_counter()
                moe.moe_apply(layer, api.cfg, x)
                synchronize(torch.device(dev))
                times.append((time.perf_counter() - t0) * 1e3)
        out["layer_ms"] = statistics.median(times[1:])
        out["layer_tokens"] = x.shape[0] * x.shape[1]
        torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_start(src, work_dir):
    """(c): the dry run as a user runs it, two subprocesses started
    together: every cell untraced, and qwen3-moe's cells with their FLOPs
    and their rank-local readings (peak / temp / output bytes,
    collectives) traced.  Each run's seconds are taken when it exits (a
    waiting thread).  Returns {name: run}."""
    import threading
    env = dict(os.environ, PYTHONPATH=src)
    runs = {}
    for name, extra in (("sweep", ["--no-trace"]),
                        ("qwen3", ["--arch", EP_ARCH])):
        path = os.path.join(work_dir, f"dryrun_{name}")
        with open(path + ".log", "w") as log:
            run = {"proc": subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 *extra, "--out", path + ".jsonl"], env=env, stdout=log,
                stderr=subprocess.STDOUT),
                "path": path, "t0": time.perf_counter()}

        def wait(run=run):
            run["proc"].wait()
            run["seconds"] = time.perf_counter() - run["t0"]
        threading.Thread(target=wait, daemon=True).start()
        runs[name] = run
    return runs


def dryrun_stop(runs):
    for run in runs.values():
        if run["proc"].poll() is None:
            run["proc"].kill()
        run["proc"].wait()


def dryrun_wait(runs):
    """Wait for ``dryrun_start``'s processes (all killed past
    ``DRYRUN_TIMEOUT_S``).  Returns {name: (records, seconds)}."""
    try:
        for run in runs.values():
            while "seconds" not in run:
                assert time.perf_counter() - run["t0"] < DRYRUN_TIMEOUT_S
                time.sleep(0.1)
    finally:
        dryrun_stop(runs)
    out = {}
    for name, run in runs.items():
        with open(run["path"] + ".log") as f:
            assert run["proc"].returncode == 0, f.read()[-2000:]
        with open(run["path"] + ".jsonl") as f:
            out[name] = ([json.loads(line) for line in f], run["seconds"])
    return out


def phase_mesh(torch, card, dry_runs, dev="cuda"):
    """Main path 14: logical-axis sharding's process mesh, expert
    parallelism serving qwen3-moe, and the dry run (see ``EP_ARCH``;
    ``dry_runs``: ``dryrun_start``'s runs, started with phase 8 in the
    background, since the dry run needs no card).  Returns the phase's
    numbers; the EP serve's flash launches (each rank's, counted from 0)
    are this path's."""
    import tempfile
    from dataclasses import replace

    import torch.multiprocessing as mp

    from repro_torch import distributed as pdist
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import model_api
    t_phase = time.perf_counter()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    base = replace(get_config(EP_ARCH), num_layers=2, moe_impl="shard_map")
    with tempfile.TemporaryDirectory() as work_dir:
        ctx = mp.start_processes(ep_worker, args=(
            pdist._free_port(), work_dir, src, dev), nprocs=2, join=False,
            start_method="spawn")
        try:
            # the one-process engine on the card (no mesh: the GSPMD
            # path), at the first factor it drops nothing at
            params = _tree_to(model_api(base).init(
                torch.Generator().manual_seed(1)), dev)
            batch, rows = ep_batch(torch, base)
            tried = {}
            for factor in EP_FACTORS:
                api = model_api(replace(base, moe_capacity_factor=factor))
                with moe.count_drops() as drops:
                    ref, ref_flash = lm_greedy_run(api, params, batch, rows,
                                                   dev)
                    ref_serve = ep_serve(torch, api, params, dev)
                tried[factor] = drops["dropped"]
                if not drops["dropped"]:
                    break
            assert not drops["dropped"], f"the GSPMD path drops: {tried}"
            ref_bytes = expert_bytes(params)
            del params
            if dev == "cuda":
                torch.cuda.empty_cache()
            dry = dryrun_wait(dry_runs)
            with open(os.path.join(work_dir, "factor.json"), "w") as f:
                json.dump({"factor": factor}, f)
            t0 = time.perf_counter()
            while not ctx.join(timeout=5):
                assert time.perf_counter() - t0 < EP_TIMEOUT_S, \
                    "the EP processes did not finish"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            dryrun_stop(dry_runs)
        ranks = [torch.load(os.path.join(work_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]

    cfg_a = replace(base, moe_capacity_factor=factor)
    attn = base.pattern.count("A")
    out = {"factor": factor, "gspmd_drops_by_factor": tried, "ranks": []}
    for r, res in enumerate(ranks):
        assert 2 * res["expert_bytes"] == ref_bytes, (r, res["expert_bytes"])
        # (a) against the one-process GSPMD engine
        assert res["a_drops"] == 0, f"rank {r}: EP drops {res['a_drops']}"
        err, scale, tie, routing = greedy_agreement(
            cfg_a, ref, res["a_run"], f"EP rank {r}")
        assert res["a_flash"] == ref_flash == attn
        serve = res["serve"]
        assert serve["waves"] == ref_serve["waves"], r
        assert serve["flash"] == attn * len(serve["waves"]) \
            == ref_serve["flash"], (r, serve["flash"])
        same = sum(serve["tokens"][u] == ref_serve["tokens"][u]
                   for u in ref_serve["tokens"])
        # (b) the card against the CPU at the config's own factor
        (run_c, drops_c, s_c), (run_g, drops_g, s_g) = (res["b_cpu"],
                                                        res["b_card"])
        err_b, scale_b, tie_b, _ = greedy_agreement(
            replace(base, dtype="float32"), run_c, run_g, f"EP rank {r} (b)")
        out["ranks"].append({
            "expert_bytes": res["expert_bytes"], "layer_ms": res["layer_ms"],
            "layer_tokens": res["layer_tokens"], "logit_gap": err / scale,
            "routing_diffs": None if routing is None else routing[0],
            "served_equal": same, "flash": serve["flash"],
            "waves": len(serve["waves"]), "b_logit_gap": err_b / scale_b,
            "b_drops_card": drops_g, "b_drops_cpu": drops_c,
            "b_seconds": [s_g, s_c]})
        print(f"mesh (a) rank {r} of a gloo (1, 2) (\"data\", \"model\") "
              f"mesh sharing the card, {EP_ARCH} full width, 2 layers, "
              f"moe_impl shard_map, factor {factor} (GSPMD drops by factor "
              f"{tried}, EP drops 0): expert bytes {res['expert_bytes']:,} "
              f"(one process: {ref_bytes:,}); prefill logits within "
              f"{err / scale:.2e} of max|logit| {scale:.3f} of the "
              f"one-process GSPMD engine; greedy tokens equal{tie} over 8 "
              f"({res['a_run'][1]}); {routing[0]} of {2 * 600} prefill "
              f"(token, layer) top-k choices differ, each a tie; served "
              f"{len(serve['waves'])} waves (prompt lengths "
              f"{serve['plens']}), {same} of {len(ref_serve['tokens'])} "
              f"requests' tokens equal, wave logs equal; flash launches "
              f"{serve['flash']} = {attn} layers x {len(serve['waves'])} "
              f"waves; one EP MoE layer at {res['layer_tokens']} tokens "
              f"{res['layer_ms']:.2f} ms (gloo exchange inside)")
        assert drops_g == drops_c, f"rank {r}: (b) drops card {drops_g}, " \
            f"CPU {drops_c}"
        print(f"mesh (b) rank {r}, factor {base.moe_capacity_factor}, fp32 "
              f"compute: card vs CPU prefill logits within "
              f"{err_b / scale_b:.2e} of max|logit|, greedy tokens "
              f"equal{tie_b}; drops card {drops_g}, CPU {drops_c}; "
              f"{s_g:.1f} s card, {s_c:.1f} s CPU")
    out["b_drops"] = sum(res["b_card"][1] for res in ranks)

    # (c) the dry run
    recs, sweep_s = dry["sweep"]
    counts = {st: sum(x["status"] == st for x in recs)
              for st in ("ok", "skipped", "failed")}
    assert counts == {"ok": 66, "skipped": 14, "failed": 0}, counts
    gib = {x["arch"]: round(x["argument_bytes_per_device"] / 2**30, 2)
           for x in recs if x["shape"] == "train_4k"
           and x["mesh"] == "pod16x16"}
    q_recs, q_s = dry["qwen3"]
    flops = {x["shape"]: x["flops_per_device"] for x in q_recs
             if "flops_per_device" in x}
    assert len(q_recs) == 8 and len(flops) == 3, q_recs
    peaks = {f"{x['shape']} {x['mesh']}": x["peak_bytes_per_device"]
             for x in q_recs if x["status"] == "ok"}
    assert len(peaks) == 6 and all(
        x["collectives"]["total_count"] > 0 and x["peak_bytes_per_device"]
        >= x["output_bytes_per_device"] + x["temp_bytes_per_device"]
        for x in q_recs if x["status"] == "ok"), q_recs
    out["dryrun"] = {"counts": counts, "sweep_seconds": sweep_s,
                     "qwen3_seconds": q_s, "train_4k_gib": gib,
                     "qwen3_flops_per_device": flops,
                     "qwen3_peak_bytes_per_device": peaks}
    print(f"mesh (c) dry run on the meta device (python -m "
          f"repro_torch.launch.dryrun): --all --no-trace "
          f"{counts} in {sweep_s:.1f} s; --all --arch {EP_ARCH} (its 8 "
          f"cells, FLOPs traced on single-pod cells, rank 0's readings on "
          f"every ok cell: the whole sweep's traces take ~11 min on a CPU "
          f"host) in {q_s:.1f} s, FLOPs per device "
          f"{ {k: f'{v:.4g}' for k, v in flops.items()} }, peak bytes per "
          f"device {peaks}; train_4k "
          f"argument GiB per device on 16 x 16: {gib}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"mesh phase {out['seconds']:.1f} s (the dry run started in the "
          f"background after phase 7) on {card}")
    return out


# main path 15 (phase 18): the partitioned train step.  Two spawned
# processes share the card on a gloo process group, their meshes "cuda"
# DeviceMeshes (launch.mesh.make_test_mesh(device="cuda")): each rank's
# shards of the state stay on the card, and gloo carries the collectives
# through host memory (NCCL refuses two ranks on one GPU).  (a)
# h2o-danube-3-4b at full width cut to 2 layers, fp32 compute: two steps
# on a (2, 1) and on a (1, 2) ("data", "model") mesh from one state, each
# against two one-process steps on the card; (b) mamba2-130m uncut: two
# steps on (2, 1), saved; elastic_restore onto (1, 2) and onto one
# process (rank 0), a third step from each; (c) qwen3-moe-30b-a3b's
# smoke config at capacity factor 0.5: two steps on (2, 1), the drop
# counts equal.  All legs from step 10 (learning rate 3e-5), at the CPU
# test's tolerances (tests/test_torch_partitioned.py), each rank holding
# its blocks to its own one-process run (no gathers).  Adam's update
# hardly depends on the gradient's scale, so the grad norm and aux loss
# are held at rtol 1e-5 as the CPU test holds them, and the moments
# relative to each leaf's largest entry.  Started in the background
# after phase 10d, held in phase 18.
PART_ARCHS = ("h2o-danube-3-4b", "mamba2-130m", "qwen3-moe-30b-a3b")
PART_MESHES = ((2, 1), (1, 2))
PART_BATCH = (4, 512)
PART_MOE_FACTOR = 0.5
PART_LOSS_RTOL = 1e-6
PART_METRIC_RTOL = 1e-5
PART_LEAF_ATOL = 1e-5
PART_MOMENT_RTOL = 1e-4
PART_TIMEOUT_S = 480


def part_batch(vocab, seed, b=PART_BATCH[0], s=PART_BATCH[1]):
    """Seeded tokens; the loss mask drops ~30 % of the positions and one
    whole row, so the ranks' kept counts differ."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s + 1))
    mask = (rng.random((b, s)) >= 0.3).astype(np.float32)
    mask[b - 3] = 0.0
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32), "loss_mask": mask}


def part_sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


PART_METRICS = ("loss", "grad_norm", "aux_loss")


def part_steps(torch, step, state, batches, dev):
    """``state`` through one step a batch: (state, {metric: a value a
    step} of ``PART_METRICS``, ms a step)."""
    metrics, ms = {k: [] for k in PART_METRICS}, []
    for batch in batches:
        part_sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        for k in PART_METRICS:
            metrics[k].append(float(m[k]))
        part_sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, metrics, ms


def part_close(got, want, rtol):
    """Whether every value of ``got`` is within ``rtol`` of ``want``'s
    (relative; zeros equal)."""
    return len(got) == len(want) and all(
        abs(x - y) <= rtol * abs(y) for x, y in zip(got, want))


def part_hold(tag, got, want):
    """Hold a partitioned run's ``part_steps`` metrics against the
    one-process run's: the loss at ``PART_LOSS_RTOL``, the grad norm and
    the aux loss at ``PART_METRIC_RTOL``."""
    for k in PART_METRICS:
        rtol = PART_LOSS_RTOL if k == "loss" else PART_METRIC_RTOL
        assert part_close(got[k], want[k], rtol), (tag, k, got[k], want[k])


def part_free(torch, dev):
    """Free what only the garbage collector would (reference cycles of
    earlier legs), hand the allocator's cached blocks back (the card is
    shared with the smoke's other processes) and start a new peak."""
    import gc
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def part_held(P, leaves, dev):
    """(bytes of this rank's shards, bytes of the whole state); fails if
    a shard left ``dev``."""
    held = whole = 0
    for x in leaves:
        local = x.to_local() if P.is_dtensor(x) else x
        assert local.device.type == dev, (local.device, dev)
        held += local.numel() * local.element_size()
        whole += x.numel() * x.element_size()
    return held, whole


def part_errs(got, want):
    """A partitioned run's distance from the one-process run's, as
    printed."""
    def rel(k):
        return max((abs(x - y) / abs(y) if y else abs(x))
                   for x, y in zip(got[k], want[k]))
    return (f"loss within {rel('loss'):.2e}, grad norm {rel('grad_norm'):.2e}"
            f", aux loss {rel('aux_loss'):.2e} (relative), every leaf of "
            f"its blocks within {got['max_err']:.2e}, every moment within "
            f"{got['moment_err']:.2e} of its leaf's largest entry")


def part_against(torch, P, state, ref):
    """This rank's block of each leaf of ``state`` against the same block
    of ``ref``'s (whole leaves on this rank: no communication): (the
    largest difference, the largest of a moment's relative to its whole
    ``ref`` leaf's largest entry, whether all are bit-equal)."""
    from repro_torch.train.checkpoint import _flatten_with_names, tree_leaves
    names, leaves, _ = _flatten_with_names(state)
    err, moment, equal = 0.0, 0.0, True
    for name, x, want in zip(names, leaves, tree_leaves(ref)):
        want = torch.as_tensor(want).to(x.device)
        scale = float(want.float().abs().max())
        if P.is_dtensor(x):
            want = P.block_of(want, P.sharding_of(x))
            x = x.to_local()
        diff = float((x.float() - want.float()).abs().max())
        err = max(err, diff)
        if name.startswith((".opt/.mu", ".opt/.nu")) and scale > 0:
            moment = max(moment, diff / scale)
        equal = equal and torch.equal(x, want)
    return err, moment, equal


def part_model(torch, arch, dev, smoke, num_layers=None, **extra):
    """(api, train step, fresh, boxed) of ``arch`` in fp32 compute (its
    smoke config with ``smoke``, else cut to ``num_layers`` if given;
    ``extra`` replaces config fields):
    ``fresh()`` gives the seeded state at step 10 on ``dev`` (learning
    rate 3e-5), ``boxed`` the state's boxed tree."""
    from dataclasses import replace

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models.api import model_api
    from repro_torch.train import loop
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if num_layers and not smoke:
        cfg = replace(cfg, num_layers=num_layers)
    api = model_api(replace(cfg, dtype="float32", **extra))
    hyper = loop.TrainHyper()

    def fresh():
        state = loop.init_train_state(
            api.init(torch.Generator(device=dev).manual_seed(0)), hyper)
        return state._replace(opt=state.opt._replace(
            step=torch.tensor(10, dtype=torch.int32, device=dev)))
    boxed = loop.train_state_boxed(
        L.abstract(api.init, torch.Generator().manual_seed(0)), hyper)
    return api, loop.make_train_step(api, hyper), fresh, boxed


def part_leg_a(torch, rank, dev, smoke):
    """(a): danube's steps on both meshes against the one-process step."""
    import torch.distributed as dist

    from repro_torch import distributed as pdist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import partition as P
    from repro_torch.train.checkpoint import tree_leaves
    api, step, fresh, boxed = part_model(torch, PART_ARCHS[0], dev, smoke,
                                         num_layers=2)
    batches = [part_batch(api.cfg.vocab_size, 10 + i) for i in range(2)]
    out = {"params": sum(x.numel() for x in tree_leaves(fresh().params))}
    # the one-process steps on each rank in turn (one peak at a time), so
    # that each holds its blocks to them with no gather
    for r in range(2):
        if r == rank:
            ref, metrics, ms = part_steps(torch, step, fresh(), batches,
                                          dev)
            out["plain"] = dict(metrics, ms=ms)
            part_free(torch, dev)
        dist.barrier()
    for shape in PART_MESHES:
        mesh = make_test_mesh(shape, ("data", "model"), device=dev)
        placed = P.place(fresh(), P.tree_named_shardings(boxed, mesh))
        part_free(torch, dev)
        with pdist.count_wire() as wire:
            placed, metrics, ms = part_steps(torch, step, placed, batches,
                                             dev)
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
        held, whole = part_held(P, tree_leaves(placed), dev)
        err, moment, _ = part_against(torch, P, placed, ref)
        out[str(shape)] = dict(metrics, ms=ms, wire=wire, held=held,
                               whole=whole, peak=peak, max_err=err,
                               moment_err=moment)
        del placed
        part_free(torch, dev)
    return out


def part_leg_b(torch, rank, dev, smoke, work_dir):
    """(b): mamba2 saved from (2, 1), restored onto (1, 2) and onto one
    process, a third step from each."""
    import torch.distributed as dist

    from repro_torch import distributed as pdist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import partition as P
    from repro_torch.train.checkpoint import (load_checkpoint_arrays,
                                              save_checkpoint, tree_leaves)
    from repro_torch.train.fault_tolerance import elastic_restore
    api, step, fresh, boxed = part_model(torch, PART_ARCHS[1], dev, smoke)
    state = fresh()
    batches = [part_batch(api.cfg.vocab_size, 20 + i) for i in range(3)]
    # the uninterrupted run in one process, on each rank
    ref, plain, _ = part_steps(torch, step, state, batches, dev)
    part_free(torch, dev)
    ckpt = os.path.join(work_dir, "part_ckpt")
    mesh = make_test_mesh(PART_MESHES[0], ("data", "model"), device=dev)
    placed = P.place(state, P.tree_named_shardings(boxed, mesh))
    with pdist.count_wire() as wire:
        placed, metrics, ms = part_steps(torch, step, placed, batches[:2],
                                         dev)
    t0 = time.perf_counter()
    path = save_checkpoint(ckpt, 2, placed)
    save_s = time.perf_counter() - t0
    saved = load_checkpoint_arrays(path)[1]
    placed, third, ms3 = part_steps(torch, step, placed, batches[2:], dev)
    held, whole = part_held(P, tree_leaves(placed), dev)
    err, moment, _ = part_against(torch, P, placed, ref)
    del placed
    out = {k: metrics[k] + third[k] for k in PART_METRICS}
    out.update(ms=ms + ms3, wire=wire, save_s=save_s, held=held,
               whole=whole, plain=plain, max_err=err, moment_err=moment,
               restores={})
    # onto (1, 2), both ranks; then onto one process, rank 0 alone
    for target in [PART_MESHES[1]] + ([None] if rank == 0 else []):
        shardings = None if target is None else P.tree_named_shardings(
            boxed, make_test_mesh(target, ("data", "model"), device=dev))
        restored, at = elastic_restore(ckpt, state, shardings)
        leaves = tree_leaves(restored)
        part_held(P, leaves, dev)
        _, _, bit_equal = part_against(torch, P, restored, saved)
        new, m3, ms_r = part_steps(torch, step, restored, batches[2:], dev)
        err, moment, _ = part_against(torch, P, new, ref)
        out["restores"][str(target)] = dict(
            m3, step=at, bit_equal=bit_equal,
            dtensor=P.is_dtensor(leaves[0]), ms=ms_r[0], max_err=err,
            moment_err=moment)
        del restored, new
        part_free(torch, dev)
        if target is not None:
            dist.barrier()
    return out


def part_leg_c(torch, rank, dev):
    """(c): qwen3-moe's smoke config at ``PART_MOE_FACTOR`` on (2, 1)
    against the one-process step, the drop counts equal."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import partition as P
    from repro_torch.train.checkpoint import tree_leaves
    api, step, fresh, boxed = part_model(
        torch, PART_ARCHS[2], dev, True,
        moe_capacity_factor=PART_MOE_FACTOR)
    assert api.cfg.remat == "full"
    batches = [part_batch(api.cfg.vocab_size, 30 + i) for i in range(2)]
    with moe.count_drops() as plain_drops:
        ref, plain, _ = part_steps(torch, step, fresh(), batches, dev)
    mesh = make_test_mesh(PART_MESHES[0], ("data", "model"), device=dev)
    placed = P.place(fresh(), P.tree_named_shardings(boxed, mesh))
    with moe.count_drops() as drops:
        placed, metrics, ms = part_steps(torch, step, placed, batches, dev)
    part_held(P, tree_leaves(placed), dev)
    err, moment, _ = part_against(torch, P, placed, ref)
    del placed, ref
    part_free(torch, dev)
    return dict(metrics, ms=ms, plain=plain, drops=drops["dropped"],
                plain_drops=plain_drops["dropped"], max_err=err,
                moment_err=moment)


# (d), after the train legs in the same two processes: partitioned
# serving (models.partitioned) on (2, 1) and (1, 2), fp32 compute: the
# prefill of a PART_PROMPT-token prompt under DEFAULT_RULES (flash
# attention and the SSD scan on each rank's rows), its cache padded to
# the decode length and placed under DECODE_RULES, then PART_STEPS greedy
# make_serve_step steps under DECODE_RULES, held as the CPU test holds
# them (tests/test_torch_partitioned_serve.py) against the one-process
# engine on the same rank: tokens equal, logits and every cache block
# within PART_SERVE_REL of the leaf's largest entry.  Each rank also
# holds its collectives of the prefill and of a decode step to the dry
# run's shape-only ones for its coordinate, and the allocator's rise over
# the prefill and over a decode step (the second, warm) to the dry run
# tracker's peak less arguments for the same rank-local shapes, within
# PART_MEM_RTOL.  The kernels' launches are counted over the partitioned
# steps only.
PART_SERVE = (("h2o-danube-3-4b", 2), ("mamba2-130m", None),
              ("qwen3-moe-30b-a3b", "smoke"))
PART_PROMPT = (2, 1024)
PART_STEPS = 8
PART_SERVE_REL = 1e-5
PART_MEM_RTOL = 0.15


def part_serve_cfg(arch, depth, smoke):
    """``arch``'s config in fp32 compute: uncut, cut to ``depth``
    layers, or its smoke config (``depth == "smoke"``, or ``smoke``)."""
    from dataclasses import replace

    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke or depth == "smoke" \
        else get_config(arch)
    if isinstance(depth, int) and not smoke:
        cfg = replace(cfg, num_layers=depth)
    return replace(cfg, dtype="float32")


def part_rel(a, b):
    """``a``'s largest distance from ``b`` over ``b``'s largest entry."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def part_blocks_err(P, tree, whole):
    """The largest error of this rank's blocks of ``tree`` against the
    same blocks of ``whole``, relative to each whole leaf's largest
    entry, and whether each block has its spec's local shape."""
    from repro_torch.train.checkpoint import tree_leaves
    err, shapes = 0.0, True
    for x, w in zip(tree_leaves(tree), tree_leaves(whole)):
        sh = P.sharding_of(x)
        err = max(err, part_rel(x.to_local(), P.block_of(w, sh)))
        shapes = shapes and tuple(x.to_local().shape) == P.local_shape(
            tuple(w.shape), sh.spec, sh.mesh)
    return err, shapes


def part_tracked(P, cfg, step, b, s, shape, coord, cache_len=None):
    """The dry run's readings of this rank's program at these shapes
    (``launch.dryrun.rank_program`` on an abstract mesh at ``coord``):
    (peak less arguments, collectives)."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    mesh = P.abstract_mesh(shape, ("data", "model"), coord)
    rules = P.DECODE_RULES if step == "decode" else P.DEFAULT_RULES
    got = dryrun.trace_readings(*dryrun.rank_program(
        cfg, ShapeCell("leg", s, b, step), mesh, rules, cache_len=cache_len))
    return (got["peak_bytes_per_device"] - got["argument_bytes_traced"],
            got["collectives"])


def part_leg_serve(torch, rank, dev, smoke):
    """(d): partitioned prefill and decode against the one-process
    engine on this rank, per arch and mesh."""
    import numpy as np

    from repro_torch import distributed as pdist
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import partitioned as PT
    from repro_torch.models.api import model_api
    from repro_torch.serve.engine import ServeEngine, make_serve_step
    from repro_torch.sharding import partition as P
    b, s = PART_PROMPT if not smoke else (PART_PROMPT[0], 8)
    cache_len = s + PART_STEPS
    out = {}
    for arch, depth in PART_SERVE:
        cfg = part_serve_cfg(arch, depth, smoke)
        api = model_api(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(0))
        rng = np.random.default_rng(40)
        batch = {"tokens": torch.tensor(
            rng.integers(1, cfg.vocab_size, (b, s)), dtype=torch.int32,
            device=dev)}
        step = make_serve_step(api)
        boxed = L.abstract(api.init, torch.Generator())
        with torch.no_grad():
            want_l, want_c = api.prefill(params, batch)
            want_c = ServeEngine(api, params, slots=b, max_seq=cache_len,
                                 device=dev)._merge_cache(want_c)
            want_c0 = dryrun.tree_map(torch.clone, want_c)
            tok = want_l[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            want = []
            for i in range(PART_STEPS):
                tok, lg, want_c = step(params, want_c, tok, s + i)
                want.append((tok[:, 0].tolist(), lg))
        res = {"params": sum(x.numel() for x in
                             dryrun.tree_leaves(params)), "prompt": (b, s)}
        for shape in PART_MESHES:
            mesh = make_test_mesh(shape, ("data", "model"), device=dev)
            coord = tuple(mesh.get_coordinate())
            pre = P.place(params, P.tree_named_shardings(boxed, mesh,
                                                         P.DEFAULT_RULES))
            part_free(torch, dev)
            fk.launches = sk.launches = 0
            before = torch.cuda.memory_allocated() if dev == "cuda" else 0
            part_sync(torch, dev)
            t0 = time.perf_counter()
            with torch.no_grad(), pdist.count_wire() as wire_pre:
                logits, cache = PT.prefill(cfg, pre, batch,
                                           cache_len=cache_len)
            part_sync(torch, dev)
            leg = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
                   "prefill_rise": (torch.cuda.max_memory_allocated()
                                    - before if dev == "cuda" else None),
                   "launches": {"flash_attention": fk.launches,
                                "ssd_scan": sk.launches},
                   "prefill_wire": wire_pre["bytes"]}
            del pre
            whole = P.full_tensor(logits)
            leg["prefill_err"] = part_rel(whole, want_l)
            leg["prefill_cache"] = part_blocks_err(P, cache, want_c0)
            placed = P.place(params, P.tree_named_shardings(
                boxed, mesh, P.DECODE_RULES))
            tok = whole[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            leg.update(tokens=[], want_tokens=[], errs=[], ms=[], wire=[])
            with torch.no_grad():
                for i in range(PART_STEPS):
                    part_free(torch, dev)
                    before = torch.cuda.memory_allocated() \
                        if dev == "cuda" else 0
                    part_sync(torch, dev)
                    t0 = time.perf_counter()
                    with pdist.count_wire() as wire:
                        tok, lg, cache = step(placed, cache, tok, s + i)
                    part_sync(torch, dev)
                    leg["ms"].append((time.perf_counter() - t0) * 1e3)
                    if dev == "cuda":
                        leg.setdefault("decode_mem", []).append(
                            (before, torch.cuda.max_memory_allocated(),
                             torch.cuda.memory_allocated()))
                    if i == 1:
                        leg["decode_rise"] = (
                            torch.cuda.max_memory_allocated() - before
                            if dev == "cuda" else None)
                        leg["decode_ops"] = dryrun.collectives_record(
                            wire["ops"])
                    leg["wire"].append(wire["bytes"])
                    leg["tokens"].append(tok[:, 0].tolist())
                    leg["want_tokens"].append(want[i][0])
                    leg["errs"].append(part_rel(lg, want[i][1]))
            leg["decode_cache"] = part_blocks_err(P, cache, want_c)
            leg["prefill_ops"] = dryrun.collectives_record(wire_pre["ops"])
            leg["superblock_bytes"] = sum(
                x.to_local()[0].numel() * x.element_size()
                for x in dryrun.tree_leaves(placed["blocks"]))
            del placed, cache, logits
            part_free(torch, dev)
            leg["tracked_prefill"], leg["tracked_prefill_ops"] = \
                part_tracked(P, cfg, "prefill", b, s, shape, coord,
                             cache_len=cache_len)
            leg["tracked_decode"], leg["tracked_decode_ops"] = \
                part_tracked(P, cfg, "decode", b, cache_len, shape, coord)
            res[str(shape)] = leg
        out[arch] = res
        del params, want_c, want_c0, want
        part_free(torch, dev)
    return out


def part_worker(rank, port, work_dir, src, dev, smoke):
    """One of phase 18's two processes: a gloo group between them, the
    state on ``dev``; writes its readings as JSON."""
    sys.path.insert(0, src)
    # the card is shared: no cached segments sized for one step's peak
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    if dev == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        fk.launches = sk.launches = 0
        t0 = time.perf_counter()
        out = {"a": part_leg_a(torch, rank, dev, smoke),
               "b": part_leg_b(torch, rank, dev, smoke, work_dir),
               "c": part_leg_c(torch, rank, dev)}
        out["train_seconds"] = time.perf_counter() - t0
        out["launches"] = {"flash_attention": fk.launches,
                           "ssd_scan": sk.launches}
        out["d"] = part_leg_serve(torch, rank, dev, smoke)
        out["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work_dir, f"part{rank}.json"), "w") as f:
        json.dump(out, f)


def part_start(work_dir, dev="cuda", smoke=False):
    """Start phase 18's two processes (daemons: they end with this
    script).  Returns {name: run} for ``background_stop`` and
    ``phase_partitioned``."""
    import multiprocessing

    from repro_torch import distributed as pdist
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    port = pdist._free_port()
    runs = {}
    for rank in range(2):
        proc = multiprocessing.get_context("spawn").Process(
            target=part_worker, args=(rank, port, work_dir, src, dev, smoke),
            daemon=True)
        proc.start()
        runs[f"part{rank}"] = {"proc": proc, "t0": time.perf_counter()}
    return runs


def phase_partitioned(runs, work_dir, card):
    """Main path 15: wait for ``part_start``'s processes and hold what
    they computed (see ``PART_ARCHS``).  Returns the phase's numbers."""
    try:
        for name, run in runs.items():
            run["proc"].join(max(PART_TIMEOUT_S - (time.perf_counter()
                                                   - run["t0"]), 1))
            assert not run["proc"].is_alive(), f"{name} did not end"
            assert run["proc"].exitcode == 0, \
                f"{name} failed (exit code {run['proc'].exitcode})"
    finally:
        background_stop(runs)
    ranks = []
    for r in range(2):
        with open(os.path.join(work_dir, f"part{r}.json")) as f:
            ranks.append(json.load(f))
    a0, b0 = ranks[0]["a"], ranks[0]["b"]
    for r, res in enumerate(ranks):
        assert res["launches"] == {"flash_attention": 0, "ssd_scan": 0}, \
            (r, res["launches"])
        for shape in PART_MESHES:
            leg = res["a"][str(shape)]
            part_hold(("a", shape, r), leg, res["a"]["plain"])
            assert leg["max_err"] <= PART_LEAF_ATOL, \
                f"(a) {shape} rank {r}: a leaf {leg['max_err']:.3g} off"
            assert leg["moment_err"] <= PART_MOMENT_RTOL, \
                f"(a) {shape} rank {r}: a moment {leg['moment_err']:.3g} off"
            # (2, 1) splits every leaf with an "embed" dim (all but the
            # step); (1, 2) leaves the KV projections and norms whole
            assert leg["held"] < leg["whole"] * (
                0.51 if shape == (2, 1) else 1.0), (r, shape, leg)
        b = res["b"]
        part_hold(("b", r), b, b["plain"])
        assert b["max_err"] <= PART_LEAF_ATOL, \
            f"(b) rank {r}: the third step {b['max_err']:.3g} off"
        assert b["moment_err"] <= PART_MOMENT_RTOL, \
            f"(b) rank {r}: a moment {b['moment_err']:.3g} off"
        for target, rest in b["restores"].items():
            assert rest["step"] == 2 and rest["bit_equal"], (r, target)
            assert rest["dtensor"] == (target != "None"), (r, target)
            for want in (b0, b["plain"]):
                part_hold(("b", r, target), rest,
                          {k: want[k][2:] for k in PART_METRICS})
            assert rest["max_err"] <= PART_LEAF_ATOL, \
                f"(b) rank {r}, the third step after the restore onto " \
                f"{target}: {rest['max_err']:.3g}"
            assert rest["moment_err"] <= PART_MOMENT_RTOL, \
                f"(b) rank {r}, the third step after the restore onto " \
                f"{target}: a moment {rest['moment_err']:.3g} off"
        c = res["c"]
        part_hold(("c", r), c, c["plain"])
        assert c["drops"] == c["plain_drops"] > 0, (r, c["drops"],
                                                     c["plain_drops"])
        assert c["plain"]["aux_loss"][0] > 0, (r, c["plain"])
        assert c["max_err"] <= PART_LEAF_ATOL, \
            f"(c) rank {r}: a leaf {c['max_err']:.3g} off"
        assert c["moment_err"] <= PART_MOMENT_RTOL, \
            f"(c) rank {r}: a moment {c['moment_err']:.3g} off"
    assert set(b0["restores"]) == {str(PART_MESHES[1]), "None"}
    launches = part_serve_hold(ranks, card)
    out = {"ranks": ranks, "seconds": max(r["seconds"] for r in ranks),
           "serve_launches": launches}
    pa = a0["plain"]
    print(f"partitioned (a) {PART_ARCHS[0]} full width, 2 layers "
          f"({a0['params']:,} parameters), fp32 compute, B {PART_BATCH[0]}, "
          f"S {PART_BATCH[1]}, from step 10: one process on the card "
          f"{pa['ms'][0]:.1f} / {pa['ms'][1]:.1f} ms a step, loss "
          f"{pa['loss']} ({card})")
    for shape in PART_MESHES:
        for r, res in enumerate(ranks):
            leg = res["a"][str(shape)]
            w = leg["wire"]
            print(f"partitioned (a) {shape} rank {r}: "
                  f"{leg['ms'][0]:.1f} / {leg['ms'][1]:.1f} ms a step; "
                  f"holds {leg['held']:,} of the state's {leg['whole']:,} "
                  f"bytes on the card; peak {leg['peak'] or 0:,} bytes; gloo "
                  f"payload {w['bytes']:,} bytes in {w['collectives']} "
                  f"collectives, {w['host_copies']} card-host copies; "
                  + part_errs(leg, res["a"]["plain"]) + f" ({card})")
    for r, res in enumerate(ranks):
        b = res["b"]
        w = b["wire"]
        print(f"partitioned (b) {PART_ARCHS[1]} uncut on (2, 1) rank {r}: "
              f"{', '.join(f'{x:.1f}' for x in b['ms'])} ms a step (3 "
              f"steps), holds {b['held']:,} of {b['whole']:,} bytes, gloo "
              f"payload {w['bytes']:,} bytes in two steps, saved in "
              f"{b['save_s']:.2f} s; against the one-process run "
              + part_errs(b, b["plain"]) + "; "
              + "; ".join(
                  f"restored onto {'one process' if t == 'None' else t} "
                  f"(step {x['step']}"
                  + (", bit-equal" if x["bit_equal"] else "")
                  + f"): third step {x['ms']:.1f} ms, loss "
                  f"{x['loss'][0]:.7f}, "
                  + part_errs(x, {k: b["plain"][k][2:] for k in PART_METRICS})
                  for t, x in b["restores"].items()) + f" ({card})")
    for r, res in enumerate(ranks):
        c = res["c"]
        print(f"partitioned (c) {PART_ARCHS[2]} smoke config at capacity "
              f"factor {PART_MOE_FACTOR} on (2, 1) rank {r}: "
              f"{c['ms'][0]:.1f} / {c['ms'][1]:.1f} ms a step, "
              f"{c['drops']:,} choices dropped in two steps (one process: "
              f"{c['plain_drops']:,}), aux loss {c['aux_loss']}; "
              + part_errs(c, c["plain"]) + f" ({card})")
    print(f"partitioned phase: the job {out['seconds']:.1f} s in two "
          f"processes sharing the card (the train legs "
          f"{max(r['train_seconds'] for r in ranks):.1f} s; started after "
          f"phase 10d, beside phases 10e-17) on {card}")
    return out


def part_serve_hold(ranks, card):
    """Hold leg (d) of each rank and print its numbers; returns the
    flash and SSD launches of the partitioned steps by arch, summed over
    the ranks and meshes."""
    launches = {}
    for r, res in enumerate(ranks):
        for arch, depth in PART_SERVE:
            got = res["d"][arch]
            for shape in PART_MESHES:
                leg = got[str(shape)]
                tag = ("d", arch, shape, r)
                rise = {w: leg[f"{w}_rise"] for w in ("prefill", "decode")}
                print(f"partitioned (d) {arch} ({got['params']:,} parameters"
                      f", fp32 compute) on {shape} rank {r}: prefill of "
                      f"{got['prompt'][0]} x {got['prompt'][1]} tokens "
                      f"{leg['prefill_ms']:.1f} ms ({leg['launches']} "
                      f"launches, gloo payload {leg['prefill_wire']:,} "
                      f"bytes), logits within {leg['prefill_err']:.2e}, "
                      f"cache blocks {leg['prefill_cache'][0]:.2e}; "
                      f"{PART_STEPS} decode steps "
                      f"{', '.join(f'{x:.1f}' for x in leg['ms'])} ms, "
                      f"logits within {max(leg['errs']):.2e}, "
                      f"cache blocks {leg['decode_cache'][0]:.2e}; a decode "
                      f"step's gloo payload {leg['wire'][1]:,} bytes in "
                      f"{leg['decode_ops']['total_count']} collectives "
                      f"(a super-block's weights a rank "
                      f"{leg['superblock_bytes']:,}); allocator rise "
                      f"prefill {rise['prefill']} / tracker "
                      f"{leg['tracked_prefill']:,}, decode step "
                      f"{rise['decode']} / tracker {leg['tracked_decode']:,}"
                      f" bytes; decode memory {leg.get('decode_mem')} ({card})")
                assert leg["tokens"] == leg["want_tokens"], tag
                assert leg["prefill_err"] <= PART_SERVE_REL, \
                    (tag, leg["prefill_err"])
                assert max(leg["errs"]) <= PART_SERVE_REL, (tag, leg["errs"])
                for what in ("prefill_cache", "decode_cache"):
                    err, shapes = leg[what]
                    assert err <= PART_SERVE_REL and shapes, (tag, what, err)
                # decode moves activations: below a super-block's weights
                assert max(leg["wire"]) < leg["superblock_bytes"], \
                    (tag, leg["wire"], leg["superblock_bytes"])
                assert leg["prefill_ops"] == leg["tracked_prefill_ops"], tag
                assert leg["decode_ops"] == leg["tracked_decode_ops"], tag
                for what in ("prefill", "decode"):
                    rise, tracked = leg[f"{what}_rise"], leg[f"tracked_{what}"]
                    if rise is not None:
                        assert abs(rise - tracked) <= PART_MEM_RTOL * tracked, \
                            (tag, what, rise, tracked)
                want = {"flash_attention": 0, "ssd_scan": 0}
                kname = "ssd_scan" if arch == "mamba2-130m" \
                    else "flash_attention"
                # the CPU rehearsal (card "cpu") takes the plain versions
                assert leg["launches"][kname] > 0 or card == "cpu", \
                    (tag, leg["launches"])
                for k, n in leg["launches"].items():
                    launches.setdefault(k, {}).setdefault(arch, 0)
                    launches[k][arch] += n
                want[kname] = leg["launches"][kname]
                assert leg["launches"] == want, (tag, leg["launches"])

    return launches


# fig 12's quick configuration (benchmarks/fig12_scheduler_comparison.py
# and benchmarks/common.py): HMAI n = 11 at capacity 0.05, two UB queues
# at route_km 0.1, rate 0.05, seeds 50 and 51 (10,232 and 10,402 tasks).
# Each is cut to its first BASELINE_TASKS tasks (7,500 until the smoke
# passed its time limit on a slow host; PERF.md section 4): the six
# dispatches of the whole queues took 95 s on an H100 80GB HBM3 at 700 W,
# of 7,500 tasks 80 s, SA 34 s of it (a shorter route_km does not shorten
# these queues, whose reverse segments dominate)
FIG12 = dict(route_km=0.1, rate_scale=0.05)
FIG12_SEEDS = (50, 51)
BASELINE_TASKS = 2500
PREFIX_TASKS = 300   # whole windows of GA / SA / Min-Min (30 tasks)
OPS_TASKS = 60       # the ATen op count's prefix: two windows
# fig 14's constants (benchmarks/fig14_braking_distance.py): CAN bus and
# mechanical actuation times, and both vehicles at 60 km/h
T_DATA, T_MECH, V_MPS = 0.001, 0.019, 60.0 / 3.6
# the variability phase's base route: a queue with bounded turn and
# reverse segments, 798 tasks
VARIABILITY = dict(route_km=0.03, rate_scale=0.05, max_times_turn=2,
                   max_times_reverse=1, max_duration_turn=4.0,
                   max_duration_reverse=5.0, seed=13)
SCHEDULERS = ("worst", "ata", "minmin", "ga", "sa", "flexai")


def scheduler_runs(spec, params, backlog, draws=None):
    """Each baseline and FlexAI's greedy run as ``run(tasks [R, T],
    state0=None, health=None) -> (final, records)`` on ``spec.device``;
    ``draws`` optionally maps "ga" / "sa" to injected draws."""
    from repro_torch.core.flexai.engine import make_schedule_fn
    from repro_torch.core.schedulers import (SCAN_SCHEDULERS, GAConfig,
                                             SAConfig, make_metaheuristic_fn)
    draws = draws or {}
    runs = {}
    for name in ("worst", "ata", "minmin"):
        runs[name] = (lambda ta, state0=None, health=None,
                      fn=SCAN_SCHEDULERS[name]:
                      fn(spec, ta, state0=state0, health=health))
    for name, cfg in (("ga", GAConfig()), ("sa", SAConfig())):
        fn = make_metaheuristic_fn(spec, name, cfg, batched=True)
        runs[name] = (lambda ta, state0=None, health=None, fn=fn,
                      dr=draws.get(name): fn(0, ta, state0, health, dr))
    flex = make_schedule_fn(spec, backlog, batched=True)
    runs["flexai"] = (lambda ta, state0=None, health=None:
                      flex(params, ta, state0, health))
    return runs


def no_sync_dispatch(torch, fn):
    """``fn()`` under ``set_sync_debug_mode("error")``, so a host sync
    inside it raises; returns its result and its synchronised wall
    time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def row_stm(recs):
    """[R] STM rate of each route of a batched record (on its device)."""
    valid = recs.valid
    return (recs.met & valid).sum(-1) / valid.sum(-1).clamp_min(1)


def check_prefix(torch, plat, params, backlog, queue, dev="cuda"):
    """The first PREFIX_TASKS tasks of a route through every scheduler on
    the card and in the port on the CPU, with the same injected GA/SA
    draws: placements equal, or at a first difference the CPU's fitness
    (GA/SA) or Q (FlexAI) margin between the two choices below 1e-5
    relative (the CPU tests' rule against the JAX package)."""
    import numpy as np

    from repro_torch.core.faults import replay_actions
    from repro_torch.core.flexai import dqn
    from repro_torch.core.platform import (kind_feature_table,
                                           platform_init, spec_from_platform,
                                           state_vector)
    from repro_torch.core.schedulers import GAConfig, SAConfig
    from repro_torch.core.schedulers import metaheuristic as mh
    from repro_torch.core.tasks import TaskArrays, tasks_to_arrays
    ta = TaskArrays(*[f[None] for f in tasks_to_arrays(queue[:PREFIX_TASKS])])
    gen = torch.Generator().manual_seed(5)
    draws = {}
    for name, cfg, fn in (("ga", GAConfig(), mh.ga_draws),
                          ("sa", SAConfig(), mh.sa_draws)):
        draws[name] = fn(cfg, gen, 1, -(-PREFIX_TASKS // cfg.window), plat.n,
                         "cpu")
    cpu_spec = spec_from_platform(plat, "cpu")
    params_cpu = dqn.DQNParams(*[p.cpu() for p in params])
    out = {}
    for d, spec, p in (("cpu", cpu_spec, params_cpu),
                       (dev, spec_from_platform(plat, dev), params)):
        runs = scheduler_runs(spec, p, backlog, draws)
        out[d] = {k: run(ta.to(d))[1].action[0].cpu().numpy()
                  for k, run in runs.items()}
    notes = []
    for name in SCHEDULERS:
        got, want = out[dev][name], out["cpu"][name]
        diff = np.nonzero(got != want)[0]
        if not len(diff):
            continue
        k = int(diff[0])
        if name in ("worst", "ata", "minmin"):
            raise AssertionError(f"prefix: {name} placement {k} differs on "
                                 f"the card ({got[k]} vs {want[k]})")
        if name == "flexai":
            state = platform_init(plat.n)
            if k:
                state = scheduler_runs(cpu_spec, params_cpu, backlog)[
                    "flexai"](TaskArrays(*[f[:, :k] for f in ta]))[0]
            sv = state_vector(cpu_spec, torch.as_tensor(
                kind_feature_table()), backlog, state,
                TaskArrays(*[f[:, k] for f in ta]))
            q = dqn.qnet_apply(params_cpu, sv)[0]
            margin = float(q[want[k]] - q[got[k]])
        else:
            w = (GAConfig() if name == "ga" else SAConfig()).window
            lo, hi = k // w * w, k // w * w + w
            state = platform_init(plat.n)
            if lo:
                state = replay_actions(cpu_spec, TaskArrays(
                    *[f[:, :lo] for f in ta]), torch.as_tensor(
                        want[None, :lo]))[0]
            wt = TaskArrays(*[f[:, lo:hi] for f in ta])
            cand = torch.as_tensor(np.stack([want[lo:hi], got[lo:hi]]))
            fit = mh.window_fitness(cpu_spec, state, wt, cand[None])[0]
            margin = float((fit[0] - fit[1]) / fit[0].abs())
        if not margin < 1e-5:
            raise AssertionError(f"prefix: {name} placement {k} differs on "
                                 f"the card with a margin of {margin}")
        notes.append(f"{name} parts at task {k} (margin {margin:.2e})")
    print(f"prefix: the first {PREFIX_TASKS} tasks of route "
          f"{FIG12_SEEDS[0]} through all six schedulers on the card match "
          f"the CPU with the same draws"
          + (f"; {', '.join(notes)}" if notes else ": placements equal"))


def phase_baselines(torch, params, backlog, card, dev="cuda"):
    """Fig 12's comparison at its quick configuration: every baseline and
    FlexAI's greedy run schedule both queues, each in one batched
    dispatch with no host sync inside; then one brake task from each
    final state (fig 14)."""
    import numpy as np

    from repro_torch.core import environment as env
    from repro_torch.core.criteria import (camera_safety_time,
                                           rss_safe_distance)
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import route, spec_from_platform, summarize
    from repro_torch.core.tasks import (Task, TaskKind, stack_task_arrays,
                                        tasks_to_arrays)
    rate = FIG12["rate_scale"]
    plat = HMAIPlatform(capacity_scale=rate)
    spec = spec_from_platform(plat, dev)
    queues = [env.build_task_queue(env.EnvironmentParams(
        area=env.Area("UB"), seed=s, **FIG12))[:BASELINE_TASKS]
        for s in FIG12_SEEDS]
    lens = [len(q) for q in queues]
    batch = stack_task_arrays([tasks_to_arrays(q) for q in queues]).to(dev)
    brakes = stack_task_arrays([tasks_to_arrays([Task(
        uid=10**9 + i, kind=TaskKind.YOLO, camera_group="FC", camera_id=0,
        arrival_time=q[-1].arrival_time,
        safety_time=camera_safety_time("FC", "UB", "GS"))])
        for i, q in enumerate(queues)]).to(dev)
    check_prefix(torch, plat, params, backlog, queues[0], dev)
    print(f"baselines (fig 12's quick configuration: UB queues of "
          f"{lens[0]:,} / {lens[1]:,} tasks, HMAI n = {plat.n} at rate "
          f"{rate}) on {card}, one batched dispatch each, host syncs "
          f"forbidden inside; route {FIG12_SEEDS[0]} / {FIG12_SEEDS[1]}:")
    res = {}
    for name, run in scheduler_runs(spec, params, backlog).items():
        (final, recs), dt = no_sync_dispatch(torch, lambda run=run: run(batch))
        (_, brec), _ = no_sync_dispatch(
            torch, lambda run=run, final=final: run(brakes, state0=final))
        summ = [summarize(spec, route(final, r), route(recs, r))
                for r in range(2)]
        for s, n in zip(summ, lens):
            assert s["tasks"] == n and all(math.isfinite(v) for v in
                                           s.values()), (name, s)
        act = recs.action[recs.valid].cpu()
        assert ((act >= 0) & (act < plat.n)).all()
        assert bool(brec.valid[:, 0].all())
        t_sched = dt / sum(lens)
        brake = []
        for r in range(2):
            wait = float(brec.wait[r, 0]) * rate
            compute = float(brec.exec_time[r, 0]) * rate
            total = wait + t_sched + compute + T_DATA + T_MECH
            brake.append({"wait_ms": wait * 1e3, "compute_ms": compute * 1e3,
                          "total_ms": total * 1e3,
                          "distance_m": rss_safe_distance(V_MPS, V_MPS,
                                                          total)})
        res[name] = {"summaries": summ, "seconds": dt,
                     "ms_per_task": t_sched * 1e3, "brake": brake}
        two = lambda k: " / ".join(f"{s[k]:.4f}" for s in summ)  # noqa: E731
        print(f"  {name}: stm {two('stm_rate')}, r_balance "
              f"{two('r_balance')}, makespan {two('makespan_s')} s, energy "
              f"{two('total_energy_j')} J, total MS {two('total_ms')}; "
              f"{dt:.2f} s, {t_sched * 1e3:.4f} ms per task; brake wait "
              + " / ".join(f"{b['wait_ms']:.3f}" for b in brake)
              + " ms, compute " + " / ".join(f"{b['compute_ms']:.3f}"
                                             for b in brake)
              + " ms, braking distance " + " / ".join(
                  f"{b['distance_m']:.2f}" for b in brake) + " m")
    stm = {k: float(np.mean([s["stm_rate"] for s in v["summaries"]]))
           for k, v in res.items()}
    dist = {k: float(np.mean([b["distance_m"] for b in v["brake"]]))
            for k, v in res.items()}
    print("  mean stm " + ", ".join(f"{k} {v:.4f}" for k, v in stm.items())
          + "; mean braking distance " + ", ".join(
              f"{k} {v:.2f} m" for k, v in dist.items()))
    return res


def baseline_ops(torch, params, backlog, res, dev="cuda"):
    """ATen ops a step of each scheduler over the first OPS_TASKS tasks of
    fig 12's two queues, without a trace and with an all-ones one (the
    same bits: ``faults.start_trace``), into ``res[name]``."""
    from repro_torch.core import environment as env
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import spec_from_platform
    from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
    plat = HMAIPlatform(capacity_scale=FIG12["rate_scale"])
    head = stack_task_arrays([tasks_to_arrays(env.build_task_queue(
        env.EnvironmentParams(area=env.Area("UB"), seed=s, **FIG12))[
            :OPS_TASKS]) for s in FIG12_SEEDS]).to(dev)
    ones = torch.ones(2, OPS_TASKS, plat.n, device=dev)
    runs = scheduler_runs(spec_from_platform(plat, dev), params, backlog)
    for name, run in runs.items():
        res[name]["aten_ops_per_step"] = [
            aten_ops(lambda h=h, run=run: run(head, health=h)) / OPS_TASKS
            for h in (None, ones)]
    print(f"baselines: ATen ops a step (a task of each route, over the "
          f"first {OPS_TASKS}), without a trace / with an all-ones one: "
          + ", ".join(f"{k} {res[k]['aten_ops_per_step'][0]:.2f} / "
                      f"{res[k]['aten_ops_per_step'][1]:.2f}" for k in runs))


def phase_variability(torch, params, backlog, card, dev="cuda"):
    """The scenario fleet of the base route through FlexAI (health-aware,
    and fault-blind placements replayed under the traces) and every
    baseline with ``health=``; then one degradation episode through the
    TD kernel under a random fault trace.  Returns (STM by family and
    scheduler, TD launches of the episode, its seconds)."""
    import numpy as np

    from repro_torch.core import environment as env
    from repro_torch.core.faults import (build_health_trace,
                                         random_fault_events, replay_actions)
    from repro_torch.core.flexai import FlexAIConfig, ScanFlexAI
    from repro_torch.core.flexai.engine import Draws, make_schedule_fn
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import spec_from_platform
    from repro_torch.core.scenarios import FAMILIES, scenario_batch
    from repro_torch.core.tasks import tasks_to_arrays
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    plat = HMAIPlatform(capacity_scale=VARIABILITY["rate_scale"])
    spec = spec_from_platform(plat, dev)
    queue = env.build_task_queue(env.EnvironmentParams(**VARIABILITY))
    base = tasks_to_arrays(queue).to(dev)
    t0 = time.perf_counter()
    fleet = scenario_batch(base, plat.n, seed=13, n_per_family=8)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    s_count, t_len = fleet.tasks.arrival.shape
    assert s_count == 40 and fleet.health.shape == (40, t_len, plat.n)
    print(f"variability: {s_count} scenarios ({len(FAMILIES)} families x 8)"
          f" of the {t_len}-task base route in {gen_s:.3f} s on {card}")
    stm, walls = {}, {}
    for name, run in scheduler_runs(spec, params, backlog).items():
        (_, recs), walls[name] = no_sync_dispatch(
            torch, lambda run=run: run(fleet.tasks, health=fleet.health))
        stm[name] = row_stm(recs)
    blind = make_schedule_fn(spec, backlog, batched=True)
    (_, recs), walls["flexai_blind"] = no_sync_dispatch(torch, lambda: (
        replay_actions(spec, fleet.tasks, blind(params, fleet.tasks)[1]
                       .action, fleet.health)))
    stm["flexai_blind"] = row_stm(recs)
    stm = {k: v.cpu().numpy() for k, v in stm.items()}
    table = {fam: {k: float(v[fleet.family_rows(fam)].mean())
                   for k, v in stm.items()} for fam in FAMILIES}
    for fam, row in table.items():
        print(f"  stm {fam}: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in row.items()))
    print("  dispatch seconds: " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in walls.items()))
    gap = table["fault"]["flexai"] - table["fault"]["flexai_blind"]
    print(f"  fault family: FlexAI health-aware {table['fault']['flexai']:.4f}"
          f" vs fault-blind replayed {table['fault']['flexai_blind']:.4f} "
          f"(gap {gap:+.4f})")

    # one degradation episode through the TD kernel, from the trained
    # weights, at a constant epsilon of 0.1 with injected draws, so the
    # greedy steps are known
    cfg = FlexAIConfig(min_replay=64, eps_start=0.1, eps_end=0.1)
    trainer = ScanFlexAI(plat, cfg, td_kernel=True, device=dev)
    trainer.set_params(params)
    n_tasks = len(queue)
    trace = build_health_trace(n_tasks, plat.n,
                               random_fault_events(0, n_tasks, plat.n))
    rng = np.random.default_rng(1)
    size = np.minimum(np.arange(1, n_tasks + 1), cfg.replay_capacity)
    draws = Draws(torch.tensor(rng.random(n_tasks), dtype=torch.float32),
                  torch.tensor(rng.integers(0, plat.n, n_tasks)),
                  torch.tensor(np.stack([rng.integers(0, s, cfg.batch_size)
                                         for s in size])))
    td_kernel.launches = 0
    t0 = time.perf_counter()
    summ = trainer.train_episode(queue, draws=draws, health=trace)
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0
    launches = td_kernel.launches
    ts = trainer.ts
    assert launches == ts.updates == summ["update_steps"] > 0, \
        (launches, ts.updates, summ["update_steps"])
    assert all(math.isfinite(x) for x in trainer.losses)
    acts = ts.replay.a[:n_tasks].cpu().numpy()
    dead = trace[np.arange(n_tasks), acts] == 0.0
    greedy = draws.explore_u.numpy() >= np.float32(cfg.eps_start)
    assert (trace == 0.0).any() and not (dead & greedy).any(), \
        "the greedy arm picked a dead core"
    print(f"  degradation episode (TD kernel): {n_tasks} tasks under "
          f"{int((trace == 0.0).any(0).sum())} failed and "
          f"{int(((trace > 0) & (trace < 1)).any(0).sum())} degraded "
          f"core(s), {ts.updates} updates = {launches} TD launches, "
          f"{ep_s:.2f} s, stm {summ['stm_rate']:.4f}, mean loss "
          f"{summ['mean_loss']:.5f}; {int(dead.sum())} dead-core picks, "
          f"all on explore steps ({int(greedy.sum())} greedy steps)")
    return table, launches, ep_s, fleet, base


DP_CHECK_STEPS = 300      # the DP episode's prefix held to the CPU
SHARD_TASKS = 1000        # route prefix of the sharded phase


def phase_dp(torch, card, dev="cuda"):
    """Main path 6: one DP episode through ``launch/train.py --dp
    --td-kernel --rate-scale 0.025`` (4 lanes on the launcher's routes
    of seeds 0-3, half as long as at its default rate 0.05: the smoke's
    time limit),
    its grads-kernel launches counted (one a TD update, for all 4
    lanes); then the first ``DP_CHECK_STEPS`` steps of those routes on
    the card against the CPU with the same draws."""
    import numpy as np

    from repro_torch.core.flexai import dqn
    from repro_torch.core.flexai import engine
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import (kind_feature_table,
                                           spec_from_platform, state_vector)
    from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    from repro_torch.launch import train as train_launch
    targs = train_launch.parser().parse_args(
        ["--flexai", "--dp", "--td-kernel", "--episodes", "1",
         "--rate-scale", "0.025", "--device", dev])
    td_kernel.launches = 0
    trainer, history, dt, _ = train_launch.train_flexai(targs)
    launches = td_kernel.launches
    ts, h = trainer.ts, history[-1]
    assert launches == ts.updates == h["update_steps"] > 0, \
        (launches, ts.updates, h["update_steps"])
    assert len(trainer.losses) == ts.updates
    assert all(math.isfinite(x) for x in trainer.losses)
    stms = [lane["stm_rate"] for lane in h["lanes"]]
    print(f"dp: {targs.dp_lanes} lanes, {ts.env_steps} env steps, "
          f"{ts.updates} TD updates = {launches} grads-kernel launches "
          f"(one for all lanes) in {dt:.2f}s ({ts.env_steps / dt:.1f} "
          f"env-steps/s); per-lane stm "
          + ", ".join(f"{x:.4f}" for x in stms)
          + f"; mean loss {h['mean_loss']:.5f}")

    # the CPU check: the episode's first steps (its initial weights and
    # config) with injected draws.  (Hundreds of updates in, the card and
    # the CPU part, the plain version on the card as the kernel;
    # scripts/dp_divergence.py looks for where.)
    queues = train_launch.build_queues(targs)[0]
    plat = HMAIPlatform(capacity_scale=targs.rate_scale)
    cfg = trainer.cfg
    lanes, k = targs.dp_lanes, DP_CHECK_STEPS
    batch = stack_task_arrays([tasks_to_arrays(q[:k]) for q in queues])
    rng = np.random.default_rng(3)
    sizes = np.minimum(np.arange(1, k + 1), cfg.replay_capacity)
    draws = engine.Draws(
        torch.tensor(rng.random((lanes, k)), dtype=torch.float32),
        torch.tensor(rng.integers(0, plat.n, (lanes, k))),
        torch.tensor(np.stack([[rng.integers(0, s, cfg.batch_size)
                                for s in sizes] for _ in range(lanes)])))
    p0 = engine.dp_train_init(D, A, 8, lanes, seed=cfg.seed,
                              device=dev).eval_p

    def run(d, steps):
        ts0 = engine.dp_train_init(D, A, cfg.replay_capacity, lanes,
                                   device=d)
        p = dqn.DQNParams(*[w.to(d) for w in p0])
        ts0 = ts0._replace(eval_p=p, targ_p=p, opt=dqn.adam_init(p))
        fn = engine.make_dp_train_fn(spec_from_platform(plat, d), cfg,
                                     lanes, td_kernel=True)
        return fn(ts0, type(batch)(*[f[:, :steps] for f in batch]),
                  engine.Draws(*[x[:, :steps] for x in draws]))

    out = {d: run(d, k) for d in ("cpu", dev)}
    (ts_c, plat_c, recs_c, loss_c, upd_c), (ts_g, _, recs_g, loss_g,
                                            upd_g) = out["cpu"], out[dev]
    act_c, act_g = recs_c.action, recs_g.action.cpu()
    diff = (act_c != act_g).any(0).nonzero()
    if len(diff):
        # a matmul-rounding tie: the CPU's Q margin there must be tiny
        t = int(diff[0])
        lane = int((act_c[:, t] != act_g[:, t]).nonzero()[0])
        ts_t, plat_t = run("cpu", t)[:2] if t else (None, None)
        spec = spec_from_platform(plat)
        st = (plat_t if t else engine.platform_init(plat.n, lanes))
        sv = state_vector(spec, torch.as_tensor(kind_feature_table()),
                          cfg.backlog_scale, st, batch.step(t))
        q = dqn.qnet_apply(ts_t.eval_p if t else
                           dqn.DQNParams(*[w.cpu() for w in p0]), sv)[lane]
        margin = float(q[act_c[lane, t]] - q[act_g[lane, t]])
        assert margin < 1e-4, f"DP step {t} lane {lane}: margin {margin}"
        print(f"  dp CPU check: first difference at step {t} (lane "
              f"{lane}), a rounding tie (CPU Q margin {margin:.2e})")
    else:
        assert torch.equal(upd_c, upd_g) and int(upd_g.sum()) > 0
        close(loss_g, loss_c, 1e-4, 1e-7, "DP losses")
        for i, (g, c) in enumerate(zip(ts_g.eval_p, ts_c.eval_p)):
            close(g, c, 0, 1e-4, f"DP param p{i}")
        print(f"  dp CPU check: the episode's first {k} steps x {lanes} "
              f"lanes, {int(upd_g.sum())} updates, on {dev} match the CPU "
              f"with the same draws (actions and update mask equal, params "
              f"atol 1e-4)")
    return {"launches": launches, "updates": ts.updates,
            "env_steps": ts.env_steps, "seconds": dt, "stm": stms,
            "mean_loss": h["mean_loss"], "trainer": trainer,
            "queues": queues}


# the population fine-tune's lane batches: half of an epoch's 10 (one
# epoch until the smoke passed its time limit on a slow host; the 10 took
# 26-30 s on an H100 host)
POPULATION_BATCHES = 5


def phase_population(torch, params, base_cfg, fleet, base, card,
                     dev="cuda"):
    """Main path 7: the degradation fine-tune of ``benchmarks/
    scenarios.py`` (population lanes from the trained weights, its
    ``ft_cfg``) over the variability phase's 40-scenario fleet, one
    epoch's first ``POPULATION_BATCHES`` lane batches (of 10) with their
    health traces; every step where
    any lane updates launches the Adam-folded kernel once for all
    lanes.  Then each lane's STM on the base route (``_eval_stms``) and
    on the fleet under its traces, per family."""
    import numpy as np

    from repro_torch.core.flexai import ScanFlexAI
    from repro_torch.core.flexai.engine import make_schedule_fn
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.scenarios import FAMILIES, scenario_lane_batches
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    lanes = 4
    ft_cfg = dataclasses.replace(base_cfg, eps_start=0.25, eps_end=0.02,
                                 eps_decay_steps=2000, min_replay=128,
                                 seed=47)
    plat = HMAIPlatform(capacity_scale=VARIABILITY["rate_scale"])
    trainer = ScanFlexAI(plat, ft_cfg, lanes=lanes, td_kernel=True,
                         device=dev)
    trainer.set_params(params)
    td_kernel.launches = 0
    t0 = time.perf_counter()
    history = [trainer.train_episode(tasks_l, health=health_l)
               for tasks_l, health_l in itertools.islice(
                   scenario_lane_batches(fleet, lanes), POPULATION_BATCHES)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = td_kernel.launches
    steps_with_update = sum(h["update_steps"] for h in history)
    assert len(history) == POPULATION_BATCHES \
        and launches == steps_with_update > 0, \
        (len(history), launches, steps_with_update)
    assert all(math.isfinite(x) for x in trainer.losses)
    base_stm = trainer._eval_stms(base)
    sched = make_schedule_fn(trainer.spec, ft_cfg.backlog_scale,
                             batched=True)
    fleet_stm = []
    for lane in range(lanes):
        recs = sched(trainer.eval_params(lane), fleet.tasks,
                     health=fleet.health)[1]
        stm = row_stm(recs).cpu().numpy()
        fleet_stm.append({fam: float(stm[fleet.family_rows(fam)].mean())
                          for fam in FAMILIES})
    print(f"population: {lanes} lanes x {POPULATION_BATCHES} lane batches "
          f"of {fleet.tasks.arrival.shape[1]} steps in {dt:.2f}s, updates a "
          f"lane {trainer.ts.updates.tolist()}, {launches} Adam-kernel "
          f"launches (one a step with any update, for all lanes)")
    print("  per-lane stm on the base route: "
          + ", ".join(f"{x:.4f}" for x in base_stm))
    for lane, row in enumerate(fleet_stm):
        print(f"  lane {lane} stm on the fleet: " + ", ".join(
            f"{fam} {v:.4f}" for fam, v in row.items())
            + f"; mean {np.mean(list(row.values())):.4f}")
    return {"launches": launches, "seconds": dt,
            "updates": trainer.ts.updates.tolist(), "base_stm": base_stm,
            "fleet_stm": fleet_stm}


def phase_sharded(torch, dp, mesh, dev="cuda"):
    """Main path 8: the sharding seam on ``mesh``, a one-process NCCL
    mesh (one card): ``make_dp_train_fn(mesh=)`` against ``mesh=None`` on
    the DP routes' first ``SHARD_TASKS`` tasks, bit for bit, through the
    grads kernel; then ``FlexAIPlacementService(mesh=)`` against the unsharded
    service on the 8 served routes, cut to the same prefix."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import distributed as pdist
    from repro_torch.core.environment import (EnvironmentParams,
                                              build_task_queue)
    from repro_torch.core.flexai import engine
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import spec_from_platform
    from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serve.engine import FlexAIPlacementService
    trainer, k = dp["trainer"], SHARD_TASKS
    cfg, lanes = trainer.cfg, trainer.lanes
    spec = trainer.spec
    batch = stack_task_arrays([tasks_to_arrays(q[:k])
                               for q in dp["queues"]])

    def fresh():
        return engine.dp_train_init(D, A, cfg.replay_capacity, lanes,
                                    seed=cfg.seed, device=dev)

    td_kernel.launches = 0
    t0 = time.perf_counter()
    want = engine.make_dp_train_fn(spec, cfg, lanes, td_kernel=True)(
        fresh(), batch)
    got = engine.make_dp_train_fn(spec, cfg, lanes, mesh=mesh,
                                  td_kernel=True)(fresh(), batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = td_kernel.launches
    assert launches == want[0].updates + got[0].updates > 0
    same = (torch.equal(got[2].action, want[2].action)
            and torch.equal(got[3], want[3])
            and torch.equal(got[4], want[4])
            and all(torch.equal(a, b) for a, b in zip(
                (*got[0].eval_p, *got[0].targ_p, *got[0].opt.mu,
                 *got[0].opt.nu, *got[0].replay[:5]),
                (*want[0].eval_p, *want[0].targ_p, *want[0].opt.mu,
                 *want[0].opt.nu, *want[0].replay[:5]))))
    assert same, "the mesh DP trainer left the unsharded trajectory"
    print(f"sharded: mesh of {pdist.mesh_size(mesh)} ({dist.get_backend()}"
          f"), DP {lanes} lanes x {k} tasks with and without it: equal "
          f"bit for bit ({want[0].updates} updates each, {launches} "
          f"grads-kernel launches, {dt:.2f}s for both)")

    sargs = serve_launch.parser().parse_args(["--placement"])
    plat = HMAIPlatform(capacity_scale=sargs.rate_scale)
    queues = [build_task_queue(EnvironmentParams(
        route_km=sargs.route_km, rate_scale=sargs.rate_scale,
        seed=sargs.seed + i))[:k] for i in range(sargs.routes)]
    params = trainer.eval_params()
    res = [FlexAIPlacementService(plat, params, mesh=m,
                                  min_bucket=sargs.min_bucket,
                                  device=dev).place(queues)
           for m in (None, mesh)]
    for rw, rg in zip(*res):
        assert np.array_equal(rw["placements"], rg["placements"])
        assert rw["stm_rate"] == rg["stm_rate"]
    print(f"  placement service with the mesh equals the unsharded "
          f"one on the {len(queues)} served routes' first {k} tasks")
    return {"launches": launches, "seconds": dt,
            "updates": want[0].updates}


# the quick arm of benchmarks/serve_load.py: its base route (204 tasks,
# bucket 256) at HMAI n = 11, rate 0.05; 18 requests a trace; QoSConfig
# (policy "edf", chunk 8, min_bucket 16), 4 slots (3 in the sharded arm)
QOS_BASE = dict(route_km=0.008, rate_scale=0.05, seed=321, max_times_turn=1,
                max_times_reverse=1, max_duration_turn=2.0,
                max_duration_reverse=3.0)
QOS_REQUESTS = 18
QOS_LAUNCH = ["--placement", "--qos", "edf", "--continuous", "--routes", "8",
              "--route-km", "0.01", "--arrival-gap", "0.02"]


def qos_margin(torch, plat, params, backlog, ta, got, want):
    """The CPU's Q margin between its placement ``want`` and the card's
    ``got`` at their first difference on route ``ta`` [T] (host)."""
    import numpy as np

    from repro_torch.core.flexai import dqn
    from repro_torch.core.flexai.engine import make_schedule_fn
    from repro_torch.core.platform import (kind_feature_table,
                                           platform_init, spec_from_platform,
                                           state_vector)
    from repro_torch.core.tasks import TaskArrays
    k = int(np.nonzero(got != want)[0][0])
    spec = spec_from_platform(plat, "cpu")
    params = dqn.DQNParams(*[p.cpu() for p in params])
    batch = TaskArrays(*[f[None] for f in ta])
    state = platform_init(plat.n) if k == 0 else make_schedule_fn(
        spec, backlog, batched=True)(
            params, TaskArrays(*[f[:, :k] for f in batch]))[0]
    sv = state_vector(spec, torch.as_tensor(kind_feature_table()), backlog,
                      state, TaskArrays(*[f[:, k] for f in batch]))
    q = dqn.qnet_apply(params, sv)[0]
    return k, float(q[want[k]] - q[got[k]])


def phase_qos(torch, params, backlog, mesh, smi, dev="cuda"):
    """Main path 9: deadline-aware QoS placement serving
    (``serve/qos.py``, fed by ``serve/loadgen.py``) on ``params``, the
    quick arm of ``benchmarks/serve_load.py``: Poisson load 2.0 (seed
    11) drained and continuous; Gamma burstiness 4 at load 2.0 (seed 12)
    continuous; 6 requests on the measured service clock (seed 14);
    12 requests at load 1.5 (seed 13, 3 slots) with and without ``mesh``,
    drained and continuous, digests equal; the drain trace on the card
    and on the CPU, digests equal; then the QoS launcher.  Traces are
    built on the CPU and moved by ``submit``.  The measured arm's wall
    time a dispatch (one segment of ``chunk`` steps) is printed beside
    the virtual clock's charge for the same segment."""
    import numpy as np

    from repro_torch.core.environment import (EnvironmentParams,
                                              build_task_queue)
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.tasks import tasks_to_arrays
    from repro_torch.kernels.protocol import synchronize
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serve.durability import digests_equal, serving_digest
    from repro_torch.serve.loadgen import LoadGenConfig, generate
    from repro_torch.serve.policy import power_of_two_bucket
    from repro_torch.serve.qos import QoSConfig, QoSPlacementEngine
    t_phase = time.perf_counter()
    plat = HMAIPlatform(capacity_scale=QOS_BASE["rate_scale"])
    base = tasks_to_arrays(build_task_queue(EnvironmentParams(**QOS_BASE)))

    def serve(trace, slots=4, device=dev, mesh=None, deadline=None, **kw):
        eng = QoSPlacementEngine(
            plat, params, QoSConfig(policy="edf", slots=slots, chunk=8,
                                    min_bucket=16, **kw),
            backlog_scale=backlog, mesh=mesh, device=device)
        for r in trace:
            eng.submit(r.tasks, arrival=r.arrival, deadline=None
                       if deadline is None else r.arrival + deadline)
        t0 = time.perf_counter()
        eng.run_until_done()
        synchronize(eng.device)
        dt = time.perf_counter() - t0
        s = eng.stats()
        assert s["completed"] + s["shed"] == s["submitted"] == len(trace)
        assert s["queued"] == s["in_flight"] == 0
        assert eng.device.type == torch.device(device).type
        for r in eng.completed:
            pl = np.asarray(r.summary["placements"])
            assert len(pl) == r.n_tasks and ((pl >= 0) & (pl < A)).all()
            assert math.isfinite(r.summary["gvalue"])
        return eng, dt

    svc = QoSPlacementEngine(plat, params, QoSConfig(), device=dev).svc
    mean_service = power_of_two_bucket(base.num_tasks, 16) * svc

    def trace(slots, **kw):
        return generate(base, plat.n, LoadGenConfig(**kw),
                        mean_service / slots)

    poisson = trace(4, n_requests=QOS_REQUESTS, offered_load=2.0, seed=11)
    arms = {"drain": serve(poisson),
            "continuous": serve(poisson, continuous=True),
            "gamma": serve(trace(4, process="gamma", burstiness=4.0,
                                 n_requests=QOS_REQUESTS, offered_load=2.0,
                                 seed=12), continuous=True),
            "measured": serve(trace(4, n_requests=6, offered_load=1.0,
                                    seed=14), deadline=1e9,
                              measured_svc=True)}
    print(f"qos on {smi}: virtual svc {svc * 1e3:.4f} ms a slot, "
          f"{8 * svc * 1e3:.4f} ms a segment of 8 steps")
    for name, (eng, dt) in arms.items():
        print(f"qos {name}: " + serve_launch.qos_summary(eng, dt))
    eng, dt = arms["measured"]
    assert eng.stats()["completed"] == 6
    per = dt * 1e3 / eng.dispatches
    print(f"qos measured: {dt * 1e3:.4f} ms wall over {eng.dispatches} "
          f"dispatches = {per:.4f} ms a dispatch (a segment of 8 steps), "
          f"{per / 8:.4f} ms a step of {eng.cfg.slots} lanes")

    # sharded parity on the one-process mesh
    ptrace = trace(3, n_requests=12, offered_load=1.5, seed=13)
    for cont in (False, True):
        one, dt1 = serve(ptrace, slots=3, continuous=cont)
        shard, dt2 = serve(ptrace, slots=3, continuous=cont, mesh=mesh)
        assert digests_equal(serving_digest(one), serving_digest(shard)), \
            f"sharded QoS waves (continuous={cont}) left the unsharded ones"
        print(f"qos sharded ({'continuous' if cont else 'drain'}): the "
              f"mesh's serving digest equals the unsharded one ("
              f"{len(one.wave_log)} waves, {one.dispatches} dispatches; "
              f"{dt1:.3f}s / {dt2:.3f}s wall)")

    # the card against the CPU on the drain trace
    card = arms["drain"][0]
    cpu, _ = serve(poisson, device="cpu")
    want, got = serving_digest(cpu), serving_digest(card)
    place = {k for k in want if k.startswith("placements_")}
    assert set(got) == set(want)
    assert digests_equal({k: got[k] for k in set(got) - place},
                         {k: want[k] for k in set(want) - place})
    notes = []
    for k in sorted(place):
        if np.array_equal(got[k], want[k]):
            continue
        uid = int(k.split("_")[1])
        at, margin = qos_margin(torch, plat, params, backlog,
                                poisson[uid].tasks, got[k], want[k])
        assert margin < 1e-5, f"request {uid}: placement {at} differs " \
            f"on the card with a CPU Q margin of {margin}"
        notes.append(f"request {uid} parts at task {at} (margin "
                     f"{margin:.2e})")
    print(f"qos card vs cpu: the drain trace's digests equal ("
          f"{len(cpu.completed)} completed, {len(cpu.dead_letter)} shed)"
          + (f"; {', '.join(notes)}" if notes else ", placements too"))

    # the launcher
    t0 = time.perf_counter()
    assert serve_launch.main(QOS_LAUNCH + ["--device", dev]) == 0
    print(f"qos launcher: {' '.join(QOS_LAUNCH)} in "
          f"{time.perf_counter() - t0:.1f}s")
    dt = time.perf_counter() - t_phase
    print(f"qos phase {dt:.1f} s")
    return {name: {**eng.stats(), "wall_s": w}
            for name, (eng, w) in arms.items()}


# benchmarks/recovery.py's quick arms: 16 synthetic routes of two buckets
# (seeds 300-315) at HMAI n = 11, rate 0.05, offered load 1.2 (arrival
# seed 0); QoSConfig(policy "edf", slots 2, chunk 16, min_bucket 16);
# a snapshot every 64 segments; DUR_REPS reps a wall-time arm (2 until
# phase 18's serving leg joined the smoke's time)
RECOVERY_ROUTES = 16
SNAPSHOT_EVERY = 64
DUR_REPS = 1
# the durable launcher's crash and elastic runs (tests/test_durability.py)
# and the trainer's resume runs (tests/test_train.py)
DUR_SERVE = ["--placement", "--routes", "4", "--rate-scale", "0.005",
             "--seed", "0"]
DUR_TRAIN = ["--flexai", "--td-kernel", "--routes", "2", "--rate-scale",
             "0.005", "--eval-every", "2", "--seed", "0"]
# the trainer's runs: DUR_HALF episodes, then --resume for DUR_HALF more,
# against 2 * DUR_HALF at once (2 until phase 18 joined the smoke's time)
DUR_HALF = 1


def recovery_routes(torch, n, seed0=300):
    """``benchmarks/recovery.py``'s synthetic mixed-size routes (odd: 60-119
    tasks, even: 150-249), as the port's ``TaskArrays``."""
    import numpy as np

    from repro_torch.core.tasks import TaskArrays
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed0 + i)
        nt = int(rng.integers(60, 120)) if i % 2 else int(
            rng.integers(150, 250))
        out.append(TaskArrays(
            kind=torch.as_tensor(rng.integers(0, 3, nt), dtype=torch.int64),
            arrival=torch.as_tensor(np.sort(rng.uniform(
                0, 0.005 * nt, nt)).astype(np.float32)),
            safety=torch.full((nt,), 0.05),
            group=torch.zeros(nt, dtype=torch.int64),
            valid=torch.ones(nt, dtype=torch.bool)))
    return out


def durable_line(name, eng, wall_s):
    s = eng.stats()
    return (f"durability {name}: {s['completed']}/{s['submitted']} "
            f"completed, miss_rate {s['miss_rate']:.4f}, shed {s['shed']}, "
            f"snapshots {s['snapshots_written']}, snapshot_time_s "
            f"{s['snapshot_time_s']:.4f}, segments {s['segments_done']}, "
            f"faults {s['faults_fired']}, cores masked {s['cores_masked']}, "
            f"wall {wall_s:.3f} s, virtual {s['virtual_time_s']:.4f} s")


def run_procs(cmds, env, timeout=300):
    """Run launcher commands side by side; returns their stdouts (each
    must exit 0)."""
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for c, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"{' '.join(c)} failed:\n{out[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def phase_durability(torch, params, backlog, smi, dev="cuda"):
    """Main path 10: crash-recoverable QoS serving (``serve/durability.py``)
    on ``params``.  ``benchmarks/recovery.py``'s quick arms in process:
    wall time with snapshots off and on (``DUR_REPS`` reps each); a run
    cut after half
    the reference's waves with no boundary snapshot, restored from disk
    and finished (digest equal to the uninterrupted run's); the healthy
    run's busiest core failing x50 at half its virtual time, handled and
    unhandled (the handled miss rate strictly lower); the handled arm on
    the CPU port (digests equal, ``state_*`` entries included).  Then the
    launchers in subprocesses: a serving run SIGKILLed after its third
    cadence snapshot and resumed, a two-wave run resumed on a one-process
    NCCL mesh (both digests equal to an uninterrupted run's), and the
    trainer through the TD kernel, ``DUR_HALF`` episodes then
    ``--resume`` for as many more against both at once (weights
    bit-equal, best and env steps equal)."""
    import collections
    import re
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np

    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.serve.durability import (DurableQoSEngine,
                                              FaultInjection, digests_equal,
                                              serving_digest)
    from repro_torch.serve.policy import power_of_two_bucket
    from repro_torch.serve.qos import QoSConfig
    t_phase = time.perf_counter()
    plat = HMAIPlatform(capacity_scale=0.05)
    queues = recovery_routes(torch, RECOVERY_ROUTES)
    cfg = QoSConfig(policy="edf", slots=2, chunk=16, min_bucket=16)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durability_")

    def engine(device=dev, **kw):
        eng = DurableQoSEngine(plat, params, cfg, backlog_scale=backlog,
                               device=device, **kw)
        mean = float(np.mean([power_of_two_bucket(q.num_tasks, 16)
                              for q in queues])) * eng.base_svc
        rng = np.random.default_rng(0)
        t = 0.0
        for q in queues:
            eng.submit(q, arrival=t)
            t += float(mean / 1.2 * rng.uniform(0.5, 1.5))
        return eng

    def serve(eng):
        t0 = time.perf_counter()
        eng.run_until_done()
        if eng.saver is not None:
            eng.saver.wait()
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def best(reps, **kw):
        runs = [serve(engine(**kw)) for _ in range(reps)]
        return min(runs, key=lambda r: r[1])

    out = {}
    try:
        # overhead: snapshots off and on
        ref, t_off = best(DUR_REPS)
        snap, t_on = best(DUR_REPS, snapshot_dir=os.path.join(tmp, "ovh"),
                          snapshot_every=SNAPSHOT_EVERY)
        assert digests_equal(serving_digest(ref), serving_digest(snap)), \
            "snapshots changed the serving outcome"
        print(durable_line("snapshots off", ref, t_off))
        print(durable_line("snapshots on", snap, t_on)
              + f"; sync share {snap.snapshot_time_s / t_on:.4f} of the "
              f"wall time, wall ratio {t_on / t_off - 1.0:+.4f}")
        out["overhead"] = {"wall_s_off": t_off, "wall_s_on": t_on,
                           "snapshot_time_s": snap.snapshot_time_s,
                           "snapshots": snap.snapshots_written,
                           "segments": snap.segments_done}

        # recovery: cut after half the waves, restore from disk, finish
        crash_dir = os.path.join(tmp, "crash")
        crashed = engine(snapshot_dir=crash_dir,
                         snapshot_every=SNAPSHOT_EVERY)
        t0 = time.perf_counter()
        cut = crashed.serve_waves(max(len(ref.wave_log) // 2, 1))
        crashed.saver.wait()
        del crashed
        restored = DurableQoSEngine.restore(crash_dir, plat,
                                            backlog_scale=backlog,
                                            device=dev)
        at_restore = len(restored.wave_log)
        restored, t_rest = serve(restored)
        assert digests_equal(serving_digest(ref), serving_digest(restored)), \
            "the restored run left the uninterrupted one"
        print(durable_line("recovery", restored, time.perf_counter() - t0)
              + f"; cut after {cut} of {len(ref.wave_log)} waves, restored "
              f"at {at_restore} waves, digest equal to the uninterrupted "
              f"run's")
        out["recovery"] = {"cut_waves": cut, "waves": len(ref.wave_log),
                           "waves_at_restore": at_restore,
                           "wall_s": t_rest}

        # degradation: the busiest core fails at half the virtual time
        counts = collections.Counter()
        for r in ref.completed:
            counts.update(np.asarray(r.summary["placements"]).tolist())
        core = int(counts.most_common(1)[0][0])
        arms = {}
        for handled in (True, False):
            fault = [FaultInjection(at_time=0.5 * ref.now, core=core,
                                    factor=50.0, handled=handled)]
            arms[handled] = serve(engine(faults=fault))
            print(durable_line("fault " + ("handled" if handled else
                                           "unhandled"), *arms[handled])
                  + f"; core {core} x50 at {0.5 * ref.now:.4f} s")
        sh, su = (arms[h][0].stats() for h in (True, False))
        assert sh["faults_fired"] == su["faults_fired"] == 1
        assert sh["cores_masked"] == 1 and su["cores_masked"] == 0
        assert sh["miss_rate"] < su["miss_rate"], (sh["miss_rate"],
                                                   su["miss_rate"])
        out["degradation"] = {
            "core": core, "miss_rate_handled": sh["miss_rate"],
            "miss_rate_unhandled": su["miss_rate"],
            "shed_handled": sh["shed"], "shed_unhandled": su["shed"]}

        # the handled arm on the CPU port
        fault = [FaultInjection(at_time=0.5 * ref.now, core=core,
                                factor=50.0)]
        cpu, t_cpu = serve(engine(device="cpu", faults=fault))
        want, got = serving_digest(cpu), serving_digest(arms[True][0])
        place = {k for k in want if k.startswith("placements_")}
        assert set(got) == set(want)
        notes = []
        for k in sorted(place):
            if not np.array_equal(got[k], want[k]):
                uid = int(k.split("_")[1])
                at, margin = qos_margin(torch, plat, params, backlog,
                                        queues[uid], got[k], want[k])
                assert margin < 1e-5, f"request {uid}: placement {at} " \
                    f"differs on the card with a CPU Q margin of {margin}"
                notes.append(f"request {uid} parts at task {at} (margin "
                             f"{margin:.2e})")
        assert digests_equal({k: got[k] for k in set(got) - place},
                             {k: want[k] for k in set(want) - place}), \
            "the handled fault arm's digest differs on the card"
        n_state = sum(k.startswith("state_") for k in want)
        print(f"durability card vs cpu: the handled fault arm's digests "
              f"equal ({n_state} state entries; cpu wall {t_cpu:.2f} s)"
              + (f"; {', '.join(notes)}" if notes else ", placements too"))

        # the launchers in subprocesses
        here = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": os.path.join(here, "src")}
        serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                     *DUR_SERVE]
        train_cmd = [sys.executable, "-m", "repro_torch.launch.train",
                     *DUR_TRAIN]
        d = {k: os.path.join(tmp, k) for k in (
            "ref.npz", "kill", "resumed.npz", "waves", "elastic.npz",
            "full.npz", "train", "res.npz")}
        t0 = time.perf_counter()
        kill = subprocess.Popen(
            serve_cmd + ["--qos", "edf", "--snapshot-dir", d["kill"],
                         "--snapshot-every", "4", "--segment-sleep", "0.02",
                         "--trace"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = []

        def killer():
            """SIGKILL the server at its third snapshot line."""
            for line in kill.stdout:
                lines.append(line)
                if sum(ln.startswith("SNAPSHOT") for ln in lines) == 3:
                    kill.send_signal(signal.SIGKILL)
                    break
        reader = threading.Thread(target=killer)
        reader.start()
        try:
            outs = run_procs([
                serve_cmd + ["--qos", "edf", "--state-out", d["ref.npz"]],
                serve_cmd + ["--qos", "edf", "--snapshot-dir", d["waves"],
                             "--serve-waves", "2"],
                train_cmd + ["--episodes", str(2 * DUR_HALF), "--weights",
                             d["full.npz"]],
                train_cmd + ["--episodes", str(DUR_HALF), "--snapshot-dir",
                             d["train"]]], env)
            kill.wait(timeout=300)
        finally:
            if kill.poll() is None:
                kill.kill()
                kill.wait()
            reader.join()
            kill.stdout.close()
        assert kill.returncode == -signal.SIGKILL, \
            "the server ended before its third snapshot:\n" + "".join(
                lines[-40:])
        segs = sum(ln.startswith("SEG ") for ln in lines)
        outs += run_procs([
            serve_cmd + ["--resume", "--snapshot-dir", d["kill"],
                         "--state-out", d["resumed.npz"]],
            serve_cmd + ["--resume", "--shard", "--snapshot-dir", d["waves"],
                         "--state-out", d["elastic.npz"]],
            train_cmd + ["--episodes", str(DUR_HALF), "--snapshot-dir",
                         d["train"], "--resume", "--weights", d["res.npz"]]],
            env)
        t_sub = time.perf_counter() - t0

        def digest(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}

        def summary(text):
            return [ln for ln in text.splitlines()
                    if ln.startswith(("qos[", "durability:"))]
        ref_npz = digest(d["ref.npz"])
        assert any(k.startswith("state_") for k in ref_npz)
        assert "resumed snapshot" in outs[4] and "partial run" in outs[1]
        assert "placement mesh: 1 process(es)" in outs[5]
        assert digests_equal(ref_npz, digest(d["resumed.npz"])), \
            "the SIGKILLed server's resumed digest differs"
        assert digests_equal(ref_npz, digest(d["elastic.npz"])), \
            "the elastic resume's digest differs"
        print(f"durability sigkill: killed after its third snapshot ("
              f"{segs} segments served), resumed: digest equal to the "
              f"uninterrupted run's; " + " | ".join(summary(outs[4])))
        print(f"durability elastic: 2 waves on one device, resumed on a "
              f"one-process NCCL mesh: digest equal; "
              + " | ".join(summary(outs[5])))

        pat = (r"trained (\d+) env steps in (\S+)s .*?, (\d+) TD updates, "
               r"(\d+) TD kernel launches, best_eval_stm=(\S+)")
        runs = {}
        for name, text in (("whole", outs[2]), ("half", outs[3]),
                           ("resumed", outs[6])):
            m = re.search(pat, text)
            assert m, text[-2000:]
            runs[name] = m.groups()
            print(f"durability trainer {name}: {m.group(1)} env steps, "
                  f"{m.group(3)} TD updates in all, {m.group(4)} TD kernel "
                  f"launches in this run, best_eval_stm {m.group(5)}, wall "
                  f"{m.group(2)} s")
        upd = {k: int(v[2]) for k, v in runs.items()}
        launches = {k: int(v[3]) for k, v in runs.items()}
        # every TD update of a run is one launch; the resumed run's
        # counter goes on from the snapshot's
        assert launches == {"whole": upd["whole"], "half": upd["half"],
                            "resumed": upd["resumed"] - upd["half"]}, \
            (launches, upd)
        assert upd["resumed"] == upd["whole"] > upd["half"] > 0
        assert f"resumed trainer snapshot at episode {DUR_HALF}" in outs[6]
        full, res = runs["whole"], runs["resumed"]
        assert (res[0], res[4]) == (full[0], full[4]), (full, res)
        with np.load(d["full.npz"]) as a, np.load(d["res.npz"]) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(np.array_equal(a[k], b[k]) for k in a.files), \
                "the resumed trainer's weights differ"
        print(f"durability trainer: {DUR_HALF} + {DUR_HALF} episodes through "
              f"the TD kernel equal {2 * DUR_HALF} (weights bit-equal, env "
              f"steps {full[0]}, "
              f"best_eval_stm {full[4]}); subprocess arms {t_sub:.1f} s")
        out["subprocess_s"] = t_sub
        out["trainer"] = {k: {"env_steps": int(v[0]),
                              "td_updates": int(v[2]),
                              "td_launches": int(v[3])}
                          for k, v in runs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = time.perf_counter() - t_phase
    print(f"durability phase {dt:.1f} s on {smi}")
    out["seconds"] = dt
    return out


# benchmarks/pipeline.py's configuration: UB routes of seeds 700 and 701
# (route_km 0.04, HMAI n = 11 at rate 0.05), their first 768 tasks drained
# (arrivals 0, deadlines waived); the trainers' lanes add seeds 702 and 703
STAGE_ROUTE = dict(route_km=0.04, rate_scale=0.05)
STAGE_TASKS = 768
# the single-lane episode's route prefix (1,536 until phase 18 joined
# the smoke's time)
STAGE_SINGLE_TASKS = 768
STAGE_LANE_TASKS = 384    # a population / DP lane's route prefix
STAGE_CHECK_TASKS = 150   # the trainers' prefix held to the CPU: 302 flat
                          # steps at S = 2
# the JAX package's EFT makespans on the CPU for that configuration
# (repro.core.pipeline.make_pipeline_schedule_fn(policy="eft"), seed 700,
# 701); the simulated clock must give the same floats on the card
JAX_MAKESPAN_S = {1: (8.167756080627441, 8.178314208984375),
                  2: (7.230294227600098, 7.233038425445557)}
STAGE_LAUNCH = ["--placement", "--qos", "edf", "--stages", "2", "--routes",
                "4", "--rate-scale", "0.005", "--arrival-gap", "0.02"]


def _host(x):
    """``x`` (a tensor, or tuples of them) on the host."""
    if isinstance(x, tuple):
        parts = [_host(f) for f in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x.cpu()


def stage_margin(torch, plan, spec, params, rows, s_seq, got, want, lane):
    """The CPU's Q margin between its stage placement ``want`` and the
    card's ``got`` (flat [L]) at their first difference on flat ``rows``
    [L] of route ``lane``."""
    import numpy as np

    from repro_torch.core import pipeline
    from repro_torch.core.flexai import dqn
    from repro_torch.core.platform import kind_feature_table
    from repro_torch.core.tasks import TaskArrays
    i = int(np.nonzero(got != want)[0][0])
    one = TaskArrays(*[f[lane:lane + 1] for f in rows])
    state, ring, _ = pipeline._pipeline_segment_run(spec, plan)(
        params, TaskArrays(*[f[:, :i] for f in one]), s_seq[:i]) \
        if i else (None, None, None)
    if state is None:
        state = pipeline.platform_init(spec.n)
        ring = torch.zeros(1, plan.n_stages)
    s = int(s_seq[i])
    row = one.step(i)
    trow = pipeline._stage_task_view(plan, ring, row, s)
    sv = pipeline.stage_state_vector(
        spec, torch.as_tensor(kind_feature_table()), 1.0, state, trow,
        stage_exec=plan.stage_exec[s], mac_frac=plan.mac_frac[s][row.kind],
        group_mask=plan.group_mask[s], stage_frac=torch.tensor(float(s)))
    q = dqn.qnet_apply(params, sv)[0]
    return i, float(q[want[i]] - q[got[i]])


def phase_stages(torch, card, td_ms, dev="cuda"):
    """Main path 11: the stage pipeline (``core/pipeline.py``).  The stage
    plan at S = 2 and 3; EFT over ``benchmarks/pipeline.py``'s two drained
    768-task routes at S = 1 and 2, the flat wavefront against the
    task-major reference on the card (bit-equal) and the makespans
    against the JAX package's; stage-FlexAI training through the TD
    kernel at D = 70: one single-lane episode on the seed-700 route (its
    first ``STAGE_SINGLE_TASKS`` tasks, with deadlines), one population
    and one DP episode of 4 lanes (seeds 700-703, cut to their first
    ``STAGE_LANE_TASKS`` tasks), launches = updates, and each trainer's
    first
    ``STAGE_CHECK_TASKS`` tasks held to the CPU with the same draws;
    greedy stage placements of the trained net on both routes (first 768
    tasks, with deadlines), card against CPU; QoS pipeline waves
    (``benchmarks/serve_load.py``'s quick drain arm at ``stages=2``)
    card against CPU, preemption on and off; the QoS launcher with
    ``--stages 2``.  ``td_ms`` is the kernel's time at D = 70, B 64.
    Returns the phase's numbers and what phase 10i holds its mesh paths
    to: the inputs and outputs of the flat engine runs and the
    population and DP trainers."""
    import numpy as np

    from repro_torch.core import pipeline
    from repro_torch.core.environment import (Area, EnvironmentParams,
                                              build_task_queue)
    from repro_torch.core.flexai import FlexAIConfig
    from repro_torch.core.flexai import dqn
    from repro_torch.core.flexai.engine import (dp_train_init,
                                                train_init)
    from repro_torch.core.hmai import HMAIPlatform
    from repro_torch.core.platform import spec_from_platform
    from repro_torch.core.tasks import (TaskArrays, stack_task_arrays,
                                        tasks_to_arrays)
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    from repro_torch.kernels.protocol import synchronize
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serve.durability import digests_equal, serving_digest
    from repro_torch.serve.loadgen import LoadGenConfig, generate
    from repro_torch.serve.policy import power_of_two_bucket
    from repro_torch.serve.qos import QoSConfig, QoSPlacementEngine
    t_phase = time.perf_counter()
    out = {}
    plat = HMAIPlatform(capacity_scale=STAGE_ROUTE["rate_scale"])
    names = [sp.name for sp in plat.specs]
    for S in (2, 3):
        groups = pipeline.build_stage_plan(plat, S).groups.tolist()
        print(f"stages: S={S} groups " + "; ".join(
            f"stage {g}: " + ", ".join(f"{i}:{names[i]}" for i in range(
                len(groups)) if groups[i] == g) for g in range(S)))
    queues = [build_task_queue(EnvironmentParams(
        area=Area.UB, seed=700 + i, **STAGE_ROUTE)) for i in range(4)]
    spec = {d: spec_from_platform(plat, d) for d in ("cpu", dev)}
    plans = {(S, d): pipeline.build_stage_plan(plat, S, device=d)
             for S in (1, 2) for d in ("cpu", dev)}

    # makespan: EFT, drained routes, flat against the reference
    def drained(q):
        ta = tasks_to_arrays(q[:STAGE_TASKS])
        return ta._replace(arrival=torch.zeros_like(ta.arrival),
                           safety=torch.full_like(ta.safety, 1e9))
    batch = stack_task_arrays([drained(q) for q in queues[:2]]).to(dev)
    makespan = {}
    oracle = {"plat": plat, "drained": batch.to("cpu")}
    for S in (1, 2):
        args = (spec[dev], plans[S, dev], 1.0, "eft", True)
        t0 = time.perf_counter()
        flat = pipeline.make_pipeline_schedule_fn(*args)(None, batch)
        torch.cuda.synchronize()
        t_flat = time.perf_counter() - t0
        ref = pipeline.make_pipeline_reference_fn(*args)(None, batch)
        assert all(torch.equal(a, b) for a, b in zip(
            (*flat[0], flat[1], *flat[2]), (*ref[0], ref[1], *ref[2]))), \
            f"S={S}: the flat wavefront left the task-major reference"
        ms = tuple(pipeline.pipeline_summarize(
            spec[dev], type(flat[0])(*[f[i] for f in flat[0]]),
            type(flat[2])(*[f[i] for f in flat[2]]))["makespan_s"]
            for i in range(2))
        assert ms == JAX_MAKESPAN_S[S], (S, ms, JAX_MAKESPAN_S[S])
        makespan[S] = float(np.mean(ms))
        if S == 2:
            oracle["eft"] = _host(flat)
        print(f"stages makespan S={S}: {ms[0]!r} / {ms[1]!r} s (mean "
              f"{makespan[S]:.4f} s) equal the JAX package's on the CPU; "
              f"flat = reference bit for bit on the card; the flat run "
              f"{t_flat:.2f} s for 2 x {STAGE_TASKS} tasks")
    out["makespan_s"] = makespan
    out["makespan_gain"] = makespan[1] / makespan[2]
    print(f"stages makespan gain S=2 over S=1: {out['makespan_gain']:.4f} "
          f"(BENCH_pipeline.json records 8.173 / 7.2317 s, 1.1302)")

    # stage-FlexAI training through the TD kernel at D = 70
    cfg = FlexAIConfig(seed=0)
    plan = plans[2, dev]
    groups = plan.groups.cpu().numpy()
    trainers = {}
    for mode, lanes, routes in (
            ("single", 1,
             [tasks_to_arrays(queues[0][:STAGE_SINGLE_TASKS])]),
            ("population", 4, [tasks_to_arrays(q[:STAGE_LANE_TASKS])
                               for q in queues]),
            ("dp", 4, [tasks_to_arrays(q[:STAGE_LANE_TASKS])
                       for q in queues])):
        pipe = pipeline.PipelineFlexAI(plat, cfg, n_stages=2, lanes=lanes,
                                       dp=mode == "dp", td_kernel=True,
                                       device=dev)
        p0 = dqn.DQNParams(*[w.cpu().clone() for w in pipe.ts.eval_p])
        td_kernel.launches = 0
        t0 = time.perf_counter()
        h = pipe.train_episode(routes[0] if mode == "single" else routes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = td_kernel.launches
        ts = pipe.ts
        # one launch a flat step with an update (any lane's, for a
        # population), and so one an update for one agent
        assert launches == h["update_steps"] > 0, (mode, launches, h)
        assert mode == "population" or launches == ts.updates
        assert all(math.isfinite(x) for x in pipe.losses)
        flat_steps = (routes[0].num_tasks + 1) * 2
        stm = ([h["stm_rate"]] if mode == "single"
               else [x["stm_rate"] for x in h["lanes"]])
        print(f"stages train {mode}: {lanes} lane(s) x {flat_steps} flat "
              f"steps in {dt:.2f}s ({lanes * flat_steps / dt:.1f} lane-"
              f"steps/s), TD updates {ts.updates}, {launches} TD-kernel "
              f"launches (D={D_STAGE}: "
              f"{launches * td_ms:.1f} ms of device time = launches x "
              f"{td_ms:.4f} ms); stm " + ", ".join(f"{x:.4f}" for x in stm))

        # the first STAGE_CHECK_TASKS tasks on the card and the CPU, the
        # same initial weights and draws
        k = STAGE_CHECK_TASKS
        cut = stack_task_arrays([TaskArrays(*[f[:k] for f in r])
                                 for r in routes])
        valid = pipeline._wavefront_stream(cut, 2)[0].valid.numpy()
        _, s_seq = pipeline._wavefront_index(k, 2)
        sizes = np.minimum(np.cumsum(valid, axis=1), cfg.replay_capacity)
        draws = pipeline._stage_draws(torch.Generator().manual_seed(5),
                                      sizes, s_seq, groups, cfg.batch_size,
                                      "cpu")

        def run(d):
            sp, pl = spec[d], plans[2, d]
            if mode == "dp":
                ts0 = dp_train_init(D_STAGE, A, cfg.replay_capacity, lanes,
                                    device=d)
                fn = pipeline.make_pipeline_dp_train_fn(sp, pl, cfg, lanes,
                                                        td_kernel=True)
            else:
                ts0 = train_init(D_STAGE, A, cfg.replay_capacity, device=d,
                                 lanes=None if lanes == 1 else lanes)
                fn = pipeline.make_pipeline_train_fn(
                    sp, pl, cfg, batched=lanes > 1, td_kernel=True)
            p = dqn.DQNParams(*[w.to(d) for w in p0])
            ts0 = ts0._replace(eval_p=p, targ_p=p, opt=dqn.adam_init(p))
            if mode == "single":
                return fn(ts0, TaskArrays(*[f[0] for f in cut]),
                          pipeline.Draws(*[x[0] for x in draws]))
            return fn(ts0, cut, draws)

        got, want = run(dev), run("cpu")
        assert torch.equal(got[2].action.cpu(), want[2].action), \
            f"stages train {mode}: placements differ from the CPU's"
        assert torch.equal(got[4], want[4]) and int(want[4].sum()) > 0
        close(got[3], want[3], 1e-4, 1e-7, f"stages {mode} losses")
        for i, (g, c) in enumerate(zip(got[0].eval_p, want[0].eval_p)):
            close(g, c, 0, 1e-4, f"stages {mode} param p{i}")
        print(f"  the first {k} tasks ({valid.shape[1]} flat steps x "
              f"{lanes} lane(s), {int(want[4].sum())} updates) on "
              f"{dev} match the CPU with the same draws (actions and "
              f"update mask equal, params atol 1e-4)")
        trainers[mode] = {"launches": launches, "seconds": dt,
                          "updates": np.asarray(ts.updates).tolist(),
                          "flat_steps": flat_steps, "stm": stm}
        oracle[mode] = {"routes": routes, "cfg": cfg, "ts": ts,
                        "summary": h, "losses": list(pipe.losses)}
        if mode == "single":
            params = pipe.eval_params()
    out["train"] = trainers

    # greedy stage placements of the trained net: card against CPU
    live = stack_task_arrays([tasks_to_arrays(q[:STAGE_TASKS])
                              for q in queues[:2]])
    res = {d: pipeline.make_pipeline_schedule_fn(
        spec[d], plans[2, d], 1.0, "flexai", True)(
        dqn.DQNParams(*[w.to(d) for w in params]), live.to(d))
        for d in ("cpu", dev)}
    rows, s_seq = pipeline._wavefront_stream(live, 2)
    order = pipeline._record_order(STAGE_TASKS, 2).reshape(-1)
    notes = []
    for lane in range(2):
        got = res[dev][2].action[lane].cpu().numpy().reshape(-1)
        want = res["cpu"][2].action[lane].numpy().reshape(-1)
        if np.array_equal(got, want):
            continue
        # the flat stream's two invalid corners stay 0 in both
        flat_g = np.zeros(rows.arrival.shape[1], np.int64)
        flat_w = np.zeros_like(flat_g)
        flat_g[order], flat_w[order] = got, want
        at, margin = stage_margin(
            torch, plans[2, "cpu"], spec["cpu"],
            dqn.DQNParams(*[w.cpu() for w in params]), rows, s_seq,
            flat_g, flat_w, lane)
        assert margin < 1e-5, f"route {lane}: flat step {at} differs on " \
            f"the card with a CPU Q margin of {margin}"
        notes.append(f"route {lane} parts at flat step {at} (margin "
                     f"{margin:.2e})")
    stm = [pipeline.pipeline_summarize(
        spec[dev], type(res[dev][0])(*[f[i] for f in res[dev][0]]),
        type(res[dev][2])(*[f[i] for f in res[dev][2]]))["stm_rate"]
        for i in range(2)]
    print(f"stages greedy: the trained stage net on both routes' first "
          f"{STAGE_TASKS} tasks (with deadlines), card vs CPU: "
          + ("; ".join(notes) if notes else "placements equal")
          + "; stm " + ", ".join(f"{x:.4f}" for x in stm))
    out["greedy_stm"] = stm
    oracle.update(live=live, params=dqn.DQNParams(
        *[w.cpu() for w in params]), flexai=_host(res[dev]))

    # QoS pipeline waves: the quick drain arm at stages=2, card vs CPU
    base = tasks_to_arrays(build_task_queue(EnvironmentParams(**QOS_BASE)))
    qplat = HMAIPlatform(capacity_scale=QOS_BASE["rate_scale"])

    def serve(reqs, device=dev, **kw):
        eng = QoSPlacementEngine(
            qplat, params, QoSConfig(**{**dict(
                policy="edf", slots=4, chunk=8, min_bucket=16, stages=2),
                **kw}), device=device)
        for r in reqs:
            eng.submit(*r)
        t0 = time.perf_counter()
        eng.run_until_done()
        synchronize(eng.device)
        s = eng.stats()
        assert s["completed"] + s["shed"] == s["submitted"] == len(reqs)
        for r in eng.completed:
            pl = np.asarray(r.summary["placements"])
            assert pl.shape == (r.n_tasks, 2) and (
                groups[pl] == np.arange(2)).all()
        return eng, time.perf_counter() - t0

    svc = QoSPlacementEngine(qplat, params, QoSConfig(), device=dev).svc
    trace = generate(base, qplat.n, LoadGenConfig(
        n_requests=QOS_REQUESTS, offered_load=2.0, seed=11),
        power_of_two_bucket(base.num_tasks, 16) * svc / 4)
    reqs = [(r.tasks, r.arrival) for r in trace]
    on_card, dt = serve(reqs)
    cpu, _ = serve(reqs, device="cpu")
    want, got = serving_digest(cpu), serving_digest(on_card)
    place = {k for k in want if k.startswith("placements_")}
    assert set(got) == set(want)
    assert digests_equal({k: got[k] for k in set(got) - place},
                         {k: want[k] for k in set(want) - place})
    parted = sorted(k for k in place if not np.array_equal(got[k], want[k]))
    for k in parted:
        req = next(r for r in cpu.completed
                   if r.uid == int(k.split("_")[1]))
        one = TaskArrays(*[f[None] for f in trace[req.uid].tasks])
        frows, fs = pipeline._wavefront_stream(one, 2)
        order = pipeline._record_order(req.n_tasks, 2).reshape(-1)
        fg = np.zeros(frows.arrival.shape[1], np.int64)
        fw = np.zeros_like(fg)
        fg[order], fw[order] = got[k].reshape(-1), want[k].reshape(-1)
        at, margin = stage_margin(
            torch, plans[2, "cpu"], spec["cpu"],
            dqn.DQNParams(*[w.cpu() for w in params]), frows, fs, fg, fw, 0)
        assert margin < 1e-5, f"{k}: flat step {at}, CPU Q margin {margin}"
    print("stages qos drain: " + serve_launch.qos_summary(on_card, dt))
    print(f"  card vs CPU: serving digests equal ({len(cpu.completed)} "
          f"completed, {len(cpu.dead_letter)} shed, {cpu.dispatches} "
          f"dispatches of 8 flat steps)" + (
              f", {len(parted)} placement(s) part at a CPU Q tie"
              if parted else ", placements too"))
    out["qos"] = {**on_card.stats(), "wall_s": dt}

    # preemption at flat segment cuts leaves placements unchanged
    pre = [(base, 0.0, 1e6), (trace[1].tasks, 1e-4, 0.05),
           (trace[2].tasks, 2e-4, 0.06)]
    on, _ = serve(pre, slots=1, laxity_s=1e-4, shed=False)
    off, _ = serve(pre, slots=1, laxity_s=1e-4, shed=False, preempt=False)
    assert on.preemption_count > 0 == off.preemption_count
    by_uid = {r.uid: r.summary["placements"] for r in off.completed}
    assert len(on.completed) == 3 and all(
        np.array_equal(r.summary["placements"], by_uid[r.uid])
        for r in on.completed)
    print(f"stages qos preemption: {on.preemption_count} preemption(s) at "
          f"flat segment cuts, placements equal to the run without")

    # the launcher
    t0 = time.perf_counter()
    assert serve_launch.main(STAGE_LAUNCH + ["--device", dev]) == 0
    print(f"stages launcher: {' '.join(STAGE_LAUNCH)} in "
          f"{time.perf_counter() - t0:.1f}s")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"stages phase {out['seconds']:.1f} s on {card}")
    return out, oracle


STAGE_MESH_TIMEOUT_S = 300


def stage_mesh_worker(rank, port, work_dir, src, dev):
    """One rank of phase 10i's (2, 1) stage mesh: gloo between the
    processes, the engine on ``dev``; writes what it computed."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.core import pipeline
    from repro_torch.core.flexai import dqn
    from repro_torch.core.platform import spec_from_platform
    from repro_torch.launch.mesh import make_platform_mesh
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        inp = torch.load(os.path.join(work_dir, "inputs.pt"),
                         weights_only=False)
        spec = spec_from_platform(inp["plat"], dev)
        plan = pipeline.build_stage_plan(inp["plat"], 2, device=dev)
        # NCCL takes one rank a card: two ranks on one card share gloo
        mesh = make_platform_mesh(2, "cpu")
        out = {}
        for policy, params, tasks in (
                ("eft", None, inp["drained"]),
                ("flexai", dqn.DQNParams(*[w.to(dev) for w in inp["params"]]),
                 inp["live"])):
            fn = pipeline.make_sharded_pipeline_fn(spec, plan, mesh,
                                                   policy=policy)
            dist.barrier()
            t0 = time.perf_counter()
            got = fn(params, tasks)
            if dev == "cuda":
                torch.cuda.synchronize()
            out[policy] = {"result": _host(got), "stats": dict(fn.stats),
                           "seconds": time.perf_counter() - t0}
        torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_stage_mesh(torch, oracle, stage_ms, card, dev="cuda"):
    """Main path 12: the stage pipeline's mesh half (``core/pipeline.py``
    ``make_sharded_pipeline_fn``, ``combine_stage_states``, the sharded
    stage trainers).  (a) two spawned processes, each a stage of a gloo
    (2, 1) mesh computing on ``dev``: the stage-sharded wavefront against
    10h's flat engine (``eft`` on the drained routes, ``flexai`` with the
    trained stage net on the greedy routes), bit for bit, and the EFT
    makespans against the JAX package's; (b) a one-process NCCL mesh
    made here and torn down here: ``PipelineFlexAI(mesh=)`` population
    (equal to 10h's) and DP (within 1e-3 of 10h's), each with its TD
    launches counted from 0 and equal to its updates.  ``stage_ms`` is
    phase 3's D = 70 timing (the lane launches' device ms)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch import distributed as pdist
    from repro_torch.core import pipeline
    from repro_torch.core.platform import StepRecord
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    t_phase = time.perf_counter()
    out = {}

    # (a) the stage mesh: two processes, one a stage group
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    with tempfile.TemporaryDirectory() as work_dir:
        torch.save({k: oracle[k] for k in ("plat", "drained", "live",
                                           "params")},
                   os.path.join(work_dir, "inputs.pt"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(stage_mesh_worker, args=(
            pdist._free_port(), work_dir, src, dev), nprocs=2, join=False,
            start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                assert time.perf_counter() - t0 < STAGE_MESH_TIMEOUT_S, \
                    "the stage mesh's processes did not finish"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        job_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    plan = pipeline.build_stage_plan(oracle["plat"], 2)
    spec = pipeline.spec_from_platform(oracle["plat"])
    mesh_out = {"job_seconds": job_s}
    for policy in ("eft", "flexai"):
        final, ring, recs = oracle[policy]                  # [R, T, S]
        t_len = recs.action.shape[1]
        for r, res in enumerate(ranks):
            states, s_ring, s_recs = res[policy]["result"]  # [S, R, ...]
            assert all(torch.equal(a, b.permute(2, 0, 1))
                       for a, b in zip(s_recs, recs)), \
                f"{policy}: rank {r}'s stage-sharded records left the flat"
            assert torch.equal(s_ring.T, ring), policy
            combined = pipeline.combine_stage_states(plan, states)
            assert all(torch.equal(a, b) for a, b in zip(combined, final)), \
                f"{policy}: combine_stage_states left the flat final state"
            st = res[policy]["stats"]
            # one hop after each column but the last; stage 0 copies its
            # row to the host (send), stage 1 the received row back
            assert st == {"columns": t_len + 1, "hops": t_len,
                          "host_copies": t_len * (dev == "cuda")}, st
        if policy == "eft":
            ms = tuple(pipeline.pipeline_summarize(
                spec, type(combined)(*[f[i] for f in combined]),
                StepRecord(*[f[:, i].T for f in s_recs]))["makespan_s"]
                for i in range(2))
            assert ms == JAX_MAKESPAN_S[2], (ms, JAX_MAKESPAN_S[2])
        mesh_out[policy] = {
            "columns": t_len + 1,
            "seconds": [x[policy]["seconds"] for x in ranks],
            "hops": [x[policy]["stats"]["hops"] for x in ranks],
            "host_copies": [x[policy]["stats"]["host_copies"]
                            for x in ranks]}
        print(f"stage mesh {policy}: 2 ranks on a gloo (2, 1) mesh, 2 routes "
              f"x {t_len} tasks, {t_len + 1} columns a rank, "
              f"{mesh_out[policy]['hops'][0]} ring hops, host copies "
              f"{mesh_out[policy]['host_copies']} (stage 0 out, stage 1 in),"
              f" {max(mesh_out[policy]['seconds']):.2f} s; records, rings "
              f"and combined state = the flat engine's on {dev}"
              + (f"; makespans {ms[0]!r} / {ms[1]!r} s = JAX's"
                 if policy == "eft" else ""))
    out["mesh"] = mesh_out

    # (b) the stage trainers on a one-process NCCL mesh
    mesh = pdist.make_mesh(dev)
    try:
        for mode in ("population", "dp"):
            want = oracle[mode]
            pipe = pipeline.PipelineFlexAI(
                oracle["plat"], want["cfg"], n_stages=2, lanes=4, mesh=mesh,
                dp=mode == "dp", td_kernel=True, device=dev)
            td_kernel.launches = 0
            t0 = time.perf_counter()
            h = pipe.train_episode(want["routes"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = td_kernel.launches
            ts, ref = pipe.ts, want["ts"]
            assert launches == h["update_steps"] \
                == want["summary"]["update_steps"] > 0, (mode, launches)
            assert mode == "population" or launches == ts.updates
            err = max(float((a - b).abs().max()) for a, b in zip(
                (*ts.eval_p, *ts.targ_p), (*ref.eval_p, *ref.targ_p)))
            if mode == "population":
                assert err == 0.0 and pipe.losses == want["losses"]
                assert all(torch.equal(a, b) for a, b in zip(
                    ts.replay[:5], ref.replay[:5]))
                assert np.array_equal(ts.updates, ref.updates)
            else:
                assert err < 1e-3 and ts.updates == ref.updates, err
            out[mode] = {"launches": launches, "seconds": dt,
                         "updates": np.asarray(ts.updates).tolist(),
                         "param_err": err}
            td_ms = stage_ms["update_lanes" if mode == "population"
                             else "grads_lanes"]
            print(f"stage mesh train {mode}: 4 lanes on a one-process "
                  f"{dist.get_backend()} mesh in {dt:.2f}s, {launches} "
                  f"TD-kernel launches = "
                  f"updates ({launches * td_ms:.1f} ms of device time = "
                  f"launches x {td_ms:.4f} ms); "
                  + ("nets, rings, losses and counters = 10h's unsharded "
                     "run" if mode == "population" else
                     f"params within {err:.2e} of 10h's DP run"))
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"stage mesh phase {out['seconds']:.1f} s: columns "
          f"{mesh_out['eft']['columns']} / {mesh_out['flexai']['columns']}, "
          f"hops {mesh_out['eft']['hops'][0]} / "
          f"{mesh_out['flexai']['hops'][0]}, host copies a rank "
          f"{mesh_out['eft']['host_copies']} / "
          f"{mesh_out['flexai']['host_copies']}, TD launches "
          f"{out['population']['launches']} (population) / "
          f"{out['dp']['launches']} (DP), the 2-process job "
          f"{job_s:.1f} s, on {card}")
    return out


# main path 16 (phase 19): the examples' twins (examples/*_torch.py), each
# at its JAX example's settings, uncut.  The quickstart runs in a spawned
# process of its own from phase 8 on (its FlexAI part, 30,846 loop steps,
# is host work) and is held here; the driving pipeline runs here.  The
# quickstart's LM losses are held to the CPU's run of the same function
# at every step: in fp32 compute within QS_FP32_RTOL, in the example's
# bf16 within twice the CPU's own bf16 distance from its fp32 run
# (tests/test_torch_examples.py's rule: the two sides round bf16 at
# other places); its FlexAI trainer's first QS_ACTIONS actions are held
# to a CPU agent's from the same weights, each difference at a Q margin
# below QS_MARGIN on the card (tests/test_torch_engine.py's rule)
QS_FP32_RTOL = 1e-4
QS_ACTIONS = 300
QS_MARGIN = 1e-5
QS_TIMEOUT_S = 600
# convolutions a frame of each net (phase 11) and the calibration's calls:
# two platforms (the real pools and the trainer's simulated copy), each
# pool a warm call and three timed ones of each net
PER_FRAME = {"yolo": 55, "ssd": 58, "goturn": 10}
CALIBRATION_CALLS = 2 * 4


def record_actions(agent_cls, n):
    """Wrap ``agent_cls.act``: an agent's first ``n`` training actions,
    each with the Q values of its state, on ``agent.trace``."""
    act = agent_cls.act

    def recorded(self, state, explore):
        a = act(self, state, explore)
        trace = self.__dict__.setdefault("trace", [])
        if explore and len(trace) < n:
            trace.append((a, self.learner.q_values(state[None])[0]
                          .cpu().numpy()))
        return a
    agent_cls.act = recorded


def first_difference(card, cpu, margin):
    """Index of the first action where the traces ``card`` and ``cpu``
    part (None if none); there the card's Q values must rank the CPU's
    action within ``margin`` of its own."""
    for k, ((a, q), (b, _)) in enumerate(zip(card, cpu)):
        if a != b:
            gap = float(q[a] - q[b])
            assert gap < margin, (
                f"training action {k}: card {a}, CPU {b}, card Q margin "
                f"{gap} (not a tie)")
            return k, gap
    return None, None


def quickstart_run(torch, dev="cuda"):
    """examples/quickstart_torch.py on ``dev`` at its settings, held to
    the same functions on the CPU: the LM's losses (fp32 and the
    example's bf16 compute), its 8 greedy tokens, flash launches = 2 x
    waves of the served prefill and no other kernel, each of those
    launches held to the plain version on its own inputs at
    ``KERNEL_TOL``; FlexAI's first
    ``QS_ACTIONS`` training actions against a CPU agent's from the same
    weights, STM and R_Balance in [0, 1].  Returns what it measured."""
    import dataclasses

    import numpy as np

    from repro_torch.core.flexai import FlexAIAgent
    from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    import quickstart_torch as qs
    record_actions(FlexAIAgent, QS_ACTIONS)
    quiet = lambda *_: None  # noqa: E731

    def log(m):
        print(f"  quickstart_torch: {m}", flush=True)

    def counts():
        return {"dqn_td": td_kernel.launches,
                "flash_attention": flash_kernel.launches,
                "ssd_scan": ssd_kernel.launches, **conv_kernel.launches}

    def reset():
        td_kernel.launches = flash_kernel.launches = ssd_kernel.launches = 0
        for k in conv_kernel.launches:
            conv_kernel.launches[k] = 0

    reset()
    out, t0 = {}, time.perf_counter()
    # 1. + 2., on the card at the example's settings
    state, losses = qs.train_lm(dev, log=log)
    # the served prefill's flash launches, each with its inputs and output
    seen, launch = [], flash_kernel.flash_attention_cuda

    def recorded(q, k, v, *, causal):
        o = launch(q, k, v, causal=causal)
        seen.append((q.clone(), k.clone(), v.clone(), causal, o.clone()))
        return o
    flash_kernel.flash_attention_cuda = recorded
    try:
        tokens, eng = qs.serve(state.params, dev)
    finally:
        flash_kernel.flash_attention_cuda = launch
    torch.cuda.synchronize()
    out["lm_s"] = time.perf_counter() - t0
    n = counts()
    waves = len(eng.wave_log)
    want = dict.fromkeys(n, 0)
    want["flash_attention"] = 2 * waves
    assert n == want, f"launches {n}, expected {want}"
    assert len(seen) == n["flash_attention"]
    flash_err = 0.0
    for q, k, v, causal, o in seen:
        shape = (*q.shape[:3], k.shape[2], q.shape[3], causal)
        flash_err = max(flash_err, close(
            o, flash_attention_ref(q, k, v, causal=causal),
            *KERNEL_TOL[str(q.dtype).removeprefix("torch.")],
            f"flash in the served prefill {shape}"))
    log(f"generated: {tokens}; flash launches {n['flash_attention']} "
        f"(2 attention layers x {waves} prefill wave) at (B, S, H, KV, D, "
        f"causal) {shape}, {q.dtype}, each within KERNEL_TOL of the plain "
        f"version on its inputs (max abs error {flash_err:.3e}); no other "
        f"kernel")
    assert all(math.isfinite(x) for x in losses) and losses[40] < losses[0]
    # the same on the CPU, and both in fp32 compute
    cpu_state, cpu = qs.train_lm("cpu", log=quiet)
    cpu_tokens, _ = qs.serve(cpu_state.params, "cpu")
    assert tokens == cpu_tokens, f"tokens {tokens}, on the CPU {cpu_tokens}"
    cfg = qs.CFG
    try:
        qs.CFG = dataclasses.replace(cfg, dtype="float32")
        _, card32 = qs.train_lm(dev, log=quiet)
        _, cpu32 = qs.train_lm("cpu", log=quiet)
    finally:
        qs.CFG = cfg
    rel = lambda a, b: np.abs(np.subtract(a, b)) / np.abs(b)  # noqa: E731
    fp32_rel = float(rel(card32, cpu32).max())
    bf16_rel = float(rel(losses, cpu).max())
    gate = 2 * float(rel(cpu, cpu32).max())
    assert fp32_rel <= QS_FP32_RTOL, (fp32_rel, card32, cpu32)
    assert bf16_rel <= gate, (bf16_rel, gate, losses, cpu)
    log(f"tokens equal to the CPU's; LM losses at steps 0 / 20 / 40, card "
        f"{' / '.join(f'{losses[i]:.6f}' for i in (0, 20, 40))}, CPU "
        f"{' / '.join(f'{cpu[i]:.6f}' for i in (0, 20, 40))}: largest "
        f"relative gap over the 60 steps {bf16_rel:.3e} (bf16; gate "
        f"{gate:.3e}, twice the CPU's bf16 distance from fp32), fp32 "
        f"compute {fp32_rel:.3e} (gate {QS_FP32_RTOL})")
    out.update(losses=losses, cpu_losses=cpu, fp32_rel=fp32_rel,
               bf16_rel=bf16_rel, bf16_gate=gate, tokens=tokens,
               flash_launches=n["flash_attention"], waves=waves,
               flash_max_abs_err=flash_err)
    # 3., on the card at the example's settings
    reset()
    t1 = time.perf_counter()
    fx = qs.flexai(dev, log=log)
    torch.cuda.synchronize()
    out["flexai_s"] = time.perf_counter() - t1
    agent, summ = fx["agent"], fx["summary"]
    assert summ["tasks"] == len(fx["queue"]) and agent.env_steps == \
        3 * len(fx["queue"])
    assert 0.0 <= summ["stm_rate"] <= 1.0 and 0.0 <= summ["r_balance"] <= 1
    assert all(math.isfinite(x) for x in agent.losses)
    assert not any(counts().values()), f"FlexAI launched {counts()}"
    cpu_fx = qs.flexai("cpu", max_tasks=QS_ACTIONS, episodes=1, log=quiet)
    card_trace, cpu_trace = agent.trace, cpu_fx["agent"].trace
    assert len(card_trace) == len(cpu_trace) == QS_ACTIONS
    k, gap = first_difference(card_trace, cpu_trace, QS_MARGIN)
    log(f"{agent.env_steps} training steps, {len(agent.losses)} TD updates "
        f"in {out['flexai_s']:.1f} s ({agent.env_steps / out['flexai_s']:.1f}"
        f" steps/s); the first {QS_ACTIONS} training actions "
        + ("equal to the CPU agent's" if k is None else
           f"equal to the CPU agent's up to action {k}, a tie there (card "
           f"Q margin {gap:.2e})"))
    out.update(tasks=summ["tasks"], env_steps=agent.env_steps,
               updates=len(agent.losses), stm=summ["stm_rate"],
               r_balance=summ["r_balance"], first_action_diff=k,
               seconds=time.perf_counter() - t0)
    return out


def quickstart_worker(log_path, out_path, paths):
    """``quickstart_run`` in a spawned process of its own (``paths``: the
    port's and the twins' directories), its lines to ``log_path`` and its
    result to ``out_path`` (JSON)."""
    import contextlib
    sys.path[:0] = paths
    import torch
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        out = quickstart_run(torch)
    with open(out_path, "w") as f:
        json.dump(out, f)


def quickstart_start(work_dir):
    """Start ``quickstart_worker`` (a daemon).  Returns its handle for
    ``quickstart_check``."""
    import multiprocessing
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.join(here, d) for d in ("src", "examples")]
    log = os.path.join(work_dir, "quickstart.log")
    res = os.path.join(work_dir, "quickstart.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=quickstart_worker, args=(log, res, paths), daemon=True)
    proc.start()
    return {"proc": proc, "log": log, "out": res, "t0": time.perf_counter()}


def quickstart_check(run):
    """Wait for the quickstart's process, print its lines; fails if it
    failed or outlived ``QS_TIMEOUT_S``.  Returns its result."""
    proc = run["proc"]
    proc.join(max(QS_TIMEOUT_S - (time.perf_counter() - run["t0"]), 1))
    try:
        text = ""
        if os.path.exists(run["log"]):
            with open(run["log"]) as f:
                text = f.read()
        assert not proc.is_alive(), \
            "the quickstart did not end:\n" + text[-2000:]
        assert proc.exitcode == 0, (f"the quickstart failed (exit code "
                                    f"{proc.exitcode}):\n" + text[-3000:])
    finally:
        background_stop({"quickstart": run})
    print(text, end="")
    with open(run["out"]) as f:
        return json.load(f)


def pipeline_example(torch, card, counters, dev="cuda"):
    """examples/serve_driving_pipeline_torch.py's ``pipeline`` on the card
    at its settings.  Each dataflow kernel's launches must equal the
    convolutions its pool ran: the calibrations' calls and every frame
    of the FlexAI and ``worst`` runs, at ``PER_FRAME`` a frame; no other
    kernel launches.  Returns what it measured."""
    import serve_driving_pipeline_torch as pl
    for reset, _ in counters.values():
        reset()
    t0 = time.perf_counter()
    res = pl.pipeline(dev, log=lambda m: print(
        f"  serve_driving_pipeline_torch: {m}"))
    seconds = time.perf_counter() - t0
    plat = res["platform"]
    want = {k: 0 for k in counters}
    for pool in plat.pools:
        want[pool.spec.archetype] += CALIBRATION_CALLS * sum(
            PER_FRAME.values())
    for placements in (res["placements"], res["worst_placements"]):
        assert len(placements) == len(res["queue"]) > 0
        for task, a in zip(res["queue"], placements):
            want[plat.pools[a].spec.archetype] += PER_FRAME[task.kind.value]
    got = {k: read() for k, (_, read) in counters.items()}
    assert got == want, f"launches {got}, expected {want}"
    for key in ("flexai", "worst"):
        assert 0.0 <= res[key]["stm_rate"] <= 1.0
    fps = {p.spec.archetype: p.measured_fps for p in plat.pools}
    print(f"driving pipeline twin on {card}: {seconds:.1f} s in all, the "
          f"FlexAI run's {len(res['queue'])} frames {res['wall_s']:.2f} s "
          f"(rate_scale {res['rate_scale']:.4f}); pool fps "
          + "; ".join(f"{df} " + " / ".join(f"{k} {v:.1f}"
                                            for k, v in f.items())
                      for df, f in fps.items())
          + f"; STM FlexAI {res['flexai']['stm_rate']:.4f}, worst "
          f"{res['worst']['stm_rate']:.4f}; launches "
          + ", ".join(f"{k} {v}" for k, v in got.items() if v)
          + " (as predicted)")
    return {"seconds": seconds, "wall_s": res["wall_s"],
            "rate_scale": res["rate_scale"], "fps": fps,
            "stm": res["flexai"]["stm_rate"],
            "r_balance": res["flexai"]["r_balance"],
            "worst_stm": res["worst"]["stm_rate"],
            "launches": {k: v for k, v in got.items() if v}}


def phase_examples(torch, card, counters, quickstart):
    """Main path 16: the quickstart twin's process held, then the driving
    pipeline twin (the failures twin runs in phase 16c)."""
    t0 = time.perf_counter()
    qs = quickstart_check(quickstart)
    print(f"quickstart twin (a process of its own since phase 8) on "
          f"{card}: {qs['seconds']:.1f} s (LM {qs['lm_s']:.1f} s, FlexAI "
          f"{qs['flexai_s']:.1f} s); FlexAI on {qs['tasks']} tasks: STM "
          f"{qs['stm']:.4f}, R_Balance {qs['r_balance']:.4f}")
    pipe = pipeline_example(torch, card, counters)
    dt = time.perf_counter() - t0
    print(f"examples phase {dt:.1f} s")
    return {"quickstart": qs, "pipeline": pipe, "seconds": dt}


def main() -> int:
    import atexit
    import shutil
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    # the port, and its twins of the examples (examples/*_torch.py)
    sys.path[:0] = [os.path.join(here, "src"), os.path.join(here, "examples")]
    import numpy as np

    import torch.distributed as dist

    from repro_torch import distributed as pdist
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_dataflow import kernel as conv_kernel
    from repro_torch.kernels.dqn_update import kernel as td_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch

    # 1. build
    stamp("1 build")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, info in build.ptxas_info.items():
        lines = info.splitlines()
        spills = [l.strip() for l in lines if "spill" in l
                  and "0 bytes spill stores, 0 bytes spill loads" not in l]
        print(f"  {name}: " + " | ".join(
            l.split("ptxas info    : ")[-1] for l in lines
            if "registers" in l) + (f"; SPILLS: {spills}" if spills else
                                    "; no spills"))

    # 2. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card_name = torch.cuda.get_device_name(0)
    print(f"card: {card_name}, capability "
          f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32, "plain version in TF32"

    # 3. the TD kernel against its plain version
    stamp("3 kernels")
    rng = np.random.default_rng(0)
    max_err, timing = phase_kernels(torch, rng)

    # 4. the conv kernels against their plain version, and timed
    stamp("4 conv")
    conv = phase_conv(torch, rng, smi)

    # 5. + 6. flash attention and the SSD scan against their plain
    # versions, and timed
    stamp("5 attention")
    attn = phase_attention(torch, rng, smi)
    stamp("6 ssd")
    ssd = phase_ssd(torch, rng, smi)

    # 7. small input against the CPU
    stamp("7 small")
    phase_small(torch, rng)

    # 8. the LMs at full width, 2 layers, against the CPU, 16c's launcher
    # runs, 17c's dry run and 19's quickstart twin: all in the background,
    # held before phase 14, in phase 16, in phase 17 and in phase 19
    stamp("8 lm-small, 16c's launcher, 17c's dry run and 19's quickstart, "
          "started in the background")
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    dry_runs = dryrun_start(os.path.join(here, "src"), work_dir)
    background = {"lm-small": lm_small_start(work_dir),
                  "launcher": launcher_start(),
                  "quickstart": quickstart_start(work_dir), **dry_runs}
    atexit.register(background_stop, background)
    atexit.register(shutil.rmtree, work_dir, True)

    # 9. + 10. main path 1 (training, serving), counted
    stamp("9 train")
    td_kernel.launches = 0
    targs = train_launch.parser().parse_args(
        ["--flexai", "--td-kernel", "--episodes", "1", "--device", "cuda"])
    trainer, history, dt, _ = train_launch.train_flexai(targs)
    # the episode's launches are host-bound (the device idles between
    # them), so events around each would also time the host: its device
    # time is the launches times the kernel's own time at B 64, above
    episode_td_ms = td_kernel.launches * timing["update"][0]
    ts = trainer.ts
    assert all(p.device.type == "cuda" for p in
               (*ts.eval_p, *ts.targ_p, *ts.opt.mu, *ts.opt.nu, ts.replay.s))
    assert ts.updates > 0 and all(math.isfinite(x) for x in trainer.losses)
    assert len(trainer.losses) == ts.updates
    print(f"train: {ts.env_steps} env steps, {ts.updates} TD updates in "
          f"{dt:.2f}s ({ts.env_steps / dt:.1f} env-steps/s), mean loss "
          f"{history[-1]['mean_loss']:.5f}, stm_rate "
          f"{history[-1]['stm_rate']:.4f}; the TD kernel's device time "
          f"{episode_td_ms:.1f} ms ({td_kernel.launches} launches x "
          f"{timing['update'][0]:.4f} ms)")
    stamp("10 serve")
    sargs = serve_launch.parser().parse_args(
        ["--placement", "--rate-scale", "0.025", "--device", "cuda"])
    svc, results, sdt, n_tasks = serve_launch.serve_placements(
        sargs, params=trainer.eval_params())
    launches = td_kernel.launches
    assert len(results) == sargs.routes == 8
    for r in results:
        pl = np.asarray(r["placements"])
        assert len(pl) == r["tasks"] and ((pl >= 0) & (pl < A)).all()
        assert math.isfinite(r["gvalue"])
    stm = float(np.mean([r["stm_rate"] for r in results]))
    print(f"serve: {len(results)} routes / {n_tasks} tasks in {sdt:.2f}s "
          f"({n_tasks / sdt:.1f} tasks/s), {svc.dispatches} dispatches, "
          f"mean stm_rate {stm:.4f}")
    assert launches == ts.updates, \
        f"{launches} kernel launches for {ts.updates} TD updates"

    # 10a. + 10b. fig 12's baselines, then the variability model, on the
    # weights main path 1 trained; the degradation episode's TD launches
    # are counted from 0 inside phase_variability
    stamp("10a baselines")
    t0 = time.perf_counter()
    baselines = phase_baselines(torch, trainer.eval_params(),
                                trainer.cfg.backlog_scale, smi)
    t1 = time.perf_counter()
    stamp("10b variability")
    variability, degr_launches, degr_s, fleet, base = phase_variability(
        torch, trainer.eval_params(), trainer.cfg.backlog_scale, smi)
    print(f"baselines phase {t1 - t0:.1f} s, variability phase "
          f"{time.perf_counter() - t1:.1f} s")
    baseline_ops(torch, trainer.eval_params(), trainer.cfg.backlog_scale,
                 baselines)

    # 10c. - 10e. main paths 6-8: the DP trainer (grads variant, lanes
    # batched), the population fine-tune over the fleet (Adam variant,
    # lanes batched) and the sharding seam; each phase counts its TD
    # launches from 0
    stamp("10c dp")
    t0 = time.perf_counter()
    dp = phase_dp(torch, smi)
    t1 = time.perf_counter()
    stamp("10d population")
    population = phase_population(torch, trainer.eval_params(), trainer.cfg,
                                  fleet, base, smi)
    t2 = time.perf_counter()
    # 18's processes, in the background from here to phase 18: phase 8's
    # and 16c's host work is done or nearly, so they share the host with
    # the single-threaded loops of 10e-13 only
    stamp("18's processes started in the background")
    part_runs = part_start(work_dir)
    background.update(part_runs)
    mesh = pdist.make_mesh("cuda")
    try:
        stamp("10e sharded")
        sharded = phase_sharded(torch, dp, mesh)
        t3 = time.perf_counter()
        print(f"dp phase {t1 - t0:.1f} s, population phase {t2 - t1:.1f} "
              f"s, sharded phase {t3 - t2:.1f} s")

        # 10f. main path 9: QoS placement serving on the weights main
        # path 1 trained (no kernel on its path: plain torch ops)
        stamp("10f qos")
        qos = phase_qos(torch, trainer.eval_params(),
                        trainer.cfg.backlog_scale, mesh, smi)

        # 10g. main path 10: crash-recoverable QoS serving and trainer
        # resume; the trainer's resume runs launch the TD kernel in their
        # own processes, which print their counts
        stamp("10g durability")
        durability = phase_durability(torch, trainer.eval_params(),
                                      trainer.cfg.backlog_scale, smi)
    finally:
        dist.destroy_process_group()

    # 10h. main path 11: the stage pipeline; its trainers' TD launches (at
    # D = 70) are counted from 0 inside phase_stages, each trainer's own
    stamp("10h stages")
    stages, stage_oracle = phase_stages(torch, smi,
                                        timing["stage"]["update"][0])

    # 10i. main path 12: the stage mesh; its trainers' TD launches are
    # counted from 0 inside, each trainer's own
    stamp("10i stage mesh")
    stage_mesh = phase_stage_mesh(torch, stage_oracle, timing["stage"], smi)

    bound, bound_by = td_bound_ms(64, fold_adam=True)
    print(f"bound at B=64: update {bound:.6f} ms ({bound_by}), grads "
          f"{td_bound_ms(64, fold_adam=False)[0]:.6f} ms")

    # 11. main path 2: the full-width perception nets, counted per frame
    stamp("11 perception")
    per = phase_perception(torch, rng, smi)
    for df, by_net in per.items():
        n = {k: v["launches_per_frame"] for k, v in by_net.items()}
        assert n == {"yolo": 55, "ssd": 58, "goturn": 10}, (df, n)

    # 12. main path 3: the driving pipeline, counted
    stamp("12 pipeline")
    for k in conv_kernel.launches:
        conv_kernel.launches[k] = 0
    td_kernel.launches = 0
    pipe = phase_pipeline(torch, smi)
    pipe_td_ms = td_kernel.launches * timing["update"][0]
    conv_launches = dict(conv_kernel.launches)
    assert td_kernel.launches == pipe["trainer"].ts.updates, \
        f"{td_kernel.launches} TD launches for {pipe['trainer'].ts.updates}"
    assert all(conv_launches.values()), conv_launches
    print(f"pipeline launches: {conv_launches}, dqn_td "
          f"{td_kernel.launches} ({pipe_td_ms:.2f} ms of TD device time: "
          f"launches x {timing['update'][0]:.4f} ms)")
    pipe_td = td_kernel.launches

    # 13. main path 4: the driving pipeline on full-width pools, counted
    stamp("13 full-width pipeline")
    for k in conv_kernel.launches:
        conv_kernel.launches[k] = 0
    td_kernel.launches = 0
    full = phase_pipeline(torch, smi, full_width=True)
    full_launches = dict(conv_kernel.launches)
    assert td_kernel.launches == full["trainer"].ts.updates, \
        f"{td_kernel.launches} TD launches for {full['trainer'].ts.updates}"
    assert all(full_launches.values()), full_launches
    print(f"full-width pipeline launches: {full_launches}, dqn_td "
          f"{td_kernel.launches}")
    full_td = td_kernel.launches

    # 14. main path 5: token serving of each LM at full width and depth,
    # every kernel's count reset before each and read after it
    def counter(mod, key=None):
        def reset():
            if key is None:
                mod.launches = 0
            else:
                mod.launches[key] = 0

        def read():
            return mod.launches if key is None else mod.launches[key]
        return reset, read

    counters = {"dqn_td": counter(td_kernel),
                "flash_attention": counter(flash_kernel),
                "ssd_scan": counter(ssd_kernel)}
    counters.update({df: counter(conv_kernel, df)
                     for df in conv_kernel.launches})
    timed = {"stablelm-1.6b": (flash_kernel, "flash_attention_cuda"),
             "mamba2-130m": (ssd_kernel, "ssd_scan_cuda")}
    stamp("8 lm-small held")
    lm_small_check(background["lm-small"])
    stamp("14 lm-serve")
    lm = {arch: phase_lm_serve(torch, arch, smi, counters, timed[arch])
          for arch in LM_ARCHS}
    for arch, kname in (("stablelm-1.6b", "flash_attention"),
                        ("mamba2-130m", "ssd_scan")):
        n = lm[arch]["launches"]
        want = {k: 0 for k in n}
        want[kname] = 24 * lm[arch]["waves"]
        assert n == want, f"{arch}: launches {n}, expected {want}"

    # 15. main path 5 for the rest of the zoo, counted per
    # run as above
    stamp("15 lm zoo")
    t0 = time.perf_counter()
    zoo = phase_lm_zoo(torch, smi, counters)
    print(f"lm zoo phase {time.perf_counter() - t0:.1f} s")

    # 16. main path 13: LM training on the plain attention and scan
    # branches; every kernel's count reset before each run and read after
    # it must stay 0
    stamp("16 lm-train")
    lm_train = phase_lm_train(torch, smi, counters, background["launcher"])

    # 17. main path 14: expert parallelism over a process mesh and the dry
    # run; each EP process counts its flash launches from 0
    stamp("17 mesh")
    mesh_phase = phase_mesh(torch, smi, dry_runs)

    # 18. main path 15: the partitioned train step and checkpoints across
    # meshes, in two processes sharing the card; no kernel on its path
    # (each process's counts, set to 0 at its start, must stay 0); then
    # partitioned serving, flash and SSD launches counted from 0 over
    # each partitioned prefill
    stamp("18 partitioned")
    partitioned = phase_partitioned(part_runs, work_dir, smi)

    # 19. main path 16: the examples' twins; the quickstart's process
    # counted its own launches, the driving pipeline's are counted here
    # from 0
    stamp("19 examples")
    examples = phase_examples(torch, smi, counters, background["quickstart"])
    stamp("done")
    print(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s "
          f"(the cuts for time: PERF.md section 4)")

    st = timing["stage"]
    stage_launches = {k: v["launches"] for k, v in stages["train"].items()}
    entries = [{
        "name": "dqn_td", "route": "cuda",
        "source": "src/repro_torch/kernels/dqn_update/csrc/dqn_td.cu",
        "replaces": "src/repro/kernels/dqn_update/kernel.py:73",
        "launches": launches + degr_launches + stage_launches["single"],
        "max_abs_err": max_err,
        "ms": timing["update"][0], "plain_ms": timing["update_plain"][0],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "call_ms": timing["update"][1],
        "plain_call_ms": timing["update_plain"][1],
        "grads_ms": timing["grads"][0],
        "grads_plain_ms": timing["grads_plain"][0],
        "train_serve_launches": launches,
        "degradation_launches": degr_launches,
        "degradation_seconds": degr_s,
        "pipeline_launches": pipe_td,
        "full_width_pipeline_launches": full_td,
        "episode_td_ms": episode_td_ms, "pipeline_td_ms": pipe_td_ms,
        "episode_seconds": dt, "plan": timing["plan"],
        "stage_launches": stage_launches["single"],
        "stage_ms": st["update"][0], "stage_plain_ms": st["update_plain"][0],
        "stage_call_ms": st["update"][1], "stage_bound_ms": st["bound"][0],
        "stage_bound_by": st["bound"][1], "stage_plan": st["plan"],
        "stage_episode_td_ms": stage_launches["single"] * st["update"][0]}]
    lanes_t = timing["lanes"]
    # at L = 4 as the trainers launch it: update a net a lane (population),
    # grads with the nets shared (DP)
    lane_bound = {"update": td_bound_ms(64, True, lanes=4),
                  "grads": td_bound_ms(64, False, lanes=4, shared_nets=True)}
    print(f"bound at L=4, B=64: update {lane_bound['update'][0]:.6f} ms "
          f"({lane_bound['update'][1]}), grads "
          f"{lane_bound['grads'][0]:.6f} ms ({lane_bound['grads'][1]})")
    entries.append({
        "name": "dqn_td_lanes", "route": "cuda",
        "source": "src/repro_torch/kernels/dqn_update/csrc/dqn_td.cu",
        "replaces": "src/repro/kernels/dqn_update/kernel.py:73",
        "launches": dp["launches"] + population["launches"]
        + sharded["launches"] + stage_launches["population"]
        + stage_launches["dp"] + stage_mesh["population"]["launches"]
        + stage_mesh["dp"]["launches"],
        "max_abs_err": max_err,
        "ms": lanes_t[4]["update"], "plain_ms": lanes_t["plain"]["update"],
        "bound_ms": lane_bound["update"][0],
        "bound_by": lane_bound["update"][1],
        "library_ms": None, "lanes": 4,
        "grads_ms": lanes_t[4]["grads"],
        "grads_plain_ms": lanes_t["plain"]["grads"],
        "grads_bound_ms": lane_bound["grads"][0],
        "ms_by_lanes": {n: lanes_t[n] for n in (1, 4, 16)},
        "dp_grads_launches": dp["launches"],
        "population_update_launches": population["launches"],
        "sharded_grads_launches": sharded["launches"],
        "dp_episode_seconds": dp["seconds"],
        "population_seconds": population["seconds"],
        "stage_population_update_launches": stage_launches["population"],
        "stage_dp_grads_launches": stage_launches["dp"],
        "stage_mesh_population_update_launches":
            stage_mesh["population"]["launches"],
        "stage_mesh_dp_grads_launches": stage_mesh["dp"]["launches"],
        "stage_update_ms": st["update_lanes"],
        "stage_grads_ms": st["grads_lanes"],
        "plan": lanes_t["plan"]})
    for df, src, body in (("MconvMC", "mconv_mc", 27),
                          ("SconvIC", "sconv_ic", 43),
                          ("SconvOD", "sconv_od", 31)):
        c = conv[df]
        by_path = {
            "launch/drive.py": conv_launches[df],
            "launch/drive.py --full-width": full_launches[df],
            "examples/serve_driving_pipeline_torch.py":
                examples["pipeline"]["launches"][df]}
        entries.append({
            "name": src, "route": "cuda",
            "source": f"src/repro_torch/kernels/conv_dataflow/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/conv_dataflow/{src}.py:{body}",
            "launches": sum(by_path.values()),
            "launches_by_arch": by_path,
            "max_abs_err": c["max_abs_err"],
            "ms": c["yolo"]["ms"], "plain_ms": c["yolo"]["plain_ms"],
            "bound_ms": c["yolo"]["bound_ms"],
            "bound_by": c["yolo"]["bound_by"],
            "library_ms": c["yolo"]["library_ms"],
            "splits": c["yolo"]["splits"],
            "launch_host_us": c["launch_host_us"],
            "launch_device_us": c["launch_device_us"],
            "layer": c["yolo"]["layer"], "ssd_layer": c["ssd"],
            "max_abs_err_bf16": c["max_abs_err_bf16"],
            "perception": per[df]})
    for kname, arch, res, body in (
            ("flash_attention", "stablelm-1.6b", attn,
             "src/repro/kernels/flash_attention/kernel.py:24"),
            ("ssd_scan", "mamba2-130m", ssd,
             "src/repro/kernels/ssd_scan/kernel.py:23")):
        run = lm[arch]
        by_arch = {arch: run["launches"][kname]}
        by_arch.update({a: r["launches"][kname] for a, r in zoo.items()
                        if r["launches"][kname]})
        if kname == "flash_attention":
            by_arch[f"{EP_ARCH} (EP mesh, 2 ranks)"] = sum(
                r["flash"] for r in mesh_phase["ranks"])
            by_arch["quickstart (examples/quickstart_torch.py)"] = \
                examples["quickstart"]["flash_launches"]
        by_arch.update({
            f"{a} (partitioned prefill, 2 ranks x 2 meshes)": n
            for a, n in partitioned["serve_launches"][kname].items() if n})
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/{kname}/csrc/{kname}.cu",
            "replaces": body, "launches": sum(by_arch.values()), **res,
            "launches_by_arch": by_arch,
            "lm_serve": {k: v for k, v in run.items()
                         if k not in ("launches", "pattern")},
            "lm_zoo": {a: {k: v for k, v in r.items()
                           if k not in ("launches", "pattern")}
                       for a, r in zoo.items() if r["launches"][kname]}})
    print("record, not measured in this run (PERF.md section 6): "
          "device ms before the redesign "
          + json.dumps({"prev_ms_recorded": PREV_MS}))
    print(json.dumps({"baselines": {
        k: {"stm": [x["stm_rate"] for x in v["summaries"]],
            "r_balance": [x["r_balance"] for x in v["summaries"]],
            "makespan_s": [x["makespan_s"] for x in v["summaries"]],
            "energy_j": [x["total_energy_j"] for x in v["summaries"]],
            "total_ms": [x["total_ms"] for x in v["summaries"]],
            "seconds": v["seconds"], "ms_per_task": v["ms_per_task"],
            "aten_ops_per_step": v["aten_ops_per_step"],
            "braking_m": [b["distance_m"] for b in v["brake"]]}
        for k, v in baselines.items()}, "variability_stm": variability,
        "dp": {k: dp[k] for k in ("stm", "mean_loss", "updates",
                                  "env_steps", "seconds")},
        "population": {k: population[k] for k in (
            "base_stm", "fleet_stm", "updates", "seconds")},
        "qos": qos, "durability": durability, "stages": stages,
        "stage_mesh": stage_mesh, "lm_train": lm_train,
        "mesh": mesh_phase, "partitioned": partitioned,
        "examples": examples}))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
