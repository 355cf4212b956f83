"""Serving: FlexAI placement serving, and batched token serving of an LM
(decoder-only, with or without a frontend, or encoder-decoder).

``FlexAIPlacementService``: each request is one vehicle's task queue.
Queues are precompiled to ``TaskArrays``, right-padded to power-of-two
length buckets, stacked per bucket and placed by one batched greedy run
per bucket; results come back to the host in one transfer per bucket.
With a mesh (``repro_torch.distributed``) a bucket's routes are padded to
a multiple of the mesh size and split over its ranks.

``ServeEngine``: the port of the JAX package's wave-based token engine
(``repro.serve.engine.ServeEngine``): length buckets, FIFO and EDF
admission, shedding, a batched prefill per wave (flash attention or the
SSD scan inside), then lockstep greedy or sampled decode against a
``max_seq`` cache.  A config with a frontend gets all-zero
``frontend_embeds`` [slots, max(1, num_frontend_tokens), d_model] in
fp32, as the JAX engine sends, and decoding starts at ``pos = plen``
whatever the frontend prepended (the first step writes over cache row
``plen``; the decode mask hides the prefilled rows after it).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import distributed as pdist
from repro_torch.core.flexai.dqn import DQNParams
from repro_torch.core.flexai.engine import (make_schedule_fn,
                                            make_sharded_schedule_fn)
from repro_torch.core.platform import route, spec_from_platform, summarize
from repro_torch.core.tasks import (TaskArrays, pad_route_batch,
                                    pad_task_arrays, stack_task_arrays,
                                    tasks_to_arrays, token_deadline_budget)
from repro_torch.kernels.protocol import resolve_device
from repro_torch.serve.policy import QoSPolicy, power_of_two_bucket


def _host(x):
    return type(x)(*[f.cpu() for f in x])


class FlexAIPlacementService:
    """Multi-vehicle placement serving: bucketed, route-batched greedy
    placement, with a solo path for requests whose deadline is tight."""

    def __init__(self, platform, params: DQNParams, *,
                 backlog_scale: float = 1.0, min_bucket: int = 64,
                 mesh=None, tight_slack_s: "float | None" = None,
                 device=None):
        self.device = resolve_device(device)
        self.spec = spec_from_platform(platform, self.device)
        self.params = DQNParams(*[p.to(self.device, torch.float32)
                                  for p in params])
        self.backlog_scale = backlog_scale
        self.min_bucket = min_bucket
        self.tight_slack_s = tight_slack_s
        self.shards = 1 if mesh is None else pdist.mesh_size(mesh)
        if mesh is None:
            self._batched_fn = make_schedule_fn(self.spec, backlog_scale,
                                                batched=True)
        else:
            # each bucket's routes padded to a multiple of the mesh size
            # and split over its ranks
            self._batched_fn = make_sharded_schedule_fn(self.spec, mesh,
                                                        backlog_scale)
        # tight-deadline lane: the single-route run, dispatched at once
        # instead of waiting to co-batch with bucket peers
        self._fused_fn = make_schedule_fn(self.spec, backlog_scale)
        self.dispatches = 0
        self.fused_dispatches = 0

    def _bucket(self, n: int) -> int:
        return power_of_two_bucket(n, self.min_bucket)

    def place(self, queues: list, deadlines: "list | None" = None,
              now: float = 0.0) -> list[dict]:
        """Schedule every queue; returns one summary dict per queue with
        ``placements`` trimmed to the queue's real length.

        With ``tight_slack_s`` set, a request whose slack ``deadline -
        now`` is below it skips co-batching and runs solo ("fused" path);
        the rest run per bucket ("batched").
        """
        arrays = [q if isinstance(q, TaskArrays) else tasks_to_arrays(q)
                  for q in queues]
        results: list = [None] * len(arrays)
        tight: set = set()
        if deadlines is not None and self.tight_slack_s is not None:
            tight = {i for i, d in enumerate(deadlines)
                     if d is not None and d - now < self.tight_slack_s}
        for i in sorted(tight):
            ta = pad_task_arrays(arrays[i], self._bucket(arrays[i].num_tasks))
            final, recs = self._fused_fn(self.params, ta.to(self.device))
            final, recs = _host(final), _host(recs)
            self.dispatches += 1
            self.fused_dispatches += 1
            summ = summarize(self.spec, final, recs)
            summ["placements"] = recs.action[: arrays[i].num_tasks].numpy()
            summ["bucket"] = ta.num_tasks
            summ["path"] = "fused"
            results[i] = summ
        by_bucket: dict = {}
        for i, ta in enumerate(arrays):
            if i not in tight:
                by_bucket.setdefault(self._bucket(ta.num_tasks), []).append(i)
        for bucket, idxs in sorted(by_bucket.items()):
            batch = stack_task_arrays(
                [pad_task_arrays(arrays[i], bucket) for i in idxs])
            if self.shards > 1:
                batch = pad_route_batch(batch, self.shards)
            finals, recs = self._batched_fn(self.params,
                                            batch.to(self.device))
            # one device->host transfer per bucket, then host slicing
            finals, recs = _host(finals), _host(recs)
            self.dispatches += 1
            for lane, i in enumerate(idxs):
                lane_recs = route(recs, lane)
                summ = summarize(self.spec, route(finals, lane), lane_recs)
                summ["placements"] = \
                    lane_recs.action[: arrays[i].num_tasks].numpy()
                summ["bucket"] = bucket
                summ["path"] = "batched"
                results[i] = summ
        return results



# ---------------------------------------------------------------------------
# Token serving
# ---------------------------------------------------------------------------

def sample_token(logits: torch.Tensor, gen: "torch.Generator | None" = None,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int32).  Temperature 0 is greedy (the
    first maximal index, as ``jnp.argmax``); otherwise a categorical draw
    from ``gen`` over the temperature-scaled logits, kept to the ``top_k``
    largest when ``top_k`` > 0.  The draws are not ``jax.random``'s."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def make_serve_step(api, greedy: bool = True, temperature: float = 1.0,
                    top_k: int = 0):
    """(params, cache, token [B,1], pos) -> (next_token [B,1], logits,
    cache).  With ``greedy=False`` the step takes a trailing
    ``torch.Generator`` and samples through :func:`sample_token`."""

    def serve_step(params, cache, token, pos):
        logits, new_cache = api.decode_step(params, cache, token, pos)
        nxt = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
        return nxt[:, None], logits, new_cache

    def sampled_step(params, cache, token, pos, gen):
        logits, new_cache = api.decode_step(params, cache, token, pos)
        nxt = sample_token(logits[:, -1, :], gen, temperature=temperature,
                           top_k=top_k)
        return nxt[:, None], logits, new_cache

    return serve_step if greedy else sampled_step


def make_prefill_step(api):
    def prefill_step(params, batch):
        return api.prefill(params, batch)

    return prefill_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # deadline-aware QoS (engine step units).  ``deadline`` is absolute;
    # None at submit means "derive from the token budget"
    # (tasks.token_deadline_budget).
    deadline: "float | None" = None
    submit_time: float = 0.0
    finish_time: "float | None" = None
    waves_waited: int = 0
    # decode tokens the admission pricing promised (wave-padding-aware cap
    # applied); delivery below this is a pricing bug, not truncation
    priced_tokens: "int | None" = None

    @property
    def slack(self) -> "float | None":
        if self.deadline is None or self.finish_time is None:
            return None
        return self.deadline - self.finish_time

    @property
    def submit_order(self) -> int:
        # QoSPolicy sort-key protocol (ties inside one wave break on uid)
        return self.uid


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    """Wave-based batched serving with a static decode shape.

    Requests are admitted in waves of ``slots``: a wave's prompts are
    left-padded with ``pad_token`` to a common length and batch-prefilled
    once (without a padding mask: pads are attended, as in the JAX
    engine), then decoded in lockstep until every request in the wave
    finishes.  The decode batch and cache keep one shape (``slots``,
    ``max_seq``).  Admission is length-aware: queued requests are bucketed
    by total length (prompt + budget, power of two) and each wave packs
    the bucket of its head request (the oldest under ``qos="fifo"``, the
    earliest effective deadline under ``qos="edf"``, which also sheds
    requests whose decode budget can no longer meet their deadline to
    ``dead_letter``).  Deadlines default to
    ``tasks.token_deadline_budget`` on a virtual step clock (1.0 per
    decode step).  ``wave_log`` records the admitted uid groups and
    ``wave_times`` the host seconds of each wave's prefill and decode
    (each ends with the sampled tokens on the host, so with the device's
    work done).

    Runs on the GPU unless ``device="cpu"``; the parameters are moved to
    the engine's device.
    """

    def __init__(self, api, params, *, slots: int, max_seq: int,
                 temperature: float = 0.0, seed: int = 0,
                 pad_token: int = 0, qos: str = "fifo",
                 deadline_scale: float = 1.0, aging_credit: float = 4.0,
                 shed: bool = True, device=None):
        if qos not in ("fifo", "edf"):
            raise ValueError(f"unknown qos policy {qos!r}")
        self.device = resolve_device(device)
        self._qpolicy: "QoSPolicy | None" = None
        self.api = api
        self.params = _to_device(params, self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.pad_token = pad_token
        self.qos = qos
        self.deadline_scale = deadline_scale
        self.aging_credit = aging_credit
        self.shed = shed
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = make_prefill_step(api)
        self._step = make_serve_step(api, greedy=temperature <= 0.0,
                                     temperature=temperature)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.dead_letter: list[Request] = []
        self.steps_executed = 0
        self.clock = 0.0          # virtual step clock (1.0 per decode step)
        self.wave_log: list[list[int]] = []
        self.wave_times: list[dict] = []

    @property
    def qpolicy(self) -> QoSPolicy:
        """The shared EDF/aging/shed formula object, rebuilt when the
        ``qos`` / ``aging_credit`` / ``shed`` knobs change."""
        p = self._qpolicy
        if (p is None or p.policy != self.qos
                or p.aging_credit != self.aging_credit
                or p.shed != self.shed):
            p = QoSPolicy(policy=self.qos, aging_credit=self.aging_credit,
                          shed=self.shed)
            self._qpolicy = p
        return p

    def _token_cap(self, req: Request) -> int:
        """Decode tokens ``max_seq`` can guarantee this request in a wave:
        bucket peers' common prompt padding can push ``pos`` up to
        ``bucket - 1`` before the first decode step."""
        return 1 + max(0, self.max_seq - self._length_bucket(req))

    def submit(self, req: Request) -> None:
        req.submit_time = self.clock
        # price the deadline for the tokens a wave can actually deliver
        req.priced_tokens = min(req.max_new_tokens, self._token_cap(req))
        if req.deadline is None:
            req.deadline = self.clock + token_deadline_budget(
                len(req.prompt), req.priced_tokens, self.deadline_scale)
        self.queue.append(req)

    def _merge_cache(self, prefill_cache):
        """Embed the prefill-length cache into a max_seq-length zero cache:
        KV entries at sequence offset 0 (positions 0..plen-1; an
        encoder-decoder's cross K/V at rows 0..T_src-1 of its
        ``max_seq // encoder_seq_ratio``, the rest zero and attended);
        SSM states match in shape and pass through."""
        zero = self.api.init_cache(self.slots, self.max_seq,
                                   device=self.device)

        def merge(z, p):
            if z.shape == p.shape:
                return p.to(z.dtype)
            # KV entries [n, B, S, K, D] differ only in the seq dim (axis 2)
            if (z.dim() == p.dim() and z.shape[:2] == p.shape[:2]
                    and z.shape[3:] == p.shape[3:]
                    and p.shape[2] <= z.shape[2]):
                z[:, :, : p.shape[2]] = p.to(z.dtype)
                return z
            raise ValueError(f"cache merge mismatch: {tuple(z.shape)} vs "
                             f"{tuple(p.shape)}")

        return {k: type(z)(*[merge(zl, pl)
                             for zl, pl in zip(z, prefill_cache[k])])
                for k, z in zero.items()}

    @staticmethod
    def _length_bucket(req: Request) -> int:
        """Power-of-two bucket of the request's total token budget — the
        quantity that sets its wave's lockstep cost."""
        return power_of_two_bucket(
            max(len(req.prompt) + req.max_new_tokens, 1), 1)

    def _shed_overdue(self) -> None:
        """Timeout shedding: a queued request that cannot finish its decode
        budget before its deadline moves to the dead-letter log."""
        keep = []
        for req in self.queue:
            need = float(max(min(req.max_new_tokens, self._token_cap(req)),
                             1))
            if self.qpolicy.should_shed(self.clock, need, req.deadline):
                req.finish_time = self.clock
                self.dead_letter.append(req)
            else:
                keep.append(req)
        self.queue = keep

    def _next_wave(self) -> list[Request]:
        # the head request picks the wave's length bucket, then the wave
        # fills from that bucket; slots not fillable from it stay padded
        if self.qos == "edf":
            if self.shed:
                self._shed_overdue()
            if not self.queue:
                return []
            head = min(self.queue, key=self.qpolicy.request_key)
            bucket = self._length_bucket(head)
            peers = sorted(
                (r for r in self.queue if self._length_bucket(r) == bucket),
                key=self.qpolicy.request_key)
            wave = peers[: self.slots]
            taken = {id(r) for r in wave}
            self.queue = [r for r in self.queue if id(r) not in taken]
            self.qpolicy.age(self.queue)
        else:
            bucket = self._length_bucket(self.queue[0])
            wave, rest = [], []
            for req in self.queue:
                if (len(wave) < self.slots
                        and self._length_bucket(req) == bucket):
                    wave.append(req)
                else:
                    rest.append(req)
            self.queue = rest
        self.wave_log.append([r.uid for r in wave])
        while len(wave) < self.slots:  # pad the wave with dummy requests
            wave.append(Request(uid=-1, prompt=np.array([self.pad_token],
                                                        np.int32),
                                max_new_tokens=0, done=True))
        return wave

    def _sample(self, logits) -> np.ndarray:
        return sample_token(logits[:, -1, :], self.gen,
                            self.temperature).cpu().numpy()[:, None]

    def _run_wave(self, wave: list[Request]) -> None:
        t0 = time.perf_counter()
        plen = max(len(r.prompt) for r in wave)
        prompts = np.full((self.slots, plen), self.pad_token, np.int32)
        for i, r in enumerate(wave):
            prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        cfg = self.api.cfg
        if cfg.frontend is not None:
            batch["frontend_embeds"] = torch.zeros(
                self.slots, max(1, cfg.num_frontend_tokens), cfg.d_model,
                device=self.device)
        logits, prefill_cache = self._prefill(self.params, batch)
        cache = self._merge_cache(prefill_cache)
        tok = self._sample(logits)
        t1 = time.perf_counter()
        pos = plen
        self.clock += 1.0  # prefill + first sampled token
        max_new = max((r.max_new_tokens for r in wave), default=0)
        for i, r in enumerate(wave):
            if not r.done and r.max_new_tokens > 0:
                r.generated.append(int(tok[i, 0]))
            if not r.done and len(r.generated) >= r.max_new_tokens:
                r.done = True
                r.finish_time = self.clock
        steps = 0
        for _ in range(max_new - 1):
            if pos >= self.max_seq - 1:
                break
            gen = () if self.temperature <= 0.0 else (self.gen,)
            nxt, _, cache = self._step(
                self.params, cache,
                torch.as_tensor(tok, device=self.device), pos, *gen)
            self.steps_executed += 1
            steps += 1
            self.clock += 1.0
            tok = nxt.cpu().numpy()
            pos += 1
            for i, r in enumerate(wave):
                if not r.done and len(r.generated) < r.max_new_tokens:
                    r.generated.append(int(tok[i, 0]))
                if not r.done and len(r.generated) >= r.max_new_tokens:
                    r.done = True
                    r.finish_time = self.clock
        for r in wave:
            r.done = True
            if r.finish_time is None:
                r.finish_time = self.clock
            if r.uid >= 0:
                self.finished.append(r)
        self.wave_times.append({"plen": plen, "prefill_s": t1 - t0,
                                "decode_steps": steps,
                                "decode_s": time.perf_counter() - t1})

    def run_until_done(self, max_waves: int = 1000) -> None:
        for _ in range(max_waves):
            if not self.queue:
                return
            wave = self._next_wave()
            if not wave:      # queue fully shed at admission
                return
            self._run_wave(wave)

    def qos_stats(self) -> dict:
        """Deadline bookkeeping over everything served so far (resolved
        requests only — the shared ``QoSPolicy.miss_stats`` contract)."""
        ms = self.qpolicy.miss_stats([r.slack for r in self.finished],
                                     len(self.dead_letter))
        return {
            "policy": self.qos,
            "finished": len(self.finished),
            "queued": len(self.queue),
            "shed": ms["shed"],
            # requests cut short by max_seq got partial service
            "truncated": sum(1 for r in self.finished
                             if len(r.generated) < r.max_new_tokens),
            # delivery below the priced budget means admission and the
            # lockstep decode loop disagree
            "short_changed": sum(
                1 for r in self.finished
                if r.priced_tokens is not None
                and len(r.generated) < min(r.priced_tokens,
                                           r.max_new_tokens)),
            "missed_deadline": ms["missed_deadline"],
            "miss_rate": ms["miss_rate"],
            "p50_slack": ms["p50_slack"],
            "p99_slack": ms["p99_slack"],
            "mean_turnaround": float(np.mean(
                [r.finish_time - r.submit_time for r in self.finished]))
            if self.finished else 0.0,
        }
