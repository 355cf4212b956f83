"""The port's token ``ServeEngine`` against the JAX package's, with the
same weights (the fp32 smoke configs, JAX's init carried across), the
same requests, greedy decode, FIFO and EDF admission (at deadline scale
0.4 EDF sheds 3 of the 10 requests).

Generated tokens, ``wave_log`` and ``qos_stats`` must be equal.  The one
escape: at a request's first differing token the JAX logits' top-2
margin must be below 1e-5 (a tie broken by fp32 rounding, as
``tests/test_torch_engine.py`` allows for Q-values); the request's later
tokens then follow different histories and are not compared.  A
sliding-window config (h2o-danube's smoke window is 16) keeps a
behaviour of the reference: a wave whose prompts are longer than the
window gives a prefill cache longer than the windowed ``init_cache``,
and both engines raise the same "cache merge mismatch"; the tokens are
then compared on a second request set whose prompts fit the window.  A
frontend config's engines both send all-zero ``frontend_embeds``
(``tests/test_torch_encdec.py`` pins what follows from that).  The
port's launcher is run at its smoke size on the CPU too; like the JAX
launcher it refuses an encoder-decoder config.
"""
import functools
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import model_api as jax_model_api
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding import unbox
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as T
from repro_torch.models.api import model_api
from repro_torch.serve.engine import (Request, ServeEngine, make_prefill_step,
                                     make_serve_step, sample_token)
from repro_torch.serve.policy import power_of_two_bucket


def _requests(cls, vocab, seed=3, max_prompt=29):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(10):
        plen = int(rng.integers(3, max_prompt + 1))
        out.append(cls(uid=uid,
                       prompt=rng.integers(1, vocab, plen).astype(np.int32),
                       max_new_tokens=int(rng.choice([4, 8, 12]))))
    return out


def _recording(eng):
    """Wrap the JAX engine's jitted prefill / decode so every step's last
    logits are kept: waves[w][k] is step k of wave w (k = 0 the prefill)."""
    waves = []
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(p, b):
        out = prefill(p, b)
        waves.append([np.asarray(out[0][:, -1], np.float64)])
        return out

    def rec_decode(p, c, t, pos):
        out = decode(p, c, t, pos)
        waves[-1].append(np.asarray(out[0][:, -1], np.float64))
        return out

    eng._prefill, eng._decode = rec_prefill, rec_decode
    return waves


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """The fp32 smoke config's JAX api and initial parameters, shared by
    the tests of an arch (so the engines reuse the jitted steps)."""
    cfg = replace(jax_smoke_config(arch), dtype="float32")
    api = jax_model_api(cfg)
    return api, jax.jit(lambda k: unbox(api.init(k)))(jax.random.PRNGKey(0))


def _engines(arch, qos, scale, max_prompt=29):
    """Both engines on the arch's fp32 smoke config with the same weights
    and requests; returns them and the JAX engine's recorded logits."""
    api_j, params_j = _jax_model(arch)
    cfg_t = replace(get_smoke_config(arch), dtype="float32")
    params_t = T.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    kw = dict(slots=4, max_seq=64, qos=qos, deadline_scale=scale)
    eng_j = JaxServeEngine(api_j, params_j, **kw)
    eng_t = ServeEngine(model_api(cfg_t), params_t, device="cpu", **kw)
    logits = _recording(eng_j)
    for r in _requests(JaxRequest, cfg_t.vocab_size, max_prompt=max_prompt):
        eng_j.submit(r)
    for r in _requests(Request, cfg_t.vocab_size, max_prompt=max_prompt):
        eng_t.submit(r)
    return eng_j, eng_t, logits


@pytest.mark.parametrize("qos,scale", [("fifo", 1.0), ("edf", 0.6),
                                       ("edf", 0.4)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_engine_matches_jax(arch, qos, scale):
    eng_j, eng_t, logits = _engines(arch, qos, scale)
    window = T._attn_window(get_smoke_config(arch))
    if window is not None and max(len(r.prompt) for r in eng_j.queue) \
            > window:
        with pytest.raises(ValueError, match="cache merge mismatch") as ej:
            eng_j.run_until_done()
        with pytest.raises(ValueError, match="cache merge mismatch") as et:
            eng_t.run_until_done()
        assert str(et.value) == str(ej.value)
        assert eng_t.wave_log == eng_j.wave_log
        eng_j, eng_t, logits = _engines(arch, qos, scale, max_prompt=window)
    eng_j.run_until_done()
    eng_t.run_until_done()

    assert eng_t.wave_log == eng_j.wave_log
    assert eng_t.qos_stats() == eng_j.qos_stats()
    assert eng_t.steps_executed == eng_j.steps_executed
    assert [r.uid for r in eng_t.dead_letter] == \
        [r.uid for r in eng_j.dead_letter]
    where = {uid: (w, slot) for w, uids in enumerate(eng_j.wave_log)
             for slot, uid in enumerate(uids)}
    mine = {r.uid: r.generated for r in eng_t.finished}
    assert sorted(mine) == sorted(r.uid for r in eng_j.finished)
    for r in eng_j.finished:
        got = mine[r.uid]
        assert len(got) == len(r.generated)
        diff = [k for k, (a, b) in enumerate(zip(got, r.generated)) if a != b]
        if diff:
            w, slot = where[r.uid]
            top2 = np.sort(logits[w][diff[0]][slot])[-2:]
            assert top2[1] - top2[0] < 1e-5, \
                f"request {r.uid} token {diff[0]}: {got} vs {r.generated}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_serves_smoke_config_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5",
            "--max-new", "6"]
    rc = serve_launch.main(argv)
    out = capsys.readouterr().out
    if get_smoke_config(arch).is_encoder_decoder:
        # the JAX launcher's refusal, word for word
        from repro.launch.serve import main as jax_main
        assert jax_main(argv[:-6]) == rc == 1
        assert capsys.readouterr().out == out == \
            "serve launcher currently targets decoder-only archs\n"
        return
    assert rc == 0
    assert "served 5 requests, 30 tokens" in out


def test_serve_steps_match_the_engine_model():
    """make_prefill_step / make_serve_step (greedy, and sampled at
    temperature 0) give the api's logits and their argmax token."""
    import torch
    api_j, params_j = _jax_model("stablelm-1.6b")
    api = model_api(replace(get_smoke_config("stablelm-1.6b"),
                            dtype="float32"))
    params = T.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    tokens = torch.tensor(np.random.default_rng(4).integers(1, 512, (2, 9)),
                          dtype=torch.int32)
    logits, cache = make_prefill_step(api)(params, {"tokens": tokens})
    want, _ = api.prefill(params, {"tokens": tokens})
    assert torch.equal(logits, want)
    full = api.init_cache(2, 16)
    for key, entry in full.items():
        for z, c in zip(entry, cache[key]):
            z[:, :, : c.shape[2]] = c
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    greedy, lg, _ = make_serve_step(api)(params, full, tok, 9)
    assert torch.equal(greedy[:, 0], lg[:, -1].argmax(-1).to(torch.int32))
    full2 = api.init_cache(2, 16)
    for key, entry in full2.items():
        for z, c in zip(entry, cache[key]):
            z[:, :, : c.shape[2]] = c
    sampled, _, _ = make_serve_step(api, greedy=False, temperature=0.0)(
        params, full2, tok, 9, torch.Generator())
    assert torch.equal(sampled, greedy)


def test_sample_token_greedy_and_topk():
    import torch
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [5.0, 1.0, 0.0, 4.0]])
    assert sample_token(logits, temperature=0.0).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    draws = {int(sample_token(logits, gen, temperature=1.0, top_k=2)[1])
             for _ in range(50)}
    assert draws <= {0, 3}


def test_power_of_two_bucket_matches_jax():
    from repro.serve.policy import power_of_two_bucket as jax_bucket
    for n in (0, 1, 5, 16, 17, 1000):
        for m in (1, 16, 64):
            assert power_of_two_bucket(n, m) == jax_bucket(n, m)
    with pytest.raises(ValueError):
        power_of_two_bucket(5, 0)


def test_policy_and_deadline_budget_match_jax():
    from repro.core.tasks import token_deadline_budget as jax_budget
    from repro.serve.policy import QoSPolicy as JaxQoSPolicy
    from repro_torch.core.tasks import token_deadline_budget
    from repro_torch.serve.policy import QoSPolicy
    for args in ((5, 8), (0, 0, 0.5), (100, 3, 2.0, 1.5)):
        assert token_deadline_budget(*args) == jax_budget(*args)
    slacks = [3.0, -1.0, None, 0.5, 7.25]
    for policy in ("edf", "fifo"):
        mine = QoSPolicy(policy=policy, aging_credit=2.0)
        ref = JaxQoSPolicy(policy=policy, aging_credit=2.0)
        assert mine.miss_stats(slacks, 2) == ref.miss_stats(slacks, 2)
        assert mine.eff_deadline(10.0, 3) == ref.eff_deadline(10.0, 3)
        assert mine.should_shed(4.0, 3.0, 6.5) == ref.should_shed(4.0, 3.0,
                                                                  6.5)
