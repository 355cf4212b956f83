"""The port's open-loop load generator (``repro_torch.serve.loadgen``)
against the JAX package's: twins of the load-generation checks of
``tests/test_serve_load.py``.

Arrival times and the row order come from numpy ``default_rng`` in both
packages, so they are equal as they stand.  The route bodies come from
each package's scenario families; fed the JAX package's family draws
(``tests/test_torch_scenarios.py::_jax_draws``), the port's trace equals
the JAX trace field for field.
"""
import numpy as np
import pytest

from repro.serve import loadgen as loadgen_jax
from repro_torch.serve import loadgen
from test_torch_qos import PLATFORM, route_pair
from test_torch_scenarios import _jax_draws


def _gaps(times: np.ndarray) -> np.ndarray:
    return np.diff(np.concatenate([[0.0], times]))


@pytest.mark.parametrize("kw,match", [
    (dict(process="uniform"), "process"),
    (dict(offered_load=0.0), "offered_load"),
    (dict(process="gamma", burstiness=-1.0), "burstiness"),
    (dict(n_requests=0), "n_requests"),
    (dict(families=("clean", "nope")), "families")])
def test_loadgen_config_validation(kw, match):
    for cfg in (loadgen_jax.LoadGenConfig, loadgen.LoadGenConfig):
        with pytest.raises(ValueError, match=match):
            cfg(**kw)
    assert loadgen.SERVE_FAMILIES == loadgen_jax.SERVE_FAMILIES


def test_arrival_times_deterministic_and_rate():
    kw = dict(process="poisson", n_requests=4000, offered_load=2.0, seed=7)
    t1 = loadgen.arrival_times(loadgen.LoadGenConfig(**kw), 0.01)
    np.testing.assert_array_equal(
        t1, loadgen.arrival_times(loadgen.LoadGenConfig(**kw), 0.01))
    np.testing.assert_array_equal(t1, loadgen_jax.arrival_times(
        loadgen_jax.LoadGenConfig(**kw), 0.01))
    assert np.all(_gaps(t1) >= 0.0)
    assert _gaps(t1).mean() == pytest.approx(0.01, rel=0.1)


def test_gamma_arrivals_same_rate_higher_burstiness():
    """The gamma process keeps its poisson twin's rate but clumps
    arrivals: gap CV^2 tracks ``burstiness`` (poisson's is 1)."""
    n, mean_gap = 6000, 0.02
    gaps = {}
    for name, kw in (("poisson", dict(process="poisson")),
                     ("gamma", dict(process="gamma", burstiness=6.0))):
        cfg = dict(n_requests=n, seed=3, **kw)
        t = loadgen.arrival_times(loadgen.LoadGenConfig(**cfg), mean_gap)
        np.testing.assert_array_equal(t, loadgen_jax.arrival_times(
            loadgen_jax.LoadGenConfig(**cfg), mean_gap))
        gaps[name] = _gaps(t)
    g_p, g_b = gaps["poisson"], gaps["gamma"]
    assert g_b.mean() == pytest.approx(mean_gap, rel=0.15)
    assert g_p.var() / g_p.mean() ** 2 == pytest.approx(1.0, rel=0.2)
    assert g_b.var() / g_b.mean() ** 2 == pytest.approx(6.0, rel=0.3)


@pytest.mark.parametrize("process,n_req,seed", [
    ("poisson", 12, 9), ("gamma", 10, 4), ("poisson", 7, 21)])
def test_generate_matches_jax_with_its_draws(process, n_req, seed):
    base_j, base_t = route_pair(24, 5)
    kw = dict(process=process, n_requests=n_req, offered_load=2.0,
              seed=seed)
    want = loadgen_jax.generate(base_j, PLATFORM.n,
                                loadgen_jax.LoadGenConfig(**kw), 0.05)
    cfg = loadgen.LoadGenConfig(**kw)
    per_family = -(-n_req // len(cfg.families))
    got = loadgen.generate(base_t, PLATFORM.n, cfg, 0.05, draws=_jax_draws(
        seed, cfg.families, per_family, 24, PLATFORM.n))
    assert [(r.arrival, r.family) for r in got] == \
        [(r.arrival, r.family) for r in want]
    for g, w in zip(got, want):
        for f in w.tasks._fields:
            np.testing.assert_array_equal(getattr(g.tasks, f).numpy(),
                                          np.asarray(getattr(w.tasks, f)), f)


def test_generate_trace_deterministic_families_and_load():
    """With the port's own draws: deterministic in the seed, a mix of the
    serving families, sorted arrivals at twice the service rate."""
    _, base = route_pair(24, 5)
    cfg = loadgen.LoadGenConfig(n_requests=12, offered_load=2.0, seed=9)
    tr1 = loadgen.generate(base, PLATFORM.n, cfg, mean_service=0.05)
    tr2 = loadgen.generate(base, PLATFORM.n, cfg, mean_service=0.05)
    assert len(tr1) == 12
    assert [r.arrival for r in tr1] == [r.arrival for r in tr2]
    for a, b in zip(tr1, tr2):
        for f in a.tasks._fields:
            assert np.array_equal(getattr(a.tasks, f).numpy(),
                                  getattr(b.tasks, f).numpy())
    assert [r.arrival for r in tr1] == sorted(r.arrival for r in tr1)
    assert set(r.family for r in tr1) <= set(loadgen.SERVE_FAMILIES)
    assert len(set(r.family for r in tr1)) > 1
    assert _gaps(np.asarray([r.arrival for r in tr1])).mean() < 0.05
