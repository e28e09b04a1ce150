"""Port serving path vs the JAX reference, on the CPU.

The port's `PoolEngine` and the reference's, on the same converted weights
and the same requests, must emit the same token streams and leave identical
`EnergyMeter` counters (the meters see the same (n, L) sequence, so their
float64 sums are equal exactly, not within a tolerance).  The scenarios are
those of tests/serving/test_serving.py, plus chunked prefill.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import profiles as JP
from repro.core import workloads as JW
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro import serving as JS
from repro_torch.configs import get_config
from repro_torch.core import profiles as P
from repro_torch.core import workloads as W
from repro_torch.launch import serve
from repro_torch.models.convert import convert_params
from repro_torch import serving as PS
from repro_torch.serving import (ContextRouter, EnergyMeter, PoolEngine,
                                 Request, RouterPolicy)

METER_FIELDS = ("joules", "prefill_joules", "tokens", "prefill_tokens",
                "sim_time_s", "m_tokens", "m_joules", "m_prefill_joules")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("yi-6b").reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("yi-6b").reduced(), params


def _port_request(r):
    return Request(rid=r.rid, prompt=np.array(r.prompt),
                   max_new_tokens=r.max_new_tokens,
                   arrival_time=r.arrival_time,
                   predicted_output=r.predicted_output)


def _assert_same_engine(jeng, eng, tokens=True):
    """Equal meters, stats and per-request counts and times; and, unless
    `tokens` is False, equal token streams."""
    for f in METER_FIELDS:
        assert getattr(eng.meter, f) == getattr(jeng.meter, f), f
    assert eng.stats() == jeng.stats()
    jdone = {r.rid: r for r in jeng.completed}
    assert sorted(jdone) == sorted(r.rid for r in eng.completed)
    for r in eng.completed:
        j = jdone[r.rid]
        assert not tokens or r.generated == j.generated, r.rid
        assert (r.n_generated, r.first_token_time, r.finish_time) \
            == (j.n_generated, j.first_token_time, j.finish_time)


def _sequential_requests(vocab):
    rng = np.random.default_rng(0)
    return [JS.Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)),
                       max_new_tokens=6)
            for i, n in enumerate((5, 9, 3, 12))]


def _nmax_requests(vocab):
    reqs = JS.synthetic_requests(JW.AZURE, 8, vocab, seed=1, max_total=24)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, 4)
    return reqs


# name -> (requests, engine kwargs)
ENGINE_SCENARIOS = {
    "sequential": (_sequential_requests, dict(window=64, n_slots=2)),
    "sequential_chunked": (_sequential_requests,
                           dict(window=64, n_slots=2, prefill_chunk=4)),
    "nmax_admission": (_nmax_requests, dict(window=32, n_slots=3)),
}


@pytest.mark.parametrize("scenario", sorted(ENGINE_SCENARIOS))
def test_engine_matches_reference_engine(model, scenario):
    jcfg, jparams, cfg, params = model
    make, kw = ENGINE_SCENARIOS[scenario]
    jreqs = make(cfg.vocab)
    reqs = [_port_request(r) for r in jreqs]
    jeng = JS.PoolEngine(jcfg, jparams, profile=JP.H100_LLAMA70B, name="t",
                         **kw)
    eng = PoolEngine(cfg, params, profile=P.H100_LLAMA70B, name="t", **kw)
    for je, e in zip(jreqs, reqs):
        jeng.submit(je)
        eng.submit(e)
    jeng.run_until_drained(max_iters=500)
    eng.run_until_drained(max_iters=500)
    assert len(eng.completed) == len(reqs)
    _assert_same_engine(jeng, eng)
    assert eng.decode_steps > 0


def test_router_policies_route_alike(model):
    jcfg, jparams, cfg, params = model
    ladders = {"fleetopt": dict(kind="fleetopt", b_short=16, gamma=2.0,
                                ladder=[("short", 32.0), ("long", math.inf)]),
               "two_pool": dict(kind="two_pool", b_short=16, p99_output=10,
                                metric_kind="prompt_plus_p99",
                                ladder=[("short", 16.0),
                                        ("long", math.inf)])}
    for kw in ladders.values():
        jr = JS.ContextRouter(
            {n: JS.PoolEngine(jcfg, jparams, window=w,
                              profile=JP.H100_LLAMA70B, n_slots=2, name=n)
             for n, w in (("short", 32), ("long", 128))},
            JS.RouterPolicy(**kw))
        r = ContextRouter(
            {n: PoolEngine(cfg, params, window=w, profile=P.H100_LLAMA70B,
                           n_slots=2, name=n)
             for n, w in (("short", 32), ("long", 128))},
            RouterPolicy(**kw))
        for rid, (plen, out) in enumerate([(10, 8), (100, 8), (5, 8),
                                           (10, 30), (24, 8)]):
            req = JS.Request(rid=rid, prompt=np.arange(plen),
                             max_new_tokens=out)
            assert r.route(_port_request(req)) == jr.route(req)


def test_router_rejects_bad_ladders(model):
    _, _, cfg, params = model
    pools = {"long": PoolEngine(cfg, params, window=32,
                                profile=P.H100_LLAMA70B, n_slots=1)}
    for ladder in ([("short", math.inf)], [("long", 64.0)], None):
        with pytest.raises(ValueError):
            ContextRouter(pools, RouterPolicy(kind="homo", ladder=ladder))


def _homo_and_routed(pkg, cfg, params, profile, reqs):
    """Reports of a homogeneous and a FleetOpt-routed fleet (the
    reference's test_two_pool_beats_homo_on_energy) built from `pkg`."""
    homo = pkg.ContextRouter(
        {"only": pkg.PoolEngine(cfg, params, window=128, profile=profile,
                                n_slots=4, name="only")},
        pkg.RouterPolicy(kind="homo", ladder=[("only", math.inf)]))
    routed = pkg.ContextRouter(
        {"short": pkg.PoolEngine(cfg, params, window=16, profile=profile,
                                 n_slots=16, name="short"),
         "long": pkg.PoolEngine(cfg, params, window=128, profile=profile,
                                n_slots=4, name="long")},
        pkg.RouterPolicy(kind="fleetopt", b_short=8, gamma=2.0,
                         ladder=[("short", 16.0), ("long", math.inf)]))
    return (homo.run([dataclasses.replace(r) for r in reqs], max_iters=500),
            routed.run([dataclasses.replace(r) for r in reqs],
                       max_iters=500))


def test_two_pool_beats_homo_like_reference(model):
    """The paper's claim at miniature scale, with the same reports as the
    reference on the same stream."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(42)
    jreqs = [JS.Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                                   6 if i % 5 else 90),
                        max_new_tokens=5) for i in range(10)]
    jrep = _homo_and_routed(JS, jcfg, jparams, JP.H100_LLAMA70B, jreqs)
    rep_h, rep_r = _homo_and_routed(
        PS, cfg, params, P.H100_LLAMA70B, [_port_request(r) for r in jreqs])
    assert (rep_h, rep_r) == jrep
    assert rep_r["fleet"]["tok_per_watt"] > rep_h["fleet"]["tok_per_watt"]


def test_run_policies_matches_reference_launcher(model):
    """Port `run_policies` vs the reference launcher's build_router +
    ContextRouter.run at the same arguments (the request stream built as
    the reference `serve.main` builds it)."""
    jcfg, jparams, cfg, params = model
    n, b_short, window_long = 8, 24, 192
    res = serve.run_policies(cfg, params, requests=n, b_short=b_short,
                             window_long=window_long)
    lens = JW.WORKLOADS["azure-conv"].sample_requests(n, seed=0) \
        .astype(float)
    scale = (window_long - 8) / float(np.quantile(lens.sum(1), 0.99))
    rng = np.random.default_rng(7)
    base = []
    for i, (p, o) in enumerate(lens * scale):
        p = int(np.clip(p, 1, window_long - 9))
        o = int(np.clip(o, 1, window_long - 8 - p))
        base.append(JS.Request(rid=i, prompt=rng.integers(0, jcfg.vocab,
                                                          size=p),
                               max_new_tokens=o))
    p99 = int(np.quantile([r.max_new_tokens for r in base], 0.99)) + 1
    for policy in serve.POLICIES:
        router = jax_serve.build_router(
            jcfg, jparams, policy, b_short=b_short, window_long=window_long,
            profile=JP.H100_LLAMA70B, p99_output=p99)
        assert res[policy]["report"] == router.run(
            [dataclasses.replace(r) for r in base], max_iters=20000)
        for name, eng in res[policy]["engines"].items():
            _assert_same_engine(router.pools[name], eng)
    gain = serve.fleetopt_gain(res)
    assert gain > 0 and math.isfinite(gain)


def test_energy_meter_matches_reference_meter():
    jm, m = JS.EnergyMeter(JP.H100_LLAMA70B), EnergyMeter(P.H100_LLAMA70B)
    m.measure_t0 = jm.measure_t0 = 0.01
    m.measure_t1 = jm.measure_t1 = 0.05
    for i in range(40):
        for meter in (jm, m):
            meter.charge_decode_step(1 + i % 17, 100.0 * i)
            if i % 3 == 0:
                meter.charge_prefill(37 * i, overlap_s=1e-3,
                                     streamed_params=7e10)
    for f in METER_FIELDS:
        assert getattr(m, f) == getattr(jm, f), f
    assert m.tok_per_watt == jm.tok_per_watt


def test_analytical_copies_equal_reference():
    assert dataclasses.asdict(P.H100_LLAMA70B) \
        == dataclasses.asdict(JP.H100_LLAMA70B)
    b = np.array([0, 0.5, 1, 3, 16, 18.4, 128, 1e4])
    np.testing.assert_array_equal(P.H100_LLAMA70B.power_model.power_w(b),
                                  JP.H100_LLAMA70B.power_model.power_w(b))
    n, L = np.array([1, 4, 64, 256]), np.array([1.0, 512, 8192, 1e5])
    np.testing.assert_array_equal(P.H100_LLAMA70B.roofline.tau_ms(n, L),
                                  JP.H100_LLAMA70B.roofline.tau_ms(n, L))
    for w in (1, 48, 1024, 8192, 2 ** 21):
        assert P.H100_LLAMA70B.n_max(w) == JP.H100_LLAMA70B.n_max(w)
    assert sorted(W.WORKLOADS) == sorted(JW.WORKLOADS)
    for name, wl in W.WORKLOADS.items():
        for n, seed in ((16, 0), (1000, 3)):
            np.testing.assert_array_equal(
                wl.sample_requests(n, seed),
                JW.WORKLOADS[name].sample_requests(n, seed))

