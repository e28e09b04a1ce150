"""The port's serving layer under pressure, in model mode on the CPU.

Preemption (the three cases of tests/serving/test_preemption.py) on yi-6b
and zamba2-2.7b reduced, overflow migration into a long pool with timed
arrivals on yi-6b reduced, and semantic escalation from granite-moe
reduced (the small rung) into llama31-8b reduced (the large rung),
composed as `chip_smoke.py`'s phase 10 composes them.  The reference's
engines run the same steps on the same converted weights; each port engine
must equal its reference twin exactly (token streams, every meter field,
`stats()`, slot arrays, and each request's pool, times, preemptions and
escalations), and an analytical-mode replay of the same traffic with the
model's streamed parameters (`cfg=None`) must leave the same schedule:
meters, stats and per-request times, pools and counts.  Evicted requests
re-prefill into recycled slots, whose rows past the new prompt hold the
longer sequence they held before: their streams must equal an
uninterrupted generation of the same prompt.
"""
import math

import jax
import numpy as np
import pytest

from repro import serving as JS
from repro.configs import get_config as jax_get_config
from repro.core import profiles as JP
from repro.models import model as JM
from repro_torch import serving as PS
from repro_torch.configs import get_config
from repro_torch.core import profiles as P
from repro_torch.models.convert import convert_params
from test_torch_serving_analytical import _meter_fields, assert_same_engine

SCHED_FIELDS = ("rid", "pool", "first_token_time", "finish_time",
                "n_generated", "preemptions", "escalations", "ready_time")


def _load(arch):
    jcfg = jax_get_config(arch).reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(arch).reduced(), params


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _load(arch)
        return cache[arch]
    return get


class Twins:
    """Engines built alike in the reference (model mode), the port (model
    mode) and the port's analytical mode, driven by the same calls."""

    def __init__(self, models, arch, **kw):
        self.jcfg, self.jparams, self.cfg, self.params = models(arch)
        self.kw = dict(profile=P.H100_LLAMA70B, **kw)
        self.ref = JS.PoolEngine(self.jcfg, self.jparams,
                                 **dict(kw, profile=JP.H100_LLAMA70B))
        self.port = PS.PoolEngine(self.cfg, self.params, **self.kw)
        self.ana = PS.PoolEngine(
            None, None, streamed_params=self.cfg.analytical_spec()
            .streamed_params, **self.kw)

    @property
    def engines(self):
        return self.ref, self.port, self.ana

    def submit(self, reqs):
        for e, r in zip(self.engines, reqs):
            e.submit(r)

    def call(self, name, *args, **kw):
        return [getattr(e, name)(*args, **kw) for e in self.engines]

    def check(self):
        assert_same_engine(self.ref, self.port)
        assert_same_schedule(self.port, self.ana)


def _copies(make):
    """(reference, port, port) copies of the requests `make(pkg)` builds."""
    return [make(JS), make(PS), make(PS)]


def assert_same_schedule(eng, ana):
    """A model-mode engine and its analytical twin: equal meters, stats,
    slot positions and counts, and per-request times, pools and counts."""
    assert _meter_fields(eng.meter) == _meter_fields(ana.meter)
    assert eng.stats() == ana.stats()
    for name in ("pos", "gen_count", "m_gen", "max_new", "prefill_left",
                 "escalate_at", "_active"):
        np.testing.assert_array_equal(getattr(eng, name), getattr(ana, name))
    assert eng.decode_steps == ana.decode_steps
    for name in ("completed", "overflowed", "escalated", "queue"):
        assert [tuple(getattr(r, f) for f in SCHED_FIELDS)
                for r in getattr(eng, name)] \
            == [tuple(getattr(r, f) for f in SCHED_FIELDS)
                for r in getattr(ana, name)], name


def _generate(models, arch, prompt, n, window):
    """The port's uninterrupted greedy generation of `prompt`."""
    _, _, cfg, params = models(arch)
    eng = PS.PoolEngine(cfg, params, window=window, profile=P.H100_LLAMA70B,
                        n_slots=1, name="ref")
    eng.submit(PS.Request(rid=0, prompt=np.array(prompt), max_new_tokens=n))
    eng.run_until_drained(max_iters=400)
    return eng.completed[0].generated


# --- preemption (tests/serving/test_preemption.py) ----------------------

PRESSURE_ARCHS = ["yi-6b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", PRESSURE_ARCHS)
def test_preempted_requests_still_complete_correctly(models, arch):
    vocab = models(arch)[2].vocab
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, size=n) for n in (5, 7, 9)]
    want = [_generate(models, arch, p, 6, 48) for p in prompts]
    t = Twins(models, arch, window=48, n_slots=3, name="pressured")
    reqs = _copies(lambda pkg: [pkg.Request(rid=i, prompt=p.copy(),
                                            max_new_tokens=6)
                                for i, p in enumerate(prompts)])
    for trio in zip(*reqs):
        t.submit(trio)
    for _ in range(3):
        t.call("step")
    t.call("shrink", 1)
    assert [e.n_active for e in t.engines] == [1, 1, 1]
    assert [e.preempted for e in t.engines] == [2, 2, 2]
    t.call("run_until_drained", max_iters=400)
    t.check()
    by_rid = {r.rid: r for r in t.port.completed}
    assert len(by_rid) == 3
    for i, expect in enumerate(want):
        assert by_rid[i].generated[:6] == expect[:6], i
    assert sum(r.preemptions for r in reqs[1]) == 2


@pytest.mark.parametrize("arch", PRESSURE_ARCHS)
def test_preemption_costs_energy(models, arch):
    vocab = models(arch)[2].vocab
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, vocab, size=8) for _ in range(4)]

    def run(pressure):
        t = Twins(models, arch, window=48, n_slots=4, name="x")
        for trio in zip(*_copies(lambda pkg: [
                pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=8)
                for i, p in enumerate(prompts)])):
            t.submit(trio)
        for _ in range(4):
            t.call("step")
        if pressure:
            t.call("shrink", 2)
        t.call("run_until_drained", max_iters=400)
        t.check()
        assert len(t.port.completed) == 4
        return t.port.meter.joules / t.port.meter.tokens

    assert run(pressure=True) > run(pressure=False)


@pytest.mark.parametrize("arch", PRESSURE_ARCHS)
def test_latency_percentiles(models, arch):
    vocab = models(arch)[2].vocab
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, 6) for _ in range(5)]
    t = Twins(models, arch, window=48, n_slots=2, name="lat")
    for trio in zip(*_copies(lambda pkg: [
            pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=5)
            for i, p in enumerate(prompts)])):
        t.submit(trio)
    t.call("run_until_drained", max_iters=300)
    t.check()
    s = t.port.stats()
    assert s["ttft_p99_s"] >= s["ttft_p50_s"] >= 0
    assert s["e2e_p99_s"] > s["ttft_p50_s"]


def test_prefilled_admission_is_analytical_only(models):
    _, _, cfg, params = models("yi-6b")
    eng = PS.PoolEngine(cfg, params, window=48, profile=P.H100_LLAMA70B,
                        n_slots=1)
    req = PS.Request(rid=0, prompt=np.arange(5), max_new_tokens=3)
    req.prefill_done, req.generated = True, [1]
    eng.submit(req)
    with pytest.raises(ValueError, match="analytical"):
        eng.step()


# --- overflow migration with timed arrivals -----------------------------

def _fleet(models, arch_by_role, windows, slots, policy_kw, reqs_of,
           evict=(), respect=(), handoff="overflowed"):
    """Route `reqs_of(pkg)` over two pools in each of the three engine
    kinds, drain the first pool, submit its `handoff` list to the second,
    drain that.  Returns {role: Twins}."""
    roles = list(arch_by_role)
    pools = {role: Twins(models, arch_by_role[role], window=windows[role],
                         n_slots=slots[role], name=role,
                         evict_on_overflow=role in evict,
                         respect_arrival=role in respect)
             for role in roles}
    for k, (pkg, reqs) in enumerate(zip((JS, PS, PS), _copies(reqs_of))):
        router = pkg.ContextRouter({role: pools[role].engines[k]
                                    for role in roles},
                                   pkg.RouterPolicy(**policy_kw))
        for r in reqs:
            router.route(r)
    first, second = (pools[role] for role in roles)
    first.call("run_until_drained", max_iters=2000)
    for k, eng in enumerate(second.engines):
        for r in getattr(first.engines[k], handoff):
            eng.submit(r)
    second.call("run_until_drained", max_iters=2000)
    for t in pools.values():
        t.check()
    return pools


def _assert_fleet_invariants(pools, n):
    port = [t.port for t in pools.values()]
    done = [r for e in port for r in e.completed]
    assert sorted(r.rid for r in done) == list(range(n))
    assert sum(e.meter.tokens for e in port) \
        == sum(r.n_generated - 1 for r in done)
    return done


def test_overflow_migration_reserves_in_the_long_pool(models):
    """FleetOpt on predicted output, timed arrivals on both pools: the
    short pool evicts at its window into `overflowed`; the long pool
    re-prefills them into recycled slots and finishes them."""
    vocab = models("yi-6b")[2].vocab
    rng = np.random.default_rng(11)
    lens = [(int(rng.integers(3, 20)), int(rng.integers(2, 30)))
            for _ in range(12)]
    pred = int(np.median([o for _, o in lens]))
    arrivals = np.cumsum(rng.exponential(0.004, len(lens)))
    prompts = [rng.integers(0, vocab, p) for p, _ in lens]

    def reqs_of(pkg):
        return [pkg.Request(rid=i, prompt=prompts[i].copy(),
                            max_new_tokens=o, predicted_output=pred,
                            arrival_time=float(arrivals[i]))
                for i, (_, o) in enumerate(lens)]

    pools = _fleet(
        models, {"short": "yi-6b", "long": "yi-6b"},
        windows={"short": 32, "long": 96}, slots={"short": 3, "long": 2},
        policy_kw=dict(kind="fleetopt", b_short=16, gamma=2.0,
                       ladder=[("short", 32.0), ("long", math.inf)]),
        reqs_of=reqs_of, evict=("short",), respect=("short", "long"))
    short, long_ = pools["short"].port, pools["long"].port
    assert short.overflowed and short.preempted == len(short.overflowed)
    assert long_.meter.idle_joules > 0 and short.meter.idle_joules > 0
    done = _assert_fleet_invariants(pools, len(lens))
    for r in short.overflowed:
        assert r.pool == "long" and r.preemptions == 1
        assert r.generated == _generate(models, "yi-6b", prompts[r.rid],
                                        r.max_new_tokens, 96)
    assert any(r.pool == "short" for r in done)


# --- semantic escalation: granite-moe small, llama31-8b large -----------

SEM_LADDER = [("small", 24.0), ("large", math.inf)]
SEM_LENS = [(4, 3), (6, 10), (30, 12), (9, 6), (25, 20), (12, 5), (5, 14),
            (40, 9), (8, 4), (18, 16), (3, 8), (22, 11)]
SEM_ARRIVALS = np.cumsum(np.random.default_rng(13).exponential(
    0.004, len(SEM_LENS)))


def _sem_policy(seed):
    return dict(kind="semantic", b_short=24, flip=("small", "large"),
                detect_tokens=4, misroute_rate=0.25, misroute_seed=seed,
                ladder=SEM_LADDER)


def _escalating_seed():
    """The first misroute seed under which an analytical replay escalates
    at least one true-large request out of the small pool."""
    for seed in range(100):
        small = PS.PoolEngine(None, None, window=48, profile=P.H100_LLAMA70B,
                              n_slots=4, name="small", streamed_params=1e9,
                              respect_arrival=True)
        router = PS.ContextRouter(
            {"small": small,
             "large": PS.PoolEngine(None, None, window=96,
                                    profile=P.H100_LLAMA70B, n_slots=2,
                                    name="large", streamed_params=8e9,
                                    respect_arrival=True)},
            PS.RouterPolicy(**_sem_policy(seed)))
        for i, (p, o) in enumerate(SEM_LENS):
            router.route(PS.Request(rid=i, prompt=np.zeros(p, np.int64),
                                    max_new_tokens=o,
                                    arrival_time=float(SEM_ARRIVALS[i])))
        small.run_until_drained()
        if small.escalated:
            return seed
    raise AssertionError("no seed escalates")


def test_semantic_escalation_reserves_on_the_large_model(models):
    seed = _escalating_seed()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, p) for p, _ in SEM_LENS]

    def reqs_of(pkg):
        return [pkg.Request(rid=i, prompt=prompts[i].copy(),
                            max_new_tokens=o,
                            arrival_time=float(SEM_ARRIVALS[i]))
                for i, (_, o) in enumerate(SEM_LENS)]

    pools = _fleet(
        models, {"small": "granite-moe-1b-a400m", "large": "llama31-8b"},
        windows={"small": 48, "large": 96}, slots={"small": 4, "large": 2},
        policy_kw=_sem_policy(seed), reqs_of=reqs_of,
        respect=("small", "large"), handoff="escalated")
    small, large = pools["small"].port, pools["large"].port
    assert small.n_escalated >= 1 and small.escalated
    done = _assert_fleet_invariants(pools, len(SEM_LENS))
    assert all(r.misrouted for r in small.escalated)
    for r in small.escalated:
        assert r.pool == "large" and r.escalations == 1
        assert r.escalate_at is None and r.finish_time >= 0
        assert r.generated == _generate(models, "llama31-8b",
                                        prompts[r.rid], r.max_new_tokens, 96)
    assert {r.pool for r in done} == {"small", "large"}
