"""The port's scalar serving layer in analytical mode vs the JAX package's.

Analytical-mode engines (`cfg=None`: the LCG token stream, no model, no
tensor) of both packages run the same scenarios: the engine- and
router-level cases of tests/serving/test_router_admission.py,
test_semantic.py, test_disagg.py and test_truncation.py, the trace
samplers, and a hypothesis property over random submit / step / preempt /
shrink / advance_to sequences.  Each asserts the reference test's own
expectations on the port and exact equality with the reference: every
meter field, `stats()`, the slot arrays, and each request's pool, times,
counts and tags.  Where the reference asserts a bad ladder, the port raises
ValueError.
"""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import serving as JS
from repro.core import profiles as JP
from repro.core import workloads as JW
from repro.core.disagg import HANDOFF_J_PER_BYTE
from repro.core.modelspec import LLAMA31_8B as J_LLAMA8B
from repro.core.modelspec import LLAMA31_70B as J_LLAMA70B
from repro_torch import serving as PS
from repro_torch.core import profiles as P
from repro_torch.core import workloads as W
from repro_torch.core.modelspec import LLAMA31_8B, LLAMA31_70B
from repro_torch.serving import engine as port_engine

STREAMED = LLAMA31_70B.streamed_params
PKGS = ((JS, JP), (PS, P))      # (serving, core.profiles): reference, port
REQ_FIELDS = ("rid", "pool", "first_token_time", "finish_time",
              "n_generated", "preemptions", "escalations", "ready_time",
              "prefill_done", "misrouted", "escalate_at", "generated")
SLOT_ARRAYS = ("pos", "tokens", "gen_count", "m_gen", "max_new",
               "prefill_left", "escalate_at", "_active")
REQ_LISTS = ("completed", "overflowed", "escalated", "handoff", "relayed")


def _req(pkg, rid, plen, out, pred=None, t=0.0):
    return pkg.Request(rid=rid, prompt=np.zeros(plen, np.int64),
                       max_new_tokens=out, arrival_time=t,
                       predicted_output=pred)


def _meter_fields(meter):
    return {f.name: getattr(meter, f.name)
            for f in dataclasses.fields(meter) if f.name != "profile"}


def _req_state(r):
    return tuple(getattr(r, f) for f in REQ_FIELDS)


def assert_same_engine(jeng, eng):
    """Every port meter field, stats(), the slot arrays, the queue, the
    counters and every request list equal the reference's exactly."""
    jm = _meter_fields(jeng.meter)
    for name, value in _meter_fields(eng.meter).items():
        assert value == jm[name], name
    assert eng.stats() == jeng.stats()
    for name in SLOT_ARRAYS:
        np.testing.assert_array_equal(getattr(eng, name),
                                      getattr(jeng, name), err_msg=name)
    assert [_req_state(r) for r in eng.queue] \
        == [_req_state(r) for r in jeng.queue]
    assert [_req_state(r) if r else None for r in eng.slots] \
        == [_req_state(r) if r else None for r in jeng.slots]
    for name in REQ_LISTS:
        assert [_req_state(r) for r in getattr(eng, name)] \
            == [_req_state(r) for r in getattr(jeng, name)], name
    assert (eng.preempted, eng.n_escalated, eng.slot_seconds,
            eng.prefill_chunk, eng.occupancy) \
        == (jeng.preempted, jeng.n_escalated, jeng.slot_seconds,
            jeng.prefill_chunk, jeng.occupancy)


def _both(fn):
    """fn(serving, profiles) run on the reference and on the port."""
    return [fn(pkg, prof) for pkg, prof in PKGS]


# --- router admission (tests/serving/test_router_admission.py) -----------

def _pool(pkg, prof, name, window):
    return pkg.PoolEngine(None, None, window=window,
                          profile=prof.H100_LLAMA70B, n_slots=4, name=name,
                          streamed_params=70e9)


def _router(pkg, prof, kind, *, b_short=4096, gamma=2.0, **kw):
    if kind == "homo":
        pools = {"only": _pool(pkg, prof, "only", 256)}
        ladder = [("only", math.inf)]
    else:
        pools = {"short": _pool(pkg, prof, "short", 64),
                 "long": _pool(pkg, prof, "long", 256)}
        boundary = float(b_short) if kind == "two_pool" \
            else float(int(gamma * b_short))
        ladder = [("short", boundary), ("long", math.inf)]
    if kind == "two_pool":
        kw.setdefault("metric_kind", "prompt_plus_p99")
    return pkg.ContextRouter(pools, pkg.RouterPolicy(
        kind=kind, b_short=b_short, gamma=gamma, ladder=ladder, **kw))


def _k3_router(pkg, prof):
    pools = {"p0": _pool(pkg, prof, "p0", 128),
             "p1": _pool(pkg, prof, "p1", 512),
             "p2": _pool(pkg, prof, "p2", 2048)}
    ladder = [("p0", 64.0), ("p1", 256.0), ("p2", math.inf)]
    return pkg.ContextRouter(pools, pkg.RouterPolicy(kind="multipool",
                                                     ladder=ladder))


# name -> (router factory, [(plen, out, predicted)], expected roles)
ADMISSION_CASES = {
    "homo": (lambda pkg, prof: _router(pkg, prof, "homo", b_short=32),
             [(1, 1, None), (1000, 1000, None)], ["only", "only"]),
    "two_pool_boundary": (
        lambda pkg, prof: _router(pkg, prof, "two_pool", b_short=32,
                                  p99_output=10),
        [(22, 1, None), (23, 1, None), (22, 500, None)],
        ["short", "long", "short"]),
    "two_pool_p99_margin_edge": (
        lambda pkg, prof: _router(pkg, prof, "two_pool", b_short=32,
                                  p99_output=0),
        [(32, 1, None), (33, 1, None)], ["short", "long"]),
    "fleetopt_gamma_b_short": (
        lambda pkg, prof: _router(pkg, prof, "fleetopt", b_short=32,
                                  gamma=2.0),
        [(54, 10, None), (55, 10, None)], ["short", "long"]),
    "fleetopt_gamma_one": (
        lambda pkg, prof: _router(pkg, prof, "fleetopt", b_short=32,
                                  gamma=1.0),
        [(22, 10, None), (23, 10, None)], ["short", "long"]),
    "fleetopt_on_prediction": (
        lambda pkg, prof: _router(pkg, prof, "fleetopt", b_short=32,
                                  gamma=2.0),
        [(30, 500, 30), (30, 5, 40)], ["short", "long"]),
    "multipool_boundaries": (
        _k3_router,
        [(32, 32, None), (33, 32, None), (128, 128, None), (129, 128, None),
         (10_000, 1, None)], ["p0", "p1", "p1", "p2", "p2"]),
    "multipool_on_prediction": (
        _k3_router, [(30, 500, 30), (30, 5, 400)], ["p0", "p2"]),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_ladders_route_like_reference(case):
    make, reqs, want = ADMISSION_CASES[case]

    def run(pkg, prof):
        router = make(pkg, prof)
        routes = [router.route(_req(pkg, i, p, o, pred))
                  for i, (p, o, pred) in enumerate(reqs)]
        return routes, {n: [r.rid for r in e.queue]
                        for n, e in router.pools.items()}

    jres, res = _both(run)
    assert res == jres
    assert res[0] == want


def test_unknown_policy_kind_raises():
    for pkg, prof in PKGS:
        r = _router(pkg, prof, "homo")
        r.policy = pkg.RouterPolicy(kind="nope")
        with pytest.raises(ValueError):
            r.route(_req(pkg, 0, 1, 1))


BAD_LADDERS = {
    "no_ladder": (lambda pkg, prof: {"p0": _pool(pkg, prof, "p0", 128)},
                  None, ValueError),
    "descending": (_k3_router, [("p0", 256.0), ("p1", 64.0),
                                ("p2", math.inf)], AssertionError),
    "last_not_infinite": (_k3_router, [("p0", 64.0), ("p1", 256.0)],
                          AssertionError),
    "unknown_role": (lambda pkg, prof: {"p0": _pool(pkg, prof, "p0", 128)},
                     [("nope", math.inf)], AssertionError),
}


@pytest.mark.parametrize("case", sorted(BAD_LADDERS))
def test_bad_ladders_are_refused(case):
    make, ladder, ref_exc = BAD_LADDERS[case]
    for (pkg, prof), exc in zip(PKGS, (ref_exc, ValueError)):
        built = make(pkg, prof)
        pools = built.pools if isinstance(built, pkg.ContextRouter) \
            else built
        with pytest.raises(exc):
            pkg.ContextRouter(pools, pkg.RouterPolicy(kind="multipool",
                                                      ladder=ladder))


# --- semantic routing (tests/serving/test_semantic.py) -------------------

def _semantic_pools(pkg, prof):
    return {"small": pkg.PoolEngine(
                None, None, window=64, profile=prof.H100_LLAMA70B,
                n_slots=4, streamed_params=8.03e9),
            "large": pkg.PoolEngine(
                None, None, window=4096, profile=prof.H100_LLAMA70B,
                n_slots=4, streamed_params=STREAMED)}


def _semantic_router(pkg, prof, **kw):
    return pkg.ContextRouter(_semantic_pools(pkg, prof), pkg.RouterPolicy(
        kind="semantic", b_short=64, flip=("small", "large"),
        ladder=[("small", 64.0), ("large", math.inf)], **kw))


def test_semantic_routes_by_predicted_total_at_zero_misroute():
    def run(pkg, prof):
        r = _semantic_router(pkg, prof)
        out = [r.route(_req(pkg, 0, 32, 500, pred=32)),
               r.route(_req(pkg, 1, 33, 1, pred=32))]
        for rid in range(50):
            req = _req(pkg, 100 + rid, 10, 10, pred=10)
            r.route(req)
            out.append((req.misrouted, req.escalate_at))
        return out

    jres, res = _both(run)
    assert res == jres
    assert res[:2] == ["small", "large"]
    assert set(res[2:]) == {(False, None)}


def test_misroute_flip_tags_only_large_into_small():
    def run(pkg, prof):
        r = _semantic_router(pkg, prof, misroute_rate=0.5, detect_tokens=7,
                             misroute_seed=3)
        out = []
        for rid in range(400):
            req = _req(pkg, rid, 100 if rid % 2 else 10, 10, pred=10)
            out.append((r.route(req), req.misrouted, req.escalate_at))
        return out

    jres, res = _both(run)
    assert res == jres
    tagged = flipped_large = 0
    for rid, (dest, misrouted, esc) in enumerate(res):
        truly_large = rid % 2
        if misrouted and truly_large:
            assert (dest, esc) == ("small", 7)
            tagged += 1
        elif misrouted:
            assert (dest, esc) == ("large", None)
            flipped_large += 1
        else:
            assert (dest, esc) == ("large" if truly_large else "small", None)
    assert tagged > 50 and flipped_large > 50


def test_misroute_draw_is_deterministic_and_nested():
    def misrouted(pkg, prof, rate):
        r = _semantic_router(pkg, prof, misroute_rate=rate)
        out = set()
        for rid in range(500):
            req = _req(pkg, rid, 10, 10, pred=10)
            r.route(req)
            if req.misrouted:
                out.add(rid)
        return out

    lo = _both(lambda pkg, prof: misrouted(pkg, prof, 0.1))
    hi = _both(lambda pkg, prof: misrouted(pkg, prof, 0.3))
    assert lo[1] == lo[0] and hi[1] == hi[0]
    assert lo[1] == misrouted(PS, P, 0.1)
    assert lo[1] < hi[1]


def _one_request_engine(pkg, prof, window, plen, out, escalate_at,
                        **kw):
    eng = pkg.PoolEngine(None, None, window=window,
                         profile=prof.H100_LLAMA70B, n_slots=1,
                         streamed_params=STREAMED, **kw)
    req = _req(pkg, 0, plen, out)
    req.escalate_at = escalate_at
    eng.submit(req)
    eng.run_until_drained(max_iters=50)
    return eng, req


def test_engine_escalates_after_detect_tokens_and_backs_out():
    (jeng, _), (eng, req) = _both(
        lambda pkg, prof: _one_request_engine(pkg, prof, 4096, 8, 100, 4))
    assert_same_engine(jeng, eng)
    assert len(eng.completed) == 0
    assert len(eng.escalated) == 1 and eng.n_escalated == 1
    assert req.escalations == 1 and req.preemptions == 1
    assert req.escalate_at is None
    assert req.ready_time is not None and not req.prefill_done
    assert eng.meter.tokens == 0 and eng.meter.joules > 0


def test_short_output_completes_before_detection():
    (jeng, _), (eng, req) = _both(
        lambda pkg, prof: _one_request_engine(pkg, prof, 4096, 8, 3, 32))
    assert_same_engine(jeng, eng)
    assert len(eng.completed) == 1 and not eng.escalated
    assert req.escalations == 0


def test_overflow_eviction_clears_escalation_tag():
    (jeng, _), (eng, _) = _both(
        lambda pkg, prof: _one_request_engine(pkg, prof, 16, 14, 500, 32,
                                              evict_on_overflow=True))
    assert_same_engine(jeng, eng)
    (evicted,) = eng.overflowed
    assert evicted.escalate_at is None
    assert not eng.escalated


def test_prefill_chunk_scales_with_memory_bandwidth():
    for pkg, prof in PKGS:
        assert pkg.scaled_prefill_chunk(prof.H100_LLAMA70B, 512) == 512
        assert pkg.scaled_prefill_chunk(prof.B200_LLAMA70B_FLEET, 512) \
            == round(512 * 8.0e12 / 3.35e12)
        assert pkg.scaled_prefill_chunk(prof.V5E_LLAMA70B, 512) \
            == max(round(512 * 819e9 / 3.35e12), 64)
        assert pkg.scaled_prefill_chunk(prof.V5E_LLAMA70B, 100,
                                        floor=64) == 64
    for name in P.GENERATION_PROFILES:
        for base, floor in ((512, 64), (100, 64), (2048, 16)):
            assert PS.scaled_prefill_chunk(P.GENERATION_PROFILES[name],
                                           base, floor) \
                == JS.scaled_prefill_chunk(JP.GENERATION_PROFILES[name],
                                           base, floor)
        for chunk in (None, 0, 128):
            for phase in ("decode", "prefill"):
                assert PS.resolve_prefill_chunk(
                    P.GENERATION_PROFILES[name], chunk, phase) \
                    == JS.resolve_prefill_chunk(
                        JP.GENERATION_PROFILES[name], chunk, phase)


def test_semantic_fleet_escalates_and_backs_out_like_reference():
    """A misrouted stream through both rungs, escalations re-served in the
    large pool: every request completes once, the metered tokens equal
    the completed requests' n_generated - 1, and both pools equal the
    reference's."""
    def run(pkg, prof):
        r = pkg.ContextRouter(
            {"small": pkg.PoolEngine(None, None, window=256,
                                     profile=prof.H100_LLAMA70B, n_slots=4,
                                     name="small", streamed_params=8.03e9),
             "large": pkg.PoolEngine(None, None, window=4096,
                                     profile=prof.H100_LLAMA70B, n_slots=2,
                                     name="large",
                                     streamed_params=STREAMED)},
            pkg.RouterPolicy(kind="semantic", b_short=128,
                             flip=("small", "large"), misroute_rate=0.3,
                             misroute_seed=5, detect_tokens=8,
                             ladder=[("small", 128.0), ("large", math.inf)]))
        reqs = pkg.synthetic_requests(JW.AZURE, 40, 100, seed=2,
                                      max_total=400)
        for q in reqs:
            r.route(q)
        small, large = r.pools["small"], r.pools["large"]
        small.run_until_drained()
        for q in small.escalated:
            large.submit(q)
        large.run_until_drained()
        return small, large, r.report()

    (jsmall, jlarge, jrep), (small, large, rep) = _both(run)
    assert_same_engine(jsmall, small)
    assert_same_engine(jlarge, large)
    assert rep == jrep
    done = [q.rid for q in small.completed + large.completed]
    assert sorted(done) == list(range(40))
    assert small.n_escalated >= 1
    assert small.meter.tokens + large.meter.tokens \
        == sum(q.n_generated - 1 for q in small.completed + large.completed)


# --- prefill phase and KV handoff (tests/serving/test_disagg.py) ---------

def test_prefill_phase_engine_hands_off_without_decoding():
    def run(pkg, prof):
        eng = pkg.PoolEngine(None, None, window=4096,
                             profile=prof.H100_LLAMA70B, n_slots=2,
                             streamed_params=STREAMED, phase="prefill",
                             prefill_chunk=128)
        for i in range(3):
            eng.submit(_req(pkg, i, 256, 5))
        eng.run_until_drained(max_iters=500)
        return eng

    jeng, eng = _both(run)
    assert_same_engine(jeng, eng)
    assert len(eng.completed) == 0
    assert len(eng.handoff) == 3 and len(eng.relayed) == 3
    for r in eng.handoff:
        assert r.prefill_done
        assert r.n_generated == 1 and len(r.generated) == 1
        assert r.first_token_time > 0
        assert r.ready_time == r.first_token_time
    assert eng.meter.tokens == 0
    assert eng.meter.prefill_tokens == 3 * 256
    assert eng.meter.prefill_joules == pytest.approx(eng.meter.joules)
    assert eng.decode_steps == 0


def test_prefill_phase_is_fifo_across_slot_recycling():
    def run(pkg, prof):
        eng = pkg.PoolEngine(None, None, window=8192,
                             profile=prof.H100_LLAMA70B, n_slots=2,
                             streamed_params=STREAMED, phase="prefill",
                             prefill_chunk=128, respect_arrival=True)
        for i, (plen, t) in enumerate(((64, 0.0), (4096, 0.0),
                                       (4096, 0.001))):
            eng.submit(_req(pkg, i, plen, 1, t=t))
        eng.run_until_drained(max_iters=2000)
        return eng

    jeng, eng = _both(run)
    assert_same_engine(jeng, eng)
    done = {r.rid: r.first_token_time for r in eng.relayed}
    assert done[0] < done[1] < done[2]


def test_prefill_phase_defaults_unchunked_zero_to_a_real_chunk():
    def run(pkg, prof):
        eng = pkg.PoolEngine(None, None, window=4096,
                             profile=prof.H100_LLAMA70B, n_slots=1,
                             streamed_params=STREAMED, phase="prefill",
                             prefill_chunk=0)
        assert eng.prefill_chunk == 512
        eng.submit(_req(pkg, 0, 64, 1))
        eng.run_until_drained(max_iters=50)
        return eng

    jeng, eng = _both(run)
    assert_same_engine(jeng, eng)
    assert len(eng.relayed) == 1


def test_prefill_phase_rejects_model_mode():
    for pkg, prof in PKGS:
        with pytest.raises(ValueError):
            pkg.PoolEngine(object(), object(), window=64,
                           profile=prof.H100_LLAMA70B, phase="prefill")
        with pytest.raises(ValueError):
            pkg.PoolEngine(None, None, window=64,
                           profile=prof.H100_LLAMA70B,
                           streamed_params=STREAMED, phase="nope")
        with pytest.raises(ValueError):
            pkg.PoolEngine(None, None, window=64,
                           profile=prof.H100_LLAMA70B)


def test_prefilled_admission_skips_prefill_charge():
    def run(pkg, prof):
        eng = pkg.PoolEngine(None, None, window=4096,
                             profile=prof.H100_LLAMA70B, n_slots=2,
                             streamed_params=STREAMED)
        req = _req(pkg, 0, 100, 6)
        req.prefill_done = True
        req.generated = [7]
        req.n_generated = 1
        req.first_token_time = 0.123
        eng.submit(req)
        eng.run_until_drained(max_iters=100)
        return eng, req

    (jeng, _), (eng, req) = _both(run)
    assert_same_engine(jeng, eng)
    assert len(eng.completed) == 1
    assert req.n_generated == 6
    assert req.first_token_time == 0.123
    assert eng.meter.prefill_joules == 0.0
    assert eng.meter.prefill_tokens == 0
    assert eng.meter.tokens == 5


def test_prefill_pool_hands_off_to_a_decode_pool_like_reference():
    """A prefill-phase pool's outbox admitted by a decode pool (timed
    arrivals and ready times respected) with the handoff charged to it."""
    def run(pkg, prof):
        pre = pkg.PoolEngine(None, None, window=4096,
                             profile=prof.H100_LLAMA70B, n_slots=3,
                             streamed_params=STREAMED, phase="prefill",
                             prefill_chunk=200, respect_arrival=True)
        dec = pkg.PoolEngine(None, None, window=4096,
                             profile=prof.H100_LLAMA70B, n_slots=2,
                             streamed_params=STREAMED, respect_arrival=True,
                             rng_seed=3, vocab=1000)
        for r in pkg.synthetic_requests(JW.AZURE, 12, 50, seed=4,
                                        max_total=1500):
            pre.submit(r)
        pre.run_until_drained()
        for r in pre.handoff:
            dec.meter.charge_handoff(1e6 * r.prompt_len, start_s=r.ready_time,
                                     duration_s=1e-3,
                                     j_per_byte=HANDOFF_J_PER_BYTE)
            dec.submit(r)
        dec.run_until_drained()
        return pre, dec

    (jpre, jdec), (pre, dec) = _both(run)
    assert_same_engine(jpre, pre)
    assert_same_engine(jdec, dec)
    assert len(dec.completed) == 12 and dec.meter.idle_joules > 0
    assert dec.meter.handoff_joules > 0


@pytest.mark.parametrize("window", [(0.0, math.inf), (0.0, 0.5),
                                    (0.25, 0.75), (2.0, 3.0)])
def test_charge_handoff_prorates_measurement_window(window):
    e0 = 1e9 * HANDOFF_J_PER_BYTE
    meters = []
    for pkg, prof in PKGS:
        m = pkg.EnergyMeter(prof.H100_LLAMA70B)
        m.measure_t0, m.measure_t1 = window
        e = m.charge_handoff(1e9, start_s=0.0, duration_s=1.0,
                             j_per_byte=HANDOFF_J_PER_BYTE)
        m.charge_handoff(5e8, start_s=0.5, duration_s=0.0,
                         j_per_byte=HANDOFF_J_PER_BYTE)
        assert e == pytest.approx(e0)
        assert m.sim_time_s == 0.0
        meters.append(m)
    jm, m = meters
    assert _meter_fields(m) == {k: v for k, v in _meter_fields(jm).items()
                                if k in _meter_fields(m)}
    if window == (0.0, 0.5):
        assert m.m_handoff_joules == pytest.approx(0.5 * e0 + 0.5 * e0)


def test_energy_meter_all_charges_match_reference():
    """Decode, prefill, idle and handoff charges across a measurement
    window: every field of the port's meter equals the reference's."""
    meters = []
    for pkg, prof in PKGS:
        m = pkg.EnergyMeter(prof.B200_LLAMA70B)
        m.measure_t0, m.measure_t1 = 0.02, 0.3
        m.dispatch_s = 1e-3
        for i in range(60):
            m.charge_decode_step(1 + i % 23, 50.0 * i)
            if i % 4 == 0:
                m.charge_prefill(41 * i, overlap_s=2e-3,
                                 streamed_params=8e9)
            if i % 7 == 0:
                m.charge_idle(0.013 * (i % 3))
            if i % 5 == 0:
                m.charge_handoff(3e7 * i, start_s=m.sim_time_s - 0.01,
                                 duration_s=0.02 * (i % 2),
                                 j_per_byte=HANDOFF_J_PER_BYTE)
        meters.append(m)
    jm, m = meters
    assert set(_meter_fields(m)) <= set(_meter_fields(jm))
    for name, value in _meter_fields(m).items():
        assert value == getattr(jm, name), name
    assert m.tok_per_watt == jm.tok_per_watt


# --- drain truncation (tests/serving/test_truncation.py) ----------------

def _truncation_reqs(pkg):
    return [pkg.Request(rid=i, prompt=np.broadcast_to(np.int64(0), (700,)),
                        max_new_tokens=60, arrival_time=0.01 * i)
            for i in range(40)]


def test_scalar_engine_raises_on_truncated_drain():
    def run(pkg, prof):
        eng = pkg.PoolEngine(None, None, profile=prof.H100_LLAMA70B,
                             streamed_params=STREAMED, window=4096,
                             prefill_chunk=256, respect_arrival=True)
        for r in _truncation_reqs(pkg):
            eng.submit(r)
        with pytest.raises(pkg.DrainTruncatedError, match="max_iters=3"):
            eng.run_until_drained(max_iters=3)
        eng.run_until_drained(max_iters=200_000)
        assert not eng.busy
        return eng

    jeng, eng = _both(run)
    assert_same_engine(jeng, eng)


def test_router_propagates_truncation():
    for pkg, prof in PKGS:
        pool = pkg.PoolEngine(None, None, profile=prof.H100_LLAMA70B,
                              streamed_params=STREAMED, window=8192,
                              prefill_chunk=256, respect_arrival=True,
                              name="only")
        router = pkg.ContextRouter({"only": pool}, pkg.RouterPolicy(
            kind="homo", ladder=[("only", math.inf)]))
        with pytest.raises(pkg.DrainTruncatedError):
            router.run(_truncation_reqs(pkg), max_iters=3)


# --- trace samplers ------------------------------------------------------

@pytest.mark.parametrize("workload", sorted(W.WORKLOADS))
def test_trace_samplers_equal_reference(workload):
    wl, jwl = W.WORKLOADS[workload], JW.WORKLOADS[workload]
    for n, seed, max_total, rate in ((16, 0, 4096, None),
                                     (300, 5, 1024, 50.0)):
        assert PS.sample_trace(wl, n, seed=seed, max_total=max_total,
                               arrival_rate=rate) \
            == JS.request.sample_trace(jwl, n, seed=seed,
                                       max_total=max_total,
                                       arrival_rate=rate)
        got = PS.synthetic_requests(wl, n, 77, seed=seed,
                                    max_total=max_total)
        want = JS.synthetic_requests(jwl, n, 77, seed=seed,
                                     max_total=max_total)
        assert [(r.rid, r.max_new_tokens, r.arrival_time) for r in got] \
            == [(r.rid, r.max_new_tokens, r.arrival_time) for r in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.prompt, b.prompt)
    prof = W.DiurnalProfile(peak_rate=40.0, day_s=120.0)
    jprof = JW.DiurnalProfile(peak_rate=40.0, day_s=120.0)
    for t_end, seed in ((60.0, 0), (250.0, 3)):
        assert PS.sample_diurnal_trace(wl, prof, t_end, seed=seed,
                                       max_total=2048) \
            == JS.sample_diurnal_trace(jwl, jprof, t_end, seed=seed,
                                       max_total=2048)


def test_latency_percentile_arrays_equal_reference():
    rng = np.random.default_rng(0)
    arrival = rng.uniform(0, 1, 50)
    first = arrival + rng.uniform(-0.1, 0.5, 50)
    finish = first + rng.uniform(-0.2, 2.0, 50)
    n_gen = rng.integers(0, 20, 50)
    for strict in (False, True):
        for k in (0, 1, 50):
            got = PS.request.latency_percentiles_arrays(
                arrival[:k], first[:k], finish[:k], n_gen[:k],
                strict_keys=strict)
            want = JS.request.latency_percentiles_arrays(
                arrival[:k], first[:k], finish[:k], n_gen[:k],
                strict_keys=strict)
            assert got.keys() == want.keys()
            np.testing.assert_array_equal(list(got.values()),
                                          list(want.values()))


# --- model registry ------------------------------------------------------

def test_model_registry_equals_reference():
    out = []
    for pkg, prof, small, large in ((JS, JP, J_LLAMA8B, J_LLAMA70B),
                                    (PS, P, LLAMA31_8B, LLAMA31_70B)):
        reg = pkg.ModelProfileRegistry.homogeneous(
            large, prof.H100_LLAMA70B, dispatch_ms=1.5)
        homo = reg.heterogeneous
        reg.bind("small", pkg.ModelBinding(model=small,
                                           profile=prof.B200_LLAMA70B))
        out.append((homo, reg.heterogeneous,
                    reg.streamed_params_by_role(["small", "large"]),
                    reg.for_role("large").dispatch_ms,
                    [reg.for_role(r).kv_bytes_per_instance_token(p)
                     for r in ("small", "large")
                     for p in (None, prof.V5E_LLAMA70B)]))
    assert out[1] == out[0]
    assert out[1][:2] == (False, True)


# --- the analytical engine touches no tensor -----------------------------

class _Refuse:
    def __getattr__(self, name):
        raise AssertionError(f"analytical mode touched {name!r}")


def test_analytical_engine_creates_no_tensor(monkeypatch):
    """With the engine module's torch and model module replaced by objects
    that refuse every attribute, analytical engines still admit, preempt,
    escalate, overflow, hand off and drain; they hold no device."""
    monkeypatch.setattr(port_engine, "torch", _Refuse())
    monkeypatch.setattr(port_engine, "M", _Refuse())
    eng = PS.PoolEngine(None, None, window=64, profile=P.H100_LLAMA70B,
                        n_slots=3, streamed_params=STREAMED,
                        evict_on_overflow=True, prefill_chunk=16)
    rng = np.random.default_rng(1)
    for rid in range(10):
        r = _req(PS, rid, int(rng.integers(5, 40)), int(rng.integers(10, 50)))
        r.escalate_at = 5 if rid % 3 == 0 else None
        eng.submit(r)
    eng.advance_to(0.5)
    for _ in range(4):
        eng.step()
    eng.shrink(1)
    eng.run_until_drained()
    pre = PS.PoolEngine(None, None, window=64, profile=P.H100_LLAMA70B,
                        streamed_params=STREAMED, phase="prefill")
    for r in eng.overflowed + eng.escalated:
        pre.submit(r)
    pre.run_until_drained()
    assert eng.completed and eng.preempted and pre.handoff
    assert eng.overflowed and eng.escalated and eng.meter.idle_joules
    assert eng.cache is None and not hasattr(eng, "device")


# --- property: random operation sequences --------------------------------

_OPS = st.lists(st.one_of(
    st.tuples(st.just("submit"), st.integers(1, 60), st.integers(1, 40),
              st.floats(0.0, 0.05), st.sampled_from([None, 2, 6]),
              st.booleans()),
    st.tuples(st.just("step")),
    st.tuples(st.just("preempt"), st.integers(0, 3)),
    st.tuples(st.just("shrink"), st.integers(0, 3)),
    st.tuples(st.just("advance_to"), st.floats(0.0, 0.5))),
    max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, window=st.sampled_from([32, 64, 256]),
       n_slots=st.integers(1, 4),
       prefill_chunk=st.sampled_from([None, 8, 64]),
       evict=st.booleans(), respect=st.booleans(),
       seed=st.integers(0, 3))
def test_property_port_and_reference_engines_step_identically(
        ops, window, n_slots, prefill_chunk, evict, respect, seed):
    engines = [pkg.PoolEngine(None, None, window=window,
                              profile=prof.H100_LLAMA70B, n_slots=n_slots,
                              streamed_params=STREAMED,
                              prefill_chunk=prefill_chunk,
                              evict_on_overflow=evict,
                              respect_arrival=respect, rng_seed=seed,
                              vocab=97)
               for pkg, prof in PKGS]
    rid, t = 0, 0.0
    for op in ops:
        if op[0] == "submit":
            t += op[3]      # arrivals in submission order, as a queue is
        for (pkg, _), eng in zip(PKGS, engines):
            if op[0] == "submit":
                _, plen, out, _, esc, pre = op
                req = _req(pkg, rid, plen, out, t=t)
                req.escalate_at = esc
                if pre:
                    req.prefill_done = True
                    req.generated = [rid % 97]
                    req.n_generated = 1
                eng.submit(req)
            elif op[0] == "step":
                eng.step()
            elif op[0] == "preempt":
                eng.preempt(op[1] % n_slots)
            elif op[0] == "shrink":
                eng.shrink(op[1])
            else:
                eng.advance_to(op[1])
        rid += op[0] == "submit"
        assert_same_engine(*engines)
    for eng in engines:
        eng.run_until_drained()
    assert_same_engine(*engines)
    eng = engines[1]
    assert sorted(r.rid for r in eng.completed + eng.overflowed
                  + eng.escalated) == list(range(rid))
