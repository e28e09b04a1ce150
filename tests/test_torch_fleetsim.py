"""The port's fleet simulator vs the JAX package's numpy twin.

`BatchedPoolEngine`, `FleetSim`, the autoscaler and the disaggregated
fleets of both packages run the same scenarios: the cases of
tests/serving/test_{soa_parity,fleetsim,autoscale}.py and the
FleetSim-level cases of test_disagg.py.  Each asserts the reference test's
own claim on the port, and that the port's reports, meter banks, pool
summaries, schedules and per-request outcomes equal the reference's
exactly (`_plain` compares floats by their bits).  The nine `unconstrained`
rows of benchmarks/results/fleet_sim.json are reproduced field for field,
and engine names the port does not serve (the reference's "jax", and
"torch") raise NotImplementedError everywhere they could be asked for;
the compiled drain the port does serve (`engine="graph"`, ROADMAP A 2c) is
held in tests/test_torch_graph_engine.py.
"""
import copy
import dataclasses
import importlib
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parents[1]


def _pkg(root):
    core = importlib.import_module(f"{root}.core")
    serving = importlib.import_module(f"{root}.serving")
    return SimpleNamespace(
        root=root, core=core, S=serving, fleetsim=serving.fleetsim,
        autoscale=serving.autoscale, topospec=core.topospec,
        profiles=core.profiles, modelspec=core.modelspec,
        workloads=core.workloads, disagg=core.disagg,
        policy=core.autoscale.AutoscalePolicy)


REF, PORT = _pkg("repro"), _pkg("repro_torch")
STREAMED = PORT.modelspec.LLAMA31_70B.streamed_params


def _both(fn):
    """fn(package) on the reference, then on the port."""
    return fn(REF), fn(PORT)


def _plain(x):
    """A cross-package comparable form: dataclasses by their compared
    fields, floats by their bits, arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x) if f.compare})
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_plain(v) for v in x])
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape,
                np.ascontiguousarray(x).tobytes())
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float):
        return ("float", x.hex())
    if x is None or isinstance(x, (bool, int, str)):
        return x
    raise TypeError(f"no plain form for {type(x).__name__}")


def assert_same(ref, port):
    assert _plain(port) == _plain(ref)


REQ_FIELDS = ("rid", "pool", "arrival_time", "first_token_time",
              "finish_time", "n_generated", "preemptions", "escalations",
              "ready_time", "prefill_done", "prefill_role", "misrouted",
              "escalate_at", "generated")
BANK_FIELDS = ("joules", "idle_joules", "prefill_joules", "handoff_joules",
               "handoff_bytes", "m_handoff_bytes", "dispatch_s",
               "dispatch_joules", "m_dispatch_joules", "tokens",
               "prefill_tokens", "sim_time_s", "measure_t0", "measure_t1",
               "m_tokens", "m_joules", "m_prefill_joules", "m_idle_joules",
               "m_handoff_joules", "last_charge_in_window")
ENGINE_ARRAYS = ("pos", "tokens", "gen_count", "m_gen", "max_new",
                 "prefill_left", "escalate_at", "_active", "seeds",
                 "preempted", "n_escalated", "slot_seconds",
                 "m_slot_seconds", "online_from", "online_until")
REQ_LISTS = ("completed", "overflowed", "escalated", "handoff", "relayed")


def _req_state(r):
    return tuple(getattr(r, f) for f in REQ_FIELDS)


def _batched_state(eng):
    """Everything a drained `BatchedPoolEngine` holds, prompts aside."""
    return dict(bank={f: getattr(eng.bank, f) for f in BANK_FIELDS},
                arrays={f: getattr(eng, f) for f in ENGINE_ARRAYS},
                lists={f: [[_req_state(r) for r in lst]
                           for lst in getattr(eng, f)] for f in REQ_LISTS},
                queues=[[_req_state(r) for r in q] for q in eng.queues])


def _sim_state(sim, reqs=()):
    """A run `FleetSim`: report, roll-up counters, every pool's engine
    and summary, the autoscale schedules, and each request's outcome."""
    summaries = {role: {f.name: (getattr(s, f.name) if f.name != "outbox"
                                 else {d: [_req_state(r) for r in rs]
                                       for d, rs in s.outbox.items()})
                        for f in dataclasses.fields(s)}
                 for role, s in sim.summaries.items()}
    return dict(report=sim.report(), order=sim.order,
                counters=(sim.migrations, sim.handoffs, sim.escalations,
                          sim._window),
                engines={role: _batched_state(g.engine)
                         for role, g in sim.groups.items()},
                summaries=summaries, schedules=sim.schedules,
                latency=sim.latency_by_role(),
                reqs=[_req_state(r) for r in reqs])


def _req(pk, rid, plen, out, t=0.0, pred=None, esc=None, pdone=False):
    r = pk.S.Request(rid=rid, prompt=np.broadcast_to(np.int64(0), (plen,)),
                     max_new_tokens=out, arrival_time=t,
                     predicted_output=pred)
    r.escalate_at = esc
    r.prefill_done = pdone
    return r


# --- SoA parity (tests/serving/test_soa_parity.py) -------------------------

def _run_both_engines(pk, streams, **kw):
    """The reference test's `_run_both`: the same per-instance streams
    through N scalar engines and one batched engine of package `pk`."""
    H = pk.profiles.H100_LLAMA70B
    n = len(streams)
    scalars = [pk.S.PoolEngine(None, None, profile=H,
                               streamed_params=STREAMED,
                               rng_seed=11 + 7919 * j, name=f"p#{j}",
                               respect_arrival=True, **kw)
               for j in range(n)]
    batched = pk.S.BatchedPoolEngine(instances=n, profile=H,
                                     streamed_params=STREAMED, rng_seed=11,
                                     name="p", respect_arrival=True, **kw)
    for j, reqs in enumerate(streams):
        for r in reqs:
            scalars[j].submit(copy.copy(r))
            batched.submit(copy.copy(r), j)
    for e in scalars:
        e.run_until_drained(max_iters=200_000)
    batched.run_until_drained(max_iters=200_000)
    return scalars, batched


def _assert_bit_equal(scalars, batched):
    """The reference's claim: each scalar engine equals its batched row."""
    b = batched.bank
    for j, e in enumerate(scalars):
        m = e.meter
        for f in ("joules", "m_joules", "prefill_joules", "m_prefill_joules",
                  "idle_joules", "m_idle_joules", "tokens", "m_tokens",
                  "prefill_tokens", "sim_time_s"):
            assert getattr(m, f) == getattr(b, f)[j], f
        assert e.slot_seconds == batched.slot_seconds[j]
        assert e.preempted == batched.preempted[j]
        assert e.n_escalated == batched.n_escalated[j]
        for field in ("completed", "overflowed", "escalated", "relayed"):
            assert [_req_state(r) for r in getattr(e, field)] \
                == [_req_state(r) for r in getattr(batched, field)[j]]


def _soa_case(make_streams, **kw):
    """Run `make_streams(pk)` scalar-vs-batched in both packages; hold the
    port to the reference's claim and its batched engine to the
    reference's bit for bit.  Returns the port's batched engine."""
    out = []
    for pk in (REF, PORT):
        scalars, batched = _run_both_engines(pk, make_streams(pk), **kw)
        _assert_bit_equal(scalars, batched)
        out.append(batched)
    assert_same(_batched_state(out[0]), _batched_state(out[1]))
    return out[1]


def test_parity_admission_order_and_chunked_interleave():
    def streams(pk):
        rng = np.random.default_rng(3)
        return [[_req(pk, i + 100 * j, int(rng.integers(1, 3000)),
                      int(rng.integers(1, 150)), t=0.04 * i)
                 for i in range(40)] for j in range(3)]
    _soa_case(streams, window=4096, n_slots=4, prefill_chunk=256)


def test_parity_window_ceiling_overflow_chain():
    def streams(pk):
        return [[_req(pk, j * 50, 100, 5000)]
                + [_req(pk, j * 50 + 1 + i, 40, 30, t=0.01 * i)
                   for i in range(12)] for j in range(2)]
    b = _soa_case(streams, window=256, n_slots=2, prefill_chunk=128,
                  evict_on_overflow=True)
    assert all(len(o) > 0 for o in b.overflowed)


def test_parity_escalation_backout_conservation():
    def streams(pk):
        return [[_req(pk, i, 64, 400, esc=6) for i in range(5)]
                for _ in range(2)]
    b = _soa_case(streams, window=8192, n_slots=2, prefill_chunk=128)
    assert int(b.n_escalated.sum()) == 10
    assert int(b.bank.tokens.sum()) == sum(
        r.n_generated - 1 for lst in b.completed for r in lst)


def test_parity_prefill_phase_fifo():
    def streams(pk):
        rng = np.random.default_rng(9)
        return [[_req(pk, i + 30 * j, int(rng.integers(64, 7000)), 1,
                      t=0.03 * i) for i in range(25)] for j in range(2)]
    b = _soa_case(streams, window=8192, n_slots=4, prefill_chunk=512,
                  phase="prefill")
    assert all(len(h) > 0 for h in b.handoff)


def test_parity_prefilled_admission_and_unchunked():
    def prefilled(pk):
        out = [[_req(pk, i, 128, 20, t=0.01 * i, pdone=True)
                for i in range(8)] for _ in range(2)]
        for r in (r for lst in out for r in lst):
            r.ready_time = r.arrival_time
            r.generated = [7]
        return out
    _soa_case(prefilled, window=4096, n_slots=2, prefill_chunk=256)
    _soa_case(lambda pk: [[_req(pk, i, 64, 25, t=0.02 * i)
                           for i in range(10)] for _ in range(2)],
              window=4096, n_slots=3, prefill_chunk=0)


@settings(max_examples=25, deadline=None)
@given(streams=st.lists(st.lists(
           st.tuples(st.integers(1, 2000), st.integers(1, 120),
                     st.floats(0.0, 2.0),
                     st.sampled_from([None, None, 4, 16])),
           min_size=1, max_size=25), min_size=1, max_size=3),
       n_slots=st.integers(1, 4), chunk=st.sampled_from([0, 64, 256]),
       window=st.sampled_from([512, 4096]), evict=st.booleans())
def test_property_scalar_and_batched_step_identically(
        streams, n_slots, chunk, window, evict):
    def make(pk):
        rid, out = 0, []
        for stream in streams:
            t, reqs = 0.0, []
            for plen, n_out, gap, esc in stream:
                t += gap
                reqs.append(_req(pk, rid, plen, n_out, t=t, esc=esc))
                rid += 1
            out.append(reqs)
        return out
    _soa_case(make, window=window, n_slots=n_slots, prefill_chunk=chunk,
              evict_on_overflow=evict)


# --- analytical engines (tests/serving/test_fleetsim.py) -------------------

def _engine(pk, **kw):
    kw.setdefault("window", 64)
    kw.setdefault("n_slots", 2)
    return pk.S.PoolEngine(None, None, profile=pk.profiles.H100_LLAMA70B,
                           streamed_params=STREAMED, **kw)


def _engine_state(e):
    return dict(meter={f.name: getattr(e.meter, f.name)
                       for f in dataclasses.fields(e.meter) if f.compare},
                stats=e.stats(),
                lists={f: [_req_state(r) for r in getattr(e, f)]
                       for f in REQ_LISTS})


def _engine_case(run):
    """`run(pk)` -> a drained engine, in both packages; states equal."""
    ref, port = _both(run)
    assert_same(_engine_state(ref), _engine_state(port))
    return port


def test_analytical_engine_completes_and_meters():
    def run(pk):
        e = _engine(pk)
        for i in range(5):
            e.submit(_req(pk, i, 8, 6))
        e.run_until_drained(max_iters=500)
        return e
    e = _engine_case(run)
    assert len(e.completed) == 5
    assert all(r.n_generated == 6 for r in e.completed)
    assert e.meter.tokens == 25 and e.meter.joules > 0
    assert 0.0 < e.occupancy <= 1.0


def test_analytical_engine_is_deterministic():
    def run(pk):
        e = _engine(pk, rng_seed=3)
        for i in range(6):
            e.submit(_req(pk, i, 7, 5))
        e.run_until_drained(max_iters=500)
        return e
    a, b = _engine_case(run), run(PORT)
    assert_same(_engine_state(a), _engine_state(b))


def test_chunked_prefill_delays_first_token():
    def ttft(pk, plen):
        e = _engine(pk, window=4096, n_slots=1, prefill_chunk=128)
        e.submit(_req(pk, 0, plen, 3))
        e.run_until_drained(max_iters=200)
        (r,) = e.completed
        return r.first_token_time - r.arrival_time
    ref, port = _both(lambda pk: (ttft(pk, 1024), ttft(pk, 64)))
    assert port == ref
    assert port[0] > port[1] > 0


def test_arrival_gating_charges_idle_power():
    def run(pk):
        e = _engine(pk, respect_arrival=True)
        e.submit(_req(pk, 0, 8, 4, t=1.0))
        e.run_until_drained(max_iters=100)
        return e
    e = _engine_case(run)
    assert len(e.completed) == 1
    assert e.meter.idle_joules == pytest.approx(
        PORT.profiles.H100_LLAMA70B.power_model.p_idle_w, rel=1e-6)
    assert e.completed[0].first_token_time >= 1.0


def test_overflow_eviction_backs_out_wasted_tokens():
    def run(pk):
        e = _engine(pk, window=16, n_slots=1, evict_on_overflow=True)
        e.submit(_req(pk, 0, 8, 500))
        e.run_until_drained(max_iters=100)
        return e
    e = _engine_case(run)
    assert not e.completed and len(e.overflowed) == 1
    (r,) = e.overflowed
    assert r.preemptions == 1 and r.ready_time is not None
    assert e.meter.tokens == 0 and e.meter.joules > 0


# --- meter attribution (tests/serving/test_fleetsim.py) --------------------

def _prefill_time(n_tokens, mfu=0.8):
    prof = PORT.profiles.H100_LLAMA70B
    return (2.0 * STREAMED * n_tokens
            / (prof.tp * prof.chip.peak_bf16_flops * mfu))


def _meter(pk):
    return pk.S.EnergyMeter(pk.profiles.H100_LLAMA70B)


def test_prefill_charged_at_compute_bound_power():
    def run(pk):
        m = _meter(pk)
        m.charge_prefill(1000, streamed_params=STREAMED)
        return m
    ref, m = _both(run)
    assert_same(ref, m)
    prof = PORT.profiles.H100_LLAMA70B
    t = _prefill_time(1000)
    assert m.prefill_joules == pytest.approx(prof.power_model.p_nom_w * t,
                                             rel=1e-9)
    assert m.prefill_joules > 1.5 * prof.power_w(1) * t


def test_prefill_attribution_by_real_interval():
    """A fully piggybacked chunk (dt = 0) and a boundary-straddling one
    are both pro-rated by the overlap of their real work interval."""
    def run(pk):
        hidden = _meter(pk)
        t = _prefill_time(100)
        hidden.sim_time_s = 5.0
        hidden.measure_t0, hidden.measure_t1 = 0.0, 5.0 - t / 2.0
        dt = hidden.charge_prefill(100, streamed_params=STREAMED,
                                   overlap_s=1e9)
        straddle = _meter(pk)
        straddle.measure_t0, straddle.measure_t1 = \
            0.0, _prefill_time(4096) / 2.0
        straddle.charge_prefill(4096, streamed_params=STREAMED)
        return dt, hidden, straddle
    ref, (dt, hidden, straddle) = _both(run)
    assert_same(ref, (dt, hidden, straddle))
    assert dt == 0.0 and hidden.prefill_joules > 0
    for m in (hidden, straddle):
        assert m.m_prefill_joules == pytest.approx(0.5 * m.prefill_joules,
                                                   rel=1e-9)


# --- fleet level (tests/serving/test_fleetsim.py) --------------------------

def _simulate(pk, kind, wl="AZURE", **kw):
    return pk.fleetsim.simulate_topology(
        kind, getattr(pk.workloads, wl), pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B, **kw)


def _cells(kinds, n=8000):
    def run(pk):
        return {k: _simulate(pk, k, b_short=4096, n_requests=n, seed=0)
                for k in kinds}
    ref, port = _both(run)
    assert_same(ref, port)
    return port


@pytest.fixture(scope="module")
def azure_cells():
    return _cells(("homo", "fleetopt"))


def test_simulated_fleetopt_at_least_2x_homo_on_azure(azure_cells):
    homo = azure_cells["homo"].sim_decode_tok_per_watt
    fo = azure_cells["fleetopt"].sim_decode_tok_per_watt
    assert fo >= 2.0 * homo, (fo, homo)


def test_simulated_within_tolerance_of_analytical(azure_cells):
    for kind, cell in azure_cells.items():
        assert abs(cell.delta_pct) < 25.0, (kind, cell.delta_pct)


def test_fleet_conservation_and_report_shape(azure_cells):
    for cell in azure_cells.values():
        f = cell.report["fleet"]
        assert f["completed"] == 8000
        assert f["tok_per_watt"] <= f["decode_tok_per_watt"]
        assert 0.0 <= f["prefill_energy_frac"] < 1.0
        assert f["ttft_p99_s"] >= f["ttft_p50_s"] > 0
        assert all(0.0 <= s["occupancy"] <= 1.0
                   for role, s in cell.report.items() if role != "fleet")


def test_overflow_migration_end_to_end():
    ref, cell = _both(lambda pk: _simulate(
        pk, "fleetopt", "AGENT", b_short=8192, gamma=1.1, n_requests=1500,
        seed=1))
    assert_same(ref, cell)
    f = cell.report["fleet"]
    assert f["migrations"] > 0 and f["completed"] == 1500
    assert cell.report["short"]["preempted"] == f["migrations"]
    assert cell.report["long"]["completed"] >= f["migrations"]


def test_multipool_migration_chain_short_mid_long():
    def run(pk):
        policy, plan, _ = pk.fleetsim.build_topology(
            "multipool", pk.workloads.AGENT, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B, gamma=2.0,
            windows=[2048, 8192, 65536])
        sim = pk.S.FleetSim(policy, plan, model=pk.modelspec.LLAMA31_70B)
        chain = _req(pk, 0, 900, 8000, pred=100)
        filler = [_req(pk, i, 64, 16, t=0.01 * i, pred=16)
                  for i in range(1, 40)]
        sim.run([chain] + filler)
        return plan, sim, [chain] + filler
    ref, (plan, sim, reqs) = _both(run)
    assert_same(_sim_state(ref[1], ref[2]), _sim_state(sim, reqs))
    assert [p.name for p in sorted(plan.pools, key=lambda p: p.window)] \
        == ["pool-2K", "pool-8K", "pool-64K"]
    rep, chain = sim.report(), reqs[0]
    assert rep["fleet"]["completed"] == 40
    assert rep["fleet"]["migrations"] == 2
    assert chain.preemptions == 2 and chain.pool.startswith("pool-64K")
    assert chain.n_generated == 8000


def test_multipool_end_to_end_on_trace():
    ref, cell = _both(lambda pk: _simulate(
        pk, "multipool", windows=[4096, 16384, 65536], n_requests=1000,
        seed=0))
    assert_same(ref, cell)
    f = cell.report["fleet"]
    roles = [r for r in cell.report if r != "fleet"]
    assert f["completed"] == 1000 and f["tok_per_watt"] > 0
    assert roles == ["pool-4K", "pool-16K", "pool-64K"]
    assert all(cell.report[r]["completed"] > 0 for r in roles)


def test_pool_group_balances_by_total_assigned_work():
    def run(pk):
        grp = pk.S.PoolGroup("g", pk.S.BatchedPoolEngine(
            instances=2, window=4096, profile=pk.profiles.H100_LLAMA70B,
            n_slots=4, name="e", streamed_params=STREAMED))
        for i, total in enumerate((10, 10, 4, 30)):
            grp.submit(_req(pk, i, 1, 1, pred=total - 1))
        return grp.queue_rids(0), grp.queue_rids(1), grp._pending
    ref, port = _both(run)
    assert_same(ref, port)
    assert port[0] == [0, 2] and port[1] == [1, 3]
    assert list(port[2]) == [14.0, 40.0]


def test_router_report_honors_measurement_window():
    def run(pk):
        e = _engine(pk)
        router = pk.S.ContextRouter({"only": e}, pk.S.RouterPolicy(
            kind="homo", ladder=[("only", math.inf)]))
        e.meter.measure_t1 = 0.0
        return e, router.run([_req(pk, i, 8, 6)
                              for i in range(3)])
    ref, (e, rep) = _both(run)
    assert_same(_engine_state(ref[0]), _engine_state(e))
    assert_same(ref[1], rep)
    assert e.meter.tokens > 0
    assert rep["fleet"]["tokens"] == 0 and rep["fleet"]["tok_per_watt"] == 0


def test_router_and_fleetsim_agree_on_measured_tokens():
    def run(pk):
        policy, plan, _ = pk.fleetsim.build_topology(
            "fleetopt", pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B, b_short=4096)
        sim = pk.S.FleetSim(policy, plan, model=pk.modelspec.LLAMA31_70B)
        reqs = pk.fleetsim.trace_requests(pk.workloads.AZURE, 600, seed=2)
        sim.run(reqs)
        return sim, reqs
    ref, (sim, reqs) = _both(run)
    assert_same(_sim_state(*ref), _sim_state(sim, reqs))
    rep, router_rep = sim.report(), sim.router.report()
    assert_same(ref[0].router.report(), router_rep)
    assert router_rep["fleet"]["tokens"] == rep["fleet"]["tokens"]
    assert router_rep["fleet"]["joules"] <= rep["fleet"]["joules"] + 0.1


@pytest.mark.parametrize("kind,kw", [("nope", dict(b_short=4096)),
                                     ("multipool", {})],
                         ids=["unknown", "multipool-no-ladder"])
def test_build_topology_rejects_bad_kinds(kind, kw):
    msgs = []
    for pk in (REF, PORT):
        with pytest.raises(ValueError) as err:
            pk.fleetsim.build_topology(
                kind, pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
                pk.modelspec.LLAMA31_70B, **kw)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_trace_requests_clips_and_predicts():
    ref, reqs = _both(lambda pk: pk.fleetsim.trace_requests(
        pk.workloads.AZURE, 200, seed=0, max_total=4096))
    assert [(_req_state(r), r.prompt.shape) for r in reqs] \
        == [(_req_state(r), r.prompt.shape) for r in ref]
    assert len(reqs) == 200
    assert all(r.prompt_len + r.max_new_tokens <= 4096 for r in reqs)
    mean_out = int(round(PORT.workloads.AZURE.mean_output))
    assert all(r.predicted_output == mean_out for r in reqs)
    ts = [r.arrival_time for r in reqs]
    assert all(b > a for a, b in zip(ts, ts[1:]))


# --- disaggregated fleets (tests/serving/test_disagg.py) -------------------

def _disagg_topology(pk):
    return pk.fleetsim.build_topology(
        "disagg_fleetopt", pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B, b_short=4096, gamma=2.0)


def test_disagg_topology_routes_into_prefill_pools():
    def run(pk):
        policy, plan, _ = _disagg_topology(pk)
        roles = [p.name for p in sorted(plan.pools, key=lambda p: p.window)]
        sim = pk.S.FleetSim(policy, plan, model=pk.modelspec.LLAMA31_70B)
        return (roles, policy.admission_ladder(roles), sim.handoff_to,
                sim.overflow_to,
                [sim.router.route(_req(pk, 0, 100, 10, pred=10)),
                 sim.router.route(_req(pk, 1, 9000, 10, pred=10))])
    ref, port = _both(run)
    assert_same(ref, port)
    roles, ladder, handoff_to, overflow_to, routed = port
    assert roles == ["prefill-8K", "decode-8K", "prefill-64K", "decode-64K"]
    assert ladder == [("prefill-8K", 8192.0), ("prefill-64K", math.inf)]
    assert handoff_to == {"prefill-8K": "decode-8K",
                          "prefill-64K": "decode-64K"}
    assert overflow_to == {"decode-8K": "prefill-64K"}
    assert routed == ["prefill-8K", "prefill-64K"]


def test_disagg_overflow_reprefills_in_long_slice():
    def run(pk):
        policy, plan, _ = _disagg_topology(pk)
        sim = pk.S.FleetSim(policy, plan, model=pk.modelspec.LLAMA31_70B)
        chain = _req(pk, 0, 900, 8000, pred=100)
        sim.run([chain])
        return sim, [chain]
    ref, (sim, (chain,)) = _both(run)
    assert_same(_sim_state(*ref), _sim_state(sim, [chain]))
    f = sim.report()["fleet"]
    assert (f["completed"], f["migrations"], f["handoffs"]) == (1, 1, 2)
    assert chain.preemptions == 1 and chain.pool.startswith("decode-64K")
    assert chain.prefill_role == "prefill-64K"
    assert chain.n_generated == 8000


@pytest.fixture(scope="module")
def disagg_cells():
    return _cells(("disagg", "disagg_fleetopt"))


def test_disagg_measured_within_tolerance_of_analytical(disagg_cells):
    for kind, cell in disagg_cells.items():
        assert abs(cell.delta_pct) < 25.0, (kind, cell.delta_pct)
        assert cell.analytical_fleet_tok_per_watt \
            < cell.analytical_tok_per_watt


def test_disagg_handoff_energy_nonzero_and_accounted(disagg_cells):
    j_per_byte = PORT.disagg.HANDOFF_J_PER_BYTE
    for cell in disagg_cells.values():
        f = cell.report["fleet"]
        assert f["handoffs"] >= f["completed"] == 8000
        assert f["kv_handoff_joules"] > 0 and f["kv_handoff_gb"] > 0
        assert 0 < f["kv_handoff_energy_frac"] < 0.05
        total_j = f["kv_handoff_gb"] * 1e9 * j_per_byte
        assert f["kv_handoff_joules"] <= total_j * (1 + 1e-6)


def test_disagg_removes_prefill_interference_from_decode_pools(disagg_cells):
    for cell in disagg_cells.values():
        for role, s in cell.report.items():
            if role == "fleet":
                continue
            if s["phase"] == "decode":
                assert s["completed"] > 0 and s["relayed"] == 0
                assert s["m_prefill_joules"] == 0.0, (role, s)
            else:
                assert s["completed"] == 0 and s["relayed"] > 0
                assert s["m_prefill_joules"] > 0.0, (role, s)


def test_disagg_ttft_under_unconstrained_sizing(disagg_cells):
    assert disagg_cells["disagg"].report["fleet"]["ttft_p99_s"] <= 0.5


def test_prefill_role_latency_includes_downstream_metrics():
    def run(pk):
        policy, plan, reg = pk.fleetsim.build_topology(
            "disagg", pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B, b_short=4096)
        sim = pk.S.FleetSim(policy, plan, registry=reg)
        reqs = pk.fleetsim.trace_requests(pk.workloads.AZURE, 400, seed=2)
        sim.run(reqs)
        return sim, reqs
    ref, (sim, reqs) = _both(run)
    assert_same(_sim_state(*ref), _sim_state(sim, reqs))
    for role, lat in sim.latency_by_role().items():
        assert {"ttft_p99_s", "e2e_p99_s", "tpot_p99_ms"} <= set(lat), role


# --- autoscaling (tests/serving/test_autoscale.py) -------------------------

POL = dict(control_interval_s=10.0, target_utilization=0.8,
           scaleup_lag_s=2.0, scaledown_delay_s=30.0, min_frac=0.25,
           spare_instances=0)


def _times(rate, t0, t1):
    return np.linspace(t0, t1, int(round(rate * (t1 - t0))), endpoint=False)


def _plan(ts, pol=None, **kw):
    """The same `Autoscaler.plan_pool` call in both packages."""
    ref, port = _both(lambda pk: pk.autoscale.Autoscaler(
        pk.policy(**(pol or POL))).plan_pool(ts, **kw))
    assert_same(ref, port)
    return port


def test_steady_low_rate_sheds_to_demand_after_hysteresis():
    sched = _plan(_times(2.0, 0.0, 300.0), n_peak=10,
                  rate_per_instance=1.0, horizon_s=300.0)
    assert sched.n_rows == 10
    assert int(sched.online_at(np.array([0.0]))[0]) == 10
    assert int(sched.online_at(np.array([299.0]))[0]) == 3
    assert np.isinf(sched.online_until[:3]).all()


def test_step_up_scales_back_out_with_lag_and_load():
    ts = np.concatenate([_times(2.0, 0.0, 200.0),
                         _times(9.0, 200.0, 400.0)])
    sched = _plan(ts, n_peak=10, rate_per_instance=1.0, horizon_s=400.0,
                  load_s=5.0)
    assert sched.n_rows > 10
    new = sched.online_from[10:]
    np.testing.assert_allclose(
        (new - POL["scaleup_lag_s"] - 5.0) % POL["control_interval_s"], 0.0,
        atol=1e-9)
    assert (new > 200.0).all()
    assert int(sched.online_at(np.array([399.0]))[0]) == 10


def test_trend_extrapolation_scales_ahead_of_a_ramp():
    ramp = np.sqrt(np.linspace(0.0, 1.0, 4000)) * 400.0
    sched = _plan(np.sort(ramp), n_peak=20, rate_per_instance=1.0,
                  horizon_s=400.0)
    rate_now = ((ramp >= 190.0) & (ramp < 200.0)).sum() / 10.0
    assert int(sched.online_at(np.array([200.0]))[0]) \
        >= math.ceil(rate_now / 0.8)


def test_cancelled_incarnation_has_zero_length_window():
    ts = np.concatenate([_times(2.0, 0.0, 100.0),
                         _times(9.0, 100.0, 110.0),
                         _times(2.0, 110.0, 300.0)])
    sched = _plan(ts, dict(POL, scaleup_lag_s=100.0, scaledown_delay_s=0.0),
                  n_peak=10, rate_per_instance=1.0, horizon_s=300.0)
    assert (sched.online_until <= sched.online_from)[10:].any()
    assert sched.online_instance_seconds(0.0, 300.0) < 10 * 300.0


def test_online_instance_seconds_matches_online_at_integral():
    sched = _plan(_times(3.0, 0.0, 200.0), n_peak=6, rate_per_instance=1.0,
                  horizon_s=200.0)
    grid = np.linspace(0.0, 200.0, 20001)
    counts = sched.online_at(grid)
    numeric = float(np.sum((counts[:-1] + counts[1:]) / 2.0)
                    * (grid[1] - grid[0]))
    assert sched.online_instance_seconds(0.0, 200.0) \
        == pytest.approx(numeric, rel=2e-3)


def test_set_online_windows_moves_clocks_and_charges_load():
    def run(pk):
        e = pk.S.BatchedPoolEngine(window=4096,
                                   profile=pk.profiles.H100_LLAMA70B,
                                   instances=3, n_slots=8,
                                   streamed_params=STREAMED)
        e.bank.measure_t0, e.bank.measure_t1 = 0.0, 100.0
        j0 = e.bank.m_joules.sum()
        e.set_online_windows(np.array([0.0, 10.0, 20.0]),
                             np.array([np.inf, np.inf, 15.0]), load_s=4.0)
        return j0, e
    ref, (j0, e) = _both(run)
    assert_same(_batched_state(ref[1]), _batched_state(e))
    np.testing.assert_allclose(e.bank.sim_time_s, [0.0, 10.0, 20.0])
    assert e.bank.m_idle_joules[1] > 0.0 and e.bank.m_idle_joules[2] == 0.0
    assert e.bank.m_joules.sum() > j0


def _autoscale_spec(pk, pol):
    spec = pk.topospec.TopologySpec.from_kind(
        "fleetopt", pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B,
        b_short=4096)
    return dataclasses.replace(spec, autoscale=pk.policy(**pol))


def _diurnal_run(pk, pol, peak, day, autoscale):
    spec = _autoscale_spec(pk, pol)
    wl = dataclasses.replace(pk.workloads.AZURE, arrival_rate=peak)
    trace = pk.S.sample_diurnal_trace(
        wl, pk.workloads.DiurnalProfile(peak_rate=peak, day_s=day), day,
        seed=0, max_total=spec.max_window)
    sim, reqs, _ = pk.fleetsim.prepare_spec(spec, wl, seed=0, trace=trace,
                                            autoscale=autoscale)
    sim.run(reqs, warmup_frac=0.0)
    return sim, reqs


def test_autoscaled_run_completes_everything_and_saves_energy():
    pol = dict(control_interval_s=6.0, target_utilization=0.7,
               scaleup_lag_s=1.0, scaledown_delay_s=12.0, min_frac=0.2,
               spare_instances=0)

    def run(pk):
        return [_diurnal_run(pk, pol, 200.0, 120.0, a) for a in (False,
                                                                 True)]
    ref, port = _both(run)
    for (rs, rr), (ps, pr) in zip(ref, port):
        assert_same(_sim_state(rs, rr), _sim_state(ps, pr))
    (sim_s, reqs), (sim_a, _) = port
    rep_s, rep_a = sim_s.report(), sim_a.report()
    assert rep_a["fleet"]["completed"] == rep_s["fleet"]["completed"] \
        == len(reqs)
    assert sim_a.schedules and not sim_s.schedules
    assert rep_a["fleet"]["joules"] < rep_s["fleet"]["joules"]
    assert rep_a["fleet"]["tok_per_watt"] > rep_s["fleet"]["tok_per_watt"]
    for role in sim_a.order:
        assert "avg_online_instances" in rep_a[role]
        assert "avg_online_instances" not in rep_s[role]


def test_autoscaled_run_is_deterministic():
    pol = dict(control_interval_s=5.0, scaleup_lag_s=1.0,
               scaledown_delay_s=10.0)
    ref, (a, reqs) = _both(lambda pk: _diurnal_run(pk, pol, 25.0, 80.0,
                                                   True))
    assert_same(_sim_state(*ref), _sim_state(a, reqs))
    b, reqs_b = _diurnal_run(PORT, pol, 25.0, 80.0, True)
    assert_same(_sim_state(a, reqs), _sim_state(b, reqs_b))


def test_prepare_spec_defaults_to_spec_policy():
    wl = dataclasses.replace(PORT.workloads.AZURE, arrival_rate=25.0)
    spec = _autoscale_spec(PORT, dict(control_interval_s=5.0, min_frac=0.5))
    sim, _, _ = PORT.fleetsim.prepare_spec(spec, wl, seed=0, n_requests=50,
                                           autoscale=True)
    assert sim.autoscale is spec.autoscale


# --- the committed baseline and the engines the port does not have ---------

def _unconstrained_rows():
    rows = json.loads((ROOT / "benchmarks" / "results"
                       / "fleet_sim.json").read_text())["rows"]
    return [r for r in rows if r["table"] == "unconstrained"]


B_SHORT = {"azure-conv": 4096, "lmsys-chat": 1536, "agent-heavy": 8192}


@pytest.mark.parametrize("row", _unconstrained_rows(),
                         ids=lambda r: f"{r['workload']}-{r['topology']}")
def test_unconstrained_row_of_fleet_sim_json(row):
    """Table A of benchmarks/fleet_sim_bench.py --quick, as the bench
    builds each row, from the port alone: every field equals the
    committed row."""
    wl = {w.name: w for w in PORT.workloads.WORKLOADS.values()}[
        row["workload"]]
    cell = PORT.fleetsim.simulate_topology(
        row["topology"], wl, PORT.profiles.H100_LLAMA70B,
        PORT.modelspec.LLAMA31_70B, b_short=B_SHORT[wl.name],
        n_requests=1000, seed=0)
    f = cell.report["fleet"]
    got = dict(cell.row(), table="unconstrained",
               occupancy={r: s["occupancy"] for r, s in cell.report.items()
                          if r != "fleet"},
               prefill_energy_frac=f["prefill_energy_frac"],
               tokens_per_s=f["tokens_per_s"])
    assert json.loads(json.dumps(got)) == row


def test_run_fleet_grid_numpy_matches_reference_and_run():
    """The staged grid loop drains numpy scenarios as `FleetSim.run`
    does, and as the reference's grid loop does on numpy sims."""
    def scenarios(pk):
        return [pk.fleetsim.prepare_topology(
            k, pk.workloads.LMSYS, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B, b_short=1536, n_requests=300, seed=3)
            for k in ("homo", "fleetopt", "disagg")]
    ref, port = _both(lambda pk: pk.fleetsim.run_fleet_grid(scenarios(pk)))
    assert_same(ref, port)
    solo = [sim.run(reqs) for sim, reqs, _ in scenarios(PORT)]
    assert_same([c.report for c in port], solo)


@pytest.mark.parametrize("engine", ["jax", "torch"])
def test_compiled_drain_is_not_ported_yet(engine):
    """An engine name the port does not serve drains no port fleet, and
    none falls back to numpy: every entry point that takes `engine`
    raises, naming ROADMAP A 2c (whose compiled drain the port serves as
    "graph")."""
    F, W, P, M = PORT.fleetsim, PORT.workloads, PORT.profiles, \
        PORT.modelspec
    args = ("fleetopt", W.AZURE, P.H100_LLAMA70B, M.LLAMA31_70B)
    policy, plan, reg = F.build_topology(*args)
    spec = PORT.topospec.TopologySpec.from_kind(*args[:1], *args[2:])
    calls = [lambda: PORT.S.FleetSim(policy, plan, registry=reg,
                                     engine=engine),
             lambda: F.simulate_topology(*args, n_requests=10,
                                         engine=engine),
             lambda: F.simulate_spec(spec, W.AZURE, n_requests=10,
                                     engine=engine),
             lambda: F.prepare_spec(spec, W.AZURE, n_requests=10,
                                    engine=engine, autoscale=True),
             lambda: F.run_fleet_grid(
                 [F.prepare_topology(*args, n_requests=10)], engine=engine)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="A 2c"):
            call()
