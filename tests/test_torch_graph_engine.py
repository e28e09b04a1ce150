"""The port's compiled fleet drain (`serving.graph_engine`) vs the numpy
oracles, on the CPU.

The reference's compiled drain (`repro.serving.jax_engine`) cannot run on
this image (ROADMAP C1), so its four tests are the specification here, not
the oracle: tests/serving/test_jax_engine.py,
test_spec_parity.py::test_committed_quick_cell_reproduces_under_jax_engine,
test_trace_parity.py::test_numpy_vs_jax_fleet_lifecycle_stream and
test_fleet_grid.py::test_grid_slice_jax_matches_numpy_oracle.  Each case
below runs the same per-instance streams through `GraphPoolEngine`
(device="cpu": the same steps the card replays as CUDA graphs, run
eagerly) and through the numpy `BatchedPoolEngine` of both packages, and
holds the drain to `_assert_parity`'s contract: integer and ordering
fields exact, meters and times at rtol 1e-9, atol 1e-12 (multi-slot chunk
spills and the closed-form coast accumulate in another order).
"""
import functools
import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import port_fleet_bench as PFB  # noqa: E402


def _pkg(root):
    core = importlib.import_module(f"{root}.core")
    serving = importlib.import_module(f"{root}.serving")
    return SimpleNamespace(
        S=serving, fleetsim=serving.fleetsim, topospec=core.topospec,
        profiles=core.profiles, modelspec=core.modelspec,
        workloads=core.workloads)


REF, PORT = _pkg("repro"), _pkg("repro_torch")
GE = importlib.import_module("repro_torch.serving.graph_engine")
STREAMED = PORT.modelspec.LLAMA31_70B.streamed_params
GRAPH = functools.partial(GE.GraphPoolEngine, device="cpu")


def _req(pk, rid, plen, out, t=0.0, pred=None, esc=None, pdone=False):
    r = pk.S.Request(rid=rid, prompt=np.broadcast_to(np.int64(0), (plen,)),
                     max_new_tokens=out, arrival_time=t,
                     predicted_output=pred)
    r.escalate_at = esc
    r.prefill_done = pdone
    if pdone:
        r.ready_time = t
        r.generated = [7]
    return r


def _mk(pk, cls, streams, *, profile="H100_LLAMA70B", **kw):
    """An engine of `cls` over `streams` (per instance: _req arg tuples,
    built as `pk`'s Requests), constructed as the reference test does."""
    eng = cls(instances=len(streams), profile=getattr(pk.profiles, profile),
              streamed_params=STREAMED, rng_seed=11, name="p",
              respect_arrival=True, **kw)
    for j, reqs in enumerate(streams):
        for args, rkw in reqs:
            eng.submit(_req(pk, *args, **rkw), j)
    eng.sort_queues()
    return eng


def _three(streams, *, measure=None, **kw):
    """The streams through the reference's numpy engine, the port's numpy
    engine and the graph engine (identical construction), undrained."""
    engs = (_mk(REF, REF.S.BatchedPoolEngine, streams, **kw),
            _mk(PORT, PORT.S.BatchedPoolEngine, streams, **kw),
            _mk(PORT, GRAPH, streams, **kw))
    if measure is not None:
        for e in engs:
            e.bank.measure_t0, e.bank.measure_t1 = measure
    return engs


def _run_three(streams, **kw):
    engs = _three(streams, **kw)
    for e in engs:
        e.run_until_drained(max_iters=200_000)
    return engs


def _assert_parity(ref, g, rtol=1e-9):
    """tests/serving/test_jax_engine.py's `_assert_parity`."""
    b, c = ref.bank, g.bank
    for k in ("joules", "m_joules", "prefill_joules", "m_prefill_joules",
              "idle_joules", "m_idle_joules", "dispatch_joules",
              "m_dispatch_joules", "sim_time_s"):
        np.testing.assert_allclose(getattr(c, k), getattr(b, k),
                                   rtol=rtol, atol=1e-12, err_msg=k)
    for k in ("tokens", "m_tokens", "prefill_tokens"):
        np.testing.assert_array_equal(getattr(c, k), getattr(b, k),
                                      err_msg=k)
    np.testing.assert_allclose(g.slot_seconds, ref.slot_seconds,
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(g.m_slot_seconds, ref.m_slot_seconds,
                               rtol=rtol, atol=1e-12)
    np.testing.assert_array_equal(g.preempted, ref.preempted)
    np.testing.assert_array_equal(g.n_escalated, ref.n_escalated)
    for field in ("completed", "overflowed", "escalated", "relayed",
                  "handoff"):
        for j in range(ref.instances):
            sa = getattr(ref, field)[j]
            sb = getattr(g, field)[j]
            assert [r.rid for r in sa] == [r.rid for r in sb], (field, j)
            for ra, rb in zip(sa, sb):
                assert ra.n_generated == rb.n_generated, (field, ra.rid)
                assert ra.preemptions == rb.preemptions, (field, ra.rid)
                assert ra.escalations == rb.escalations, (field, ra.rid)
                assert ra.prefill_done == rb.prefill_done, (field, ra.rid)
                assert (ra.generated is None) == (rb.generated is None)
                if ra.generated is not None:
                    assert ra.generated == rb.generated, (field, ra.rid)
                for tk in ("finish_time", "first_token_time"):
                    ta, tb = getattr(ra, tk), getattr(rb, tk)
                    assert ta == pytest.approx(tb, rel=rtol, abs=1e-12), \
                        (field, ra.rid, tk)
                if ra.ready_time is None:
                    assert rb.ready_time is None, (field, ra.rid)
                else:
                    assert ra.ready_time == pytest.approx(
                        rb.ready_time, rel=rtol, abs=1e-12), (field, ra.rid)


def _assert_both(engs):
    """The graph engine against both numpy oracles."""
    ref, port, g = engs
    _assert_parity(ref, g)
    _assert_parity(port, g)


def R(rid, plen, out, **kw):
    return ((rid, plen, out), kw)


def test_graph_parity_admission_and_chunked_interleave():
    rng = np.random.default_rng(3)
    reqs = [[R(i + 100 * j, int(rng.integers(1, 3000)),
               int(rng.integers(1, 150)), t=0.04 * i)
             for i in range(40)] for j in range(3)]
    _assert_both(_run_three(reqs, window=4096, n_slots=4,
                            prefill_chunk=256))


def test_graph_parity_window_ceiling_overflow_chain():
    reqs = [[R(j * 50, 100, 5000)] +
            [R(j * 50 + 1 + i, 40, 30, t=0.01 * i) for i in range(12)]
            for j in range(2)]
    engs = _run_three(reqs, window=256, n_slots=2, prefill_chunk=128,
                      evict_on_overflow=True)
    _assert_both(engs)
    assert all(len(o) > 0 for o in engs[2].overflowed)


def test_graph_parity_escalation_backout_in_window():
    """Escalations *inside* the measurement window: the windowed m_*
    counters must back out exactly what the numpy oracle backs out."""
    reqs = [[R(i, 64, 400, esc=6, t=0.05 * i) for i in range(5)]
            for _ in range(2)]
    engs = _three(reqs, window=8192, n_slots=2, prefill_chunk=128,
                  measure=(0.1, 1e9))       # window opens mid-run
    for e in engs:
        e.run_until_drained(max_iters=200_000)
    _assert_both(engs)
    assert int(engs[2].n_escalated.sum()) == 10


def test_graph_parity_prefill_phase_fifo():
    rng = np.random.default_rng(9)
    reqs = [[R(i + 30 * j, int(rng.integers(64, 7000)), 1, t=0.03 * i)
             for i in range(25)] for j in range(2)]
    engs = _run_three(reqs, window=8192, n_slots=4, prefill_chunk=512,
                      phase="prefill")
    _assert_both(engs)
    ref, _, g = engs
    assert all(len(h) > 0 for h in g.handoff)
    # handoff first tokens are live LCG values, not placeholders
    for j in range(g.instances):
        for ra, rb in zip(ref.handoff[j], g.handoff[j]):
            assert ra.generated == rb.generated


def test_graph_parity_prefilled_admission_and_dispatch():
    """disagg decode admission (prefill_done: no prefill charge) plus a
    per-step MoE dispatch floor."""
    pdone = [[R(i, 128, 20, t=0.01 * i, pdone=True) for i in range(8)]
             for _ in range(2)]
    _assert_both(_run_three(pdone, window=4096, n_slots=2,
                            prefill_chunk=256, dispatch_ms=2.0))


def test_graph_unchunked_decode_unsupported():
    """The unchunked immediate-prefill admission path advances the clock
    mid-admission — out of the compiled drain's contract, as in the
    reference."""
    with pytest.raises(NotImplementedError):
        GRAPH(instances=1, window=4096,
              profile=PORT.profiles.H100_LLAMA70B,
              streamed_params=STREAMED, prefill_chunk=0)


def test_drain_engines_ragged_batch():
    """One `drain_engines` call over engines with different instance
    counts, slot counts, queue lengths, profiles and phases must equal
    each engine drained alone by the numpy oracle — the padding masks may
    not leak work into (or out of) dead rows."""
    rng = np.random.default_rng(17)

    def mkstreams(n_inst, n, stride):
        return [[R(1000 * stride + i + 100 * j, int(rng.integers(1, 2000)),
                   int(rng.integers(1, 80)), t=0.05 * i)
                 for i in range(n)] for j in range(n_inst)]

    cfgs = [dict(window=4096, n_slots=4, prefill_chunk=256),
            dict(window=2048, n_slots=2, prefill_chunk=128,
                 evict_on_overflow=True),
            dict(window=8192, n_slots=3, prefill_chunk=512,
                 phase="prefill")]
    profiles = ["H100_LLAMA70B", "B200_LLAMA70B", "H100_LLAMA70B"]
    streams = [mkstreams(1, 30, 0), mkstreams(3, 7, 1), mkstreams(2, 18, 2)]
    trios = [_three(s, profile=p, **c)
             for s, p, c in zip(streams, profiles, cfgs)]
    for ref, port, _ in trios:
        ref.run_until_drained(max_iters=200_000)
        port.run_until_drained(max_iters=200_000)
    GE.drain_engines([g for *_, g in trios], max_iters=200_000)
    for *_, g in trios:
        g.run_until_drained(max_iters=200_000)   # consumes staged result
    for trio in trios:
        _assert_both(trio)


def test_steps_after_the_end_change_nothing():
    """Every update of a step is gated by `cond`: steps taken after the
    drain ended (the tail of the last graph replay) leave the state bit
    for bit as it was."""
    eng = _mk(PORT, GRAPH, [[R(i, 300, 20, t=0.02 * i) for i in range(6)]],
              window=4096, n_slots=2, prefill_chunk=128)
    packed = eng._pack(200_000)
    d = GE._Drain("decode", 8, 8, 8, GE._merge([packed], 8, 8),
                  torch.device("cpu"))
    end = d.run(GE._merge([packed], 8, 8))
    assert end["it"] > 0 and not end["active"].any()
    alive = GE._drain_one(d.p, d.st, phase="decode", n_slots_pad=8)
    assert not bool(alive)
    for k, v in d.st.items():
        assert np.array_equal(v.numpy(), end[k]), k


def test_bucket_and_pad_floor_classes():
    """`_bucket` equals the reference's, and `drain_engines` groups
    engines by the cheapest fitting shape class (then by power-of-two
    buckets), padding each class's rows to its floor."""
    jax_engine = importlib.import_module("repro.serving.jax_engine")
    for n in range(0, 3000, 7):
        for floor in (1, 8):
            assert GE._bucket(n, floor) == jax_engine._bucket(n, floor)
    shapes = []
    real_get = GE._get_drain

    def spy(phase, i_pad, s_pad, q_pad, like, device):
        shapes.append((phase, i_pad, s_pad, q_pad))
        return real_get(phase, i_pad, s_pad, q_pad, like, device)

    def eng(n_slots, n_req, inst=1, **kw):
        return _mk(PORT, GRAPH, [[R(100 * j + i, 50, 3, t=0.01 * i)
                                  for i in range(n_req)]
                                 for j in range(inst)],
                   window=4096, n_slots=n_slots, prefill_chunk=128, **kw)

    engines = [eng(20, 3), eng(30, 4, inst=3), eng(40, 20), eng(200, 2),
               eng(10, 2, phase="prefill"), eng(10, 100)]
    GE._get_drain = spy
    try:
        GE.drain_engines(engines, pad_floors=PFB.SHAPE_CLASSES)
    finally:
        GE._get_drain = real_get
    assert shapes == [("decode", 256, 32, 4),      # S 20 and 30, Q <= 4
                      ("decode", 128, 48, 24),     # S 40, Q 20
                      ("decode", 64, 256, 64),     # S 200
                      ("prefill", 256, 32, 4),
                      ("decode", 8, 16, 128)]      # Q 100 fits none
    for e in engines:
        e.run_until_drained()
        assert sum(map(len, e.completed)) + sum(map(len, e.handoff)) \
            == sum(map(len, e.queues))


def test_graph_engine_needs_cuda_unless_cpu_asked():
    """`GraphPoolEngine` and every fleet entry point drain on "cuda"
    unless the caller passes device="cpu"; without a card they raise
    instead of falling back.  Autoscaling stays numpy-only."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    F, W, P, M = PORT.fleetsim, PORT.workloads, PORT.profiles, \
        PORT.modelspec
    with pytest.raises(RuntimeError, match="CUDA"):
        GE.GraphPoolEngine(instances=1, window=4096,
                           profile=P.H100_LLAMA70B, streamed_params=STREAMED,
                           prefill_chunk=128)
    args = ("fleetopt", W.AZURE, P.H100_LLAMA70B, M.LLAMA31_70B)
    with pytest.raises(RuntimeError, match="CUDA"):
        F.simulate_topology(*args, n_requests=10, engine="graph")
    spec = PORT.topospec.TopologySpec.from_kind(*args[:1], *args[2:])
    with pytest.raises(ValueError, match="autoscale requires the numpy"):
        F.prepare_spec(spec, W.AZURE, n_requests=10, engine="graph",
                       device="cpu", autoscale=True)


# --- fleet level ------------------------------------------------------------

def test_graph_fleet_matches_numpy_fleet_seed_numbers():
    """End-to-end anchor: `simulate_topology(engine="graph")` reproduces
    the numpy fleet's committed seed cell (Azure fleetopt, 1000 requests,
    seed 0) to the rounding the baseline records, and the numpy fleets of
    both packages at the drain's tolerance."""
    def cell(pk, **kw):
        return pk.fleetsim.simulate_topology(
            "fleetopt", pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B, b_short=4096, n_requests=1000, seed=0,
            **kw)
    got = cell(PORT, engine="graph", device="cpu")
    f = got.report["fleet"]
    assert f["completed"] == 1000
    assert round(got.sim_decode_tok_per_watt, 2) == 5.66
    assert round(got.sim_tok_per_watt, 2) == 1.81
    for want in (cell(REF), cell(PORT)):
        assert want.report["fleet"]["completed"] == f["completed"]
        assert want.report["fleet"]["migrations"] == f["migrations"]
        for k in ("sim_decode_tok_per_watt", "sim_tok_per_watt"):
            assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                    rel=1e-9)


def test_committed_quick_cell_reproduces_under_graph_engine():
    """The committed quick-bench fleetopt cell (fleet_sim.json, Azure,
    1000 requests, seed 0) through `simulate_spec(engine="graph")` lands
    on the committed digits."""
    rows = json.loads((ROOT / "benchmarks" / "results" / "fleet_sim.json")
                      .read_text())["rows"]
    want, = [r for r in rows if r["table"] == "unconstrained"
             and r["workload"] == "azure-conv" and r["topology"] == "fleetopt"]
    spec = PORT.topospec.TopologySpec.from_kind(
        "fleetopt", PORT.profiles.H100_LLAMA70B, PORT.modelspec.LLAMA31_70B,
        b_short=4096)
    cell = PORT.fleetsim.simulate_spec(spec, PORT.workloads.AZURE,
                                       n_requests=1000, seed=0,
                                       engine="graph", device="cpu")
    assert round(cell.sim_decode_tok_per_watt, 2) == want["simulated"]
    assert round(cell.analytical_tok_per_watt, 2) == want["analytical"]


def _fleet_stream(pk, engine, **kw):
    rec = pk.S.TraceRecorder(level="lifecycle")
    spec = pk.topospec.TopologySpec.from_kind(
        "fleetopt", pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B,
        b_short=4096)
    sim, reqs, _ = pk.fleetsim.prepare_spec(
        spec, pk.workloads.AZURE, n_requests=300, seed=0, engine=engine,
        telemetry=rec, **kw)
    sim.run(reqs)
    return rec


def test_numpy_vs_graph_fleet_lifecycle_stream():
    """The graph drain emits nothing itself; `_finalize` replays its
    terminal tape through the same hooks.  Same seeded fleetopt cell ->
    identical per-request event sequences, with event times at the
    engines' rel-1e-9 parity tolerance (the per-request view is the
    invariant: accumulation order can transpose near-ties of the globally
    sorted stream)."""
    rec_g = _fleet_stream(PORT, "graph", device="cpu")

    def by_rid(rec):
        out = {}
        for t, rid, kind, pool, inst in rec.sorted_events():
            out.setdefault(rid, []).append((kind, pool, inst, t))
        return out

    b = by_rid(rec_g)
    for rec_np in (_fleet_stream(REF, "numpy"), _fleet_stream(PORT, "numpy")):
        assert rec_np.counts() == rec_g.counts()
        assert rec_np.pool_names == rec_g.pool_names
        a = by_rid(rec_np)
        assert a.keys() == b.keys()
        for rid in a:
            assert [e[:3] for e in a[rid]] == [e[:3] for e in b[rid]], rid
            np.testing.assert_allclose([e[3] for e in a[rid]],
                                       [e[3] for e in b[rid]],
                                       rtol=1e-9, atol=1e-12,
                                       err_msg=str(rid))


GRID_N_REQUESTS = 120


def _grid_slice():
    """One cheap cell per distinct drain family, H100 only (the
    reference's smoke slice)."""
    picks = {}
    for c in PFB.grid_cells():
        label, kind = c[0], c[1]
        if label["generation"] == "H100" and kind not in picks:
            picks[kind] = c
    return [picks[k] for k in ("fleetopt", "multipool", "moe_pool")]


def test_grid_slice_graph_matches_numpy_oracle():
    """A thin slice of Table E through the path the full grid takes:
    grid_cells composition, SHAPE_CLASSES grouping, run_fleet_grid's
    stage-batched drains — cell for cell against the numpy oracle at the
    grid's 0.1% tok/W tolerance."""
    def measure(engine):
        chunk = _grid_slice()
        scenarios = [PORT.fleetsim.prepare_topology(
            kind, PORT.workloads.AZURE, prof, mdl,
            n_requests=GRID_N_REQUESTS, seed=0, engine=engine, device="cpu",
            **kw) for _, kind, prof, mdl, kw in chunk]
        floors = PFB.SHAPE_CLASSES if engine == "graph" else None
        out = {}
        for (label, *_), cell in zip(chunk, PORT.fleetsim.run_fleet_grid(
                scenarios, pad_floors=floors, engine=engine)):
            out[label["topology"]] = (cell.sim_decode_tok_per_watt,
                                      cell.sim_tok_per_watt,
                                      cell.report["fleet"]["completed"])
        return out

    ref, got = measure("numpy"), measure("graph")
    assert set(got) == set(ref)
    for kind, (dec, allin, done) in ref.items():
        gdec, gallin, gdone = got[kind]
        assert gdone == done, kind
        assert gdec == pytest.approx(dec, rel=1e-3), kind
        assert gallin == pytest.approx(allin, rel=1e-3), kind


def test_grid_cells_and_shape_classes_equal_reference():
    """The bench tool's copies of Table E's cells and shape classes equal
    benchmarks/fleet_grid_bench.py's: 260 cells with the same labels,
    kinds and prepare kwargs, every family on every chip."""
    gb = importlib.import_module("benchmarks.fleet_grid_bench")
    mine, theirs = PFB.grid_cells(), gb.grid_cells()
    assert len(mine) == len(theirs) == 260
    for (la, ka, pa, ma, kwa), (lb, kb, pb, mb, kwb) in zip(mine, theirs):
        assert (la, ka, ma.name, kwa) == (lb, kb, mb.name, kwb)
        assert pa.name == pb.name
    assert PFB.SHAPE_CLASSES == gb.SHAPE_CLASSES
    assert (PFB.GRID_WIDTH, PFB.GRID_REQUESTS) == (gb.DEFAULT_WIDTH,
                                                   gb.DEFAULT_N_REQUESTS)


# --- property test: random streams, numpy oracles vs the graph drain --------

request_lists = st.lists(
    st.tuples(st.integers(1, 2000),     # prompt len
              st.integers(1, 120),      # output len
              st.floats(0.0, 2.0),      # inter-arrival gap
              st.sampled_from([None, None, 4, 16])),  # escalate_at
    min_size=1, max_size=25)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(streams=st.lists(request_lists, min_size=1, max_size=3),
       n_slots=st.integers(1, 4),
       chunk=st.sampled_from([64, 256]),   # 0 = unchunked: unsupported
       window=st.sampled_from([512, 4096]),
       evict=st.booleans())
def test_property_numpy_and_graph_step_identically(
        streams, n_slots, chunk, window, evict):
    rid = 0
    reqs_by_inst = []
    for stream in streams:
        t = 0.0
        reqs = []
        for plen, out, gap, esc in stream:
            t += gap
            reqs.append(R(rid, plen, out, t=t, esc=esc))
            rid += 1
        reqs_by_inst.append(reqs)
    _assert_both(_run_three(reqs_by_inst, window=window, n_slots=n_slots,
                            prefill_chunk=chunk, evict_on_overflow=evict))
