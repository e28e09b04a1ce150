"""The port's FleetScope (trace recorder, timeline, Perfetto export, the
meter's charge channel and conservation audit, the engines' lifecycle
hooks) vs the JAX package's.

The cases mirror tests/serving/test_telemetry.py and the scalar-vs-SoA
cases of tests/serving/test_trace_parity.py: each asserts the reference
test's own claim on the port, and that the port's golden streams, counts,
per-phase energies, reconciliation rows, timeline arrays and Perfetto
documents equal the reference's exactly.  One more case traces a
model-mode port engine on yi-6b `.reduced()` and the reference's
model-mode engine on the same converted weights: their golden streams are
equal, and tracing moves no token.

Reference finding C6 (ROADMAP): the reference misses its own 1e-9
reconciliation gate on a zero-width `[prefill, handoff]` window, where the
decode residual is a 1.5e-20 J rounding remainder over a 1e-12 floor.  The
port's hypothesis twin holds the port to 1e-9 wherever the reference meets
it and to the reference's exact residual where it does not;
`test_c6_zero_width_window_residual_equals_reference` pins that example.

Reference finding C11: `charge_handoff` never clamps its window fraction,
so a 1e-8 s transfer ending at t = 0.5 s attributes 1 + 5e-9 of its bytes
to the window and `conservation_violations` reports `m_handoff_bytes >
handoff_bytes`.  The property holds the port to no violation wherever the
reference has none, and to the reference's own violations, of C11's kind
only, where it has some; `test_c11_handoff_fraction_equals_reference`
pins that example.
"""
import copy
import dataclasses
import importlib
import json
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models.convert import convert_params


def _pkg(root):
    core = importlib.import_module(f"{root}.core")
    serving = importlib.import_module(f"{root}.serving")
    return SimpleNamespace(
        root=root, S=serving, timeline=core.timeline, slo=core.slo,
        topospec=core.topospec, profiles=core.profiles,
        modelspec=core.modelspec, workloads=core.workloads,
        request=serving.request)


REF, PORT = _pkg("repro"), _pkg("repro_torch")
STREAMED = PORT.modelspec.LLAMA31_70B.streamed_params
N_REQUESTS = 300


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


def _recorder_state(rec):
    """Both channels of a recorder, verbatim."""
    return dict(level=rec.level, events=rec.events, charges=rec.charges,
                occupancy=rec.occupancy, pool_names=rec.pool_names,
                pool_instances=rec.pool_instances,
                golden=rec.golden_stream(), counts=rec.counts(),
                energy=rec.energy_by_phase(),
                per_pool=[rec.energy_by_phase(p)
                          for p in range(len(rec.pool_names))])


def _timeline_state(tl):
    return dict(t0=tl.t0, t1=tl.t1, n_bins=tl.n_bins, pools=tl.pools,
                meta=tl.meta, json=tl.to_json())


# --- a traced fleet cell (tests/serving/test_telemetry.py) -----------------

def _run_cell(pk, telemetry=None):
    spec = pk.topospec.TopologySpec.from_kind(
        "fleetopt", pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B,
        b_short=4096)
    sim, reqs, _ = pk.S.prepare_spec(spec, pk.workloads.AZURE,
                                     n_requests=N_REQUESTS, seed=0,
                                     telemetry=telemetry)
    return sim, sim.run(reqs)


def _banks(sim):
    return [g.engine.bank for g in sim.groups.values()]


@pytest.fixture(scope="module")
def detail_cells():
    """(ref, port) detail-traced fleetopt cells: (recorder, sim, report)."""
    def run(pk):
        rec = pk.S.TraceRecorder(level="detail")
        return (rec,) + _run_cell(pk, rec)
    ref, port = _both(run)
    assert_same(_recorder_state(ref[0]), _recorder_state(port[0]))
    assert_same(ref[2], port[2])
    return ref, port


@pytest.fixture(scope="module")
def detail_cell(detail_cells):
    return detail_cells[1]


def test_zero_overhead_when_off(detail_cell):
    _, _, report_on = detail_cell
    _, report_off = _run_cell(PORT)
    assert json.dumps(report_off, sort_keys=True, default=str) == \
        json.dumps(report_on, sort_keys=True, default=str)


def test_lifecycle_counts_match_report(detail_cell):
    rec, _, report = detail_cell
    counts = rec.counts()
    assert counts["arrive"] == N_REQUESTS
    assert counts["route"] >= N_REQUESTS
    assert counts["complete"] == report["fleet"]["completed"]
    assert counts["admit"] > 0 and counts["prefill"] > 0
    ts = [t for t, *_ in rec.golden_stream()]
    assert ts == sorted(ts)


def test_reconcile_energy_within_1e9(detail_cells):
    """The charge channel records the same float64 values the meters
    accumulate: every phase reconciles within 1e-9 relative, and the rows
    equal the reference's."""
    ref, (rec, sim, _) = detail_cells
    rows = PORT.S.reconcile_energy(rec, _banks(sim))
    assert_same(REF.S.reconcile_energy(ref[0], _banks(ref[1])), rows)
    assert set(rows) == {"total", "decode", "prefill", "idle", "handoff",
                         "dispatch"}
    for phase, row in rows.items():
        assert row["rel_err"] < 1e-9, (phase, row)
    assert rows["total"]["meter_j"] > 0.0


def test_timeline_binning_conserves_mass(detail_cells):
    def run(pk, rec, sim):
        t_lo = 0.0
        for _, _, _, start, _, _, _, _ in rec.charges:
            s = np.asarray(start, np.float64)
            if s.size:
                t_lo = min(t_lo, float(np.min(s)))
        return (pk.S.build_timeline(rec, t0=t_lo, n_bins=64),
                pk.S.phase_totals(_banks(sim)))
    (ref_tl, ref_m), (tl, meter) = [run(pk, c[0], c[1]) for pk, c in
                                    zip((REF, PORT), detail_cells)]
    assert_same((_timeline_state(ref_tl), ref_m),
                (_timeline_state(tl), meter))
    for phase, key in (("total", "joules"), ("prefill", "prefill_j"),
                       ("idle", "idle_j"), ("handoff", "handoff_j"),
                       ("decode", "decode_j"), ("dispatch", "dispatch_j")):
        assert float(tl.fleet(key).sum()) == pytest.approx(
            meter[phase], rel=1e-9, abs=1e-9), phase
    assert float(tl.fleet("watts").sum()) * tl.bin_s == \
        pytest.approx(meter["total"], rel=1e-9)


def test_timeline_to_json_schema(detail_cells):
    ref, port = [pk.S.build_timeline(c[0], n_bins=16).to_json()
                 for pk, c in zip((REF, PORT), detail_cells)]
    assert_same(ref, port)
    assert port["schema_version"] == PORT.timeline.TIMELINE_SCHEMA_VERSION
    assert port["n_bins"] == 16
    for series in port["pools"].values():
        assert set(series) == set(PORT.timeline.SERIES_KEYS)
        assert all(len(col) == 16 for col in series.values())
    assert len(port["fleet"]["tok_per_watt"]) == 16
    json.dumps(port)


def test_timeline_online_uses_registered_instances(detail_cells):
    ref, port = [pk.S.build_timeline(c[0], n_bins=8)
                 for pk, c in zip((REF, PORT), detail_cells)]
    assert_same(_timeline_state(ref), _timeline_state(port))
    rec = detail_cells[1][0]
    for pid, name in enumerate(rec.pool_names):
        assert (port.pools[name]["online"]
                == rec.pool_instances.get(pid, 0)).all(), name


def test_empty_recorder_timeline():
    ref, tl = _both(lambda pk: pk.S.build_timeline(
        pk.S.TraceRecorder(level="detail"), n_bins=4))
    assert_same(_timeline_state(ref), _timeline_state(tl))
    assert tl.t1 > tl.t0 and not tl.pools
    assert not tl.fleet("joules").any()


def test_bin_intervals_straddler_prorates():
    def run(pk):
        out = np.zeros(4)
        edges = np.linspace(0.0, 4.0, 5)
        pk.timeline.bin_intervals([0.5], [2.0], [8.0], edges, out)
        first = out.copy()
        pk.timeline.bin_intervals([2.0], [0.0], [1.0], edges, out)
        return first, out
    ref, (first, out) = _both(run)
    assert_same(ref, (first, out))
    assert first.tolist() == [2.0, 4.0, 2.0, 0.0] and out[2] == 3.0


def test_perfetto_doc_shape(detail_cells):
    ref, doc = [pk.S.to_perfetto(c[0], counter_bins=12)
                for pk, c in zip((REF, PORT), detail_cells)]
    assert_same(ref, doc)
    rec = detail_cells[1][0]
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert doc["otherData"]["schema_version"] \
        == PORT.timeline.TRACE_SCHEMA_VERSION
    assert doc["otherData"]["pools"] == rec.pool_names
    phs = {ev["ph"] for ev in doc["traceEvents"]}
    assert phs <= {"X", "i", "C", "M"} and "X" in phs and "C" in phs
    procs = {ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "process_name"}
    assert procs == set(rec.pool_names)
    json.dumps(doc)


def test_explain_attributes_violations(detail_cells):
    def run(pk, sim):
        return (pk.slo.explain(sim, pk.slo.SLOSpec(ttft_p99_s=1e-9)),
                pk.slo.explain(sim, pk.slo.SLOSpec(ttft_p99_s=1e9)))
    ref, (rows, generous) = [run(pk, c[1]) for pk, c in
                             zip((REF, PORT), detail_cells)]
    assert_same(ref, (rows, generous))
    sim = detail_cells[1][1]
    assert all(set(r) >= {"role", "n_obs", "n_late", "late_frac",
                          "worst_ttft_s", "first_violation_s",
                          "last_violation_s", "peak_window_s",
                          "peak_window_late"} for r in rows)
    assert sorted(r["role"] for r in rows) == sorted(sim.order)
    lates = [r["n_late"] for r in rows]
    assert lates == sorted(lates, reverse=True) and sum(lates) > 0
    for r in rows:
        assert r["n_late"] == r["n_obs"]
        if r["n_late"]:
            lo, hi = r["peak_window_s"]
            assert lo <= hi and r["peak_window_late"] > 0
    assert all(r["n_late"] == 0 for r in generous)


def test_strict_keys_empty_window():
    empty = np.empty(0)
    ref, (strict, legacy) = _both(lambda pk: (
        pk.request.latency_percentiles_arrays(empty, empty, empty, empty,
                                              strict_keys=True),
        pk.request.latency_percentiles_arrays(empty, empty, empty, empty)))
    assert_same(ref, (strict, legacy))
    assert set(strict) == {"ttft_p50_s", "ttft_p99_s", "e2e_p99_s",
                           "tpot_p50_ms", "tpot_p99_ms"}
    assert all(math.isnan(v) for v in strict.values())
    assert legacy == {}


def test_conservation_violations_clean_and_corrupt(detail_cell):
    _, sim, _ = detail_cell
    for bank in _banks(sim):
        assert PORT.S.conservation_violations(bank) == []

    def run(pk):
        m = pk.S.EnergyMeter(pk.profiles.H100_LLAMA70B)
        m.charge_prefill(512, streamed_params=1e9)
        m.charge_decode_step(4, 1000.0)
        m.charge_idle(0.5)
        clean = pk.S.conservation_violations(m)
        m.m_joules = m.joules + 5.0
        return clean, pk.S.conservation_violations(m)
    ref, (clean, bad) = _both(run)
    assert (clean, bad) == ref
    assert clean == [] and any("m_joules" in v for v in bad)


def test_invalid_trace_level_rejected():
    for pk in (REF, PORT):
        with pytest.raises(ValueError):
            pk.S.TraceRecorder(level="verbose")


# --- window-straddling charges (the reference's property, C6) --------------

def _straddle(pk, ops, t0, span, dispatch_s):
    rec = pk.S.TraceRecorder(level="detail")
    m = pk.S.EnergyMeter(pk.profiles.H100_LLAMA70B, measure_t0=t0,
                         measure_t1=t0 + span, dispatch_s=dispatch_s)
    m.trace = rec
    m.trace_pool = rec.pool_id("p", instances=1)
    for kind, n, f in ops:
        if kind == "decode":
            m.charge_decode_step(n, 500.0 + 100.0 * n)
        elif kind == "prefill":
            m.charge_prefill(16 * n, streamed_params=1e9, overlap_s=0.5 * f)
        elif kind == "idle":
            m.charge_idle(f)
        else:
            m.charge_handoff(1024.0 * n, start_s=m.sim_time_s - f,
                             duration_s=f, j_per_byte=2e-10)
    return (m, pk.S.conservation_violations(m),
            pk.S.reconcile_energy(rec, [m]), _recorder_state(rec))


C6_EXAMPLE = dict(ops=[("prefill", 1, 0.0), ("handoff", 1, 0.0)], t0=0.0,
                  span=0.0, dispatch_s=0.0)
C11_EXAMPLE = dict(ops=[("decode", 1, 0.0), ("idle", 1, 0.5),
                        ("handoff", 1, 1e-08)], t0=0.0, span=1.0,
                   dispatch_s=0.0)
C11_VIOLATION = "m_handoff_bytes > handoff_bytes"


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["decode", "prefill", "idle",
                                               "handoff"]),
                              st.integers(1, 64), st.floats(0.0, 2.0)),
                    min_size=1, max_size=40),
       t0=st.floats(0.0, 5.0), span=st.floats(0.0, 5.0),
       dispatch_s=st.sampled_from([0.0, 5e-4]))
@example(**C6_EXAMPLE)
@example(**C11_EXAMPLE)
def test_property_straddling_charges_conserve(ops, t0, span, dispatch_s):
    """Any charge sequence against any measurement window: the port's
    meter, audit, reconciliation and charge channel equal the reference's;
    conservation holds wherever the reference's does, and elsewhere the
    port reports exactly the reference's violations, each of C11's kind;
    every phase reconciles within 1e-9 wherever the reference does, and to
    the reference's own residual where it does not (C6)."""
    (jm, jviol, jrows, jrec), (m, viol, rows, rec) = _both(
        lambda pk: _straddle(pk, ops, t0, span, dispatch_s))
    assert_same((jm, jviol, jrows, jrec), (m, viol, rows, rec))
    if jviol == []:
        assert viol == []
    else:
        assert viol == jviol
        assert all(v.startswith(C11_VIOLATION) for v in viol), viol
    for phase, row in rows.items():
        assert row["rel_err"] < 1e-9 or \
            row["rel_err"] == jrows[phase]["rel_err"] >= 1e-9, (phase, row)


def test_c6_zero_width_window_residual_equals_reference():
    """The reference's failing example: the port reconciles every phase
    but decode within 1e-9, and misses it on decode by exactly the
    reference's residual (1.5e-20 J of rounding over a 1e-12 floor)."""
    (_, _, jrows, _), (_, viol, rows, _) = _both(
        lambda pk: _straddle(pk, **C6_EXAMPLE))
    assert viol == []
    assert_same(jrows, rows)
    assert rows["decode"]["trace_j"] == 0.0
    assert 0.0 < rows["decode"]["meter_j"] < 1e-19
    assert rows["decode"]["rel_err"] == jrows["decode"]["rel_err"] > 1e-9
    assert all(row["rel_err"] < 1e-9 for phase, row in rows.items()
               if phase != "decode")


def test_c11_handoff_fraction_equals_reference():
    """The reference's unclamped handoff fraction: a 1e-8 s transfer ending
    at t = 0.5 s puts 1 + 5e-9 of its 1024 bytes in the window.  The port's
    meter reports the same violation and the same windowed bytes, to the
    bit, and reconciles every phase within 1e-9."""
    (jm, jviol, jrows, _), (m, viol, rows, _) = _both(
        lambda pk: _straddle(pk, **C11_EXAMPLE))
    assert viol == jviol == [f"{C11_VIOLATION} (rows [0])"]
    assert m.m_handoff_bytes.hex() == jm.m_handoff_bytes.hex()
    assert m.m_handoff_bytes == 1024.0000051453535 > m.handoff_bytes == 1024.0
    assert_same(jrows, rows)
    assert all(row["rel_err"] < 1e-9 for row in rows.values())


# --- scalar vs SoA streams (tests/serving/test_trace_parity.py) ------------

def _req(pk, rid, plen, out, t=0.0, esc=None):
    r = pk.S.Request(rid=rid, prompt=np.broadcast_to(np.int64(0), (plen,)),
                     max_new_tokens=out, arrival_time=t)
    r.escalate_at = esc
    return r


def _traced_both(pk, reqs_by_inst, level="detail", **kw):
    """The reference test's `_traced_both` in package `pk`: N traced
    scalar engines under the batched pool's name and one traced batched
    engine; returns both recorders."""
    H = pk.profiles.H100_LLAMA70B
    rec_s, rec_b = pk.S.TraceRecorder(level=level), \
        pk.S.TraceRecorder(level=level)
    n = len(reqs_by_inst)
    scalars = [pk.S.PoolEngine(None, None, profile=H,
                               streamed_params=STREAMED,
                               rng_seed=11 + 7919 * j, name=f"p#{j}",
                               respect_arrival=True, **kw)
               for j in range(n)]
    batched = pk.S.BatchedPoolEngine(instances=n, profile=H,
                                     streamed_params=STREAMED, rng_seed=11,
                                     name="p", respect_arrival=True, **kw)
    for j, e in enumerate(scalars):
        e.attach_trace(rec_s, name="p", instance=j)
    batched.attach_trace(rec_b)
    for j, reqs in enumerate(reqs_by_inst):
        for r in reqs:
            scalars[j].submit(copy.copy(r))
            batched.submit(copy.copy(r), j)
    for e in scalars:
        e.run_until_drained(max_iters=200_000)
    batched.run_until_drained(max_iters=200_000)
    return rec_s, rec_b


def _stream_case(make, **kw):
    """Scalar-vs-SoA in both packages: within each the sorted streams are
    equal (the reference's claim), and the port's recorders equal the
    reference's.  Returns the port's batched recorder."""
    out = []
    for pk in (REF, PORT):
        rec_s, rec_b = _traced_both(pk, make(pk), **kw)
        assert rec_s.pool_names == rec_b.pool_names
        assert rec_s.sorted_events() == rec_b.sorted_events()
        assert rec_s.golden_stream() == rec_b.golden_stream()
        for phase, e in rec_s.energy_by_phase().items():
            b = rec_b.energy_by_phase()[phase]
            assert e == b or abs(e - b) <= 1e-9 * abs(e), phase
        out.append((rec_s, rec_b))
    for (jr, pr) in zip(out[0], out[1]):
        assert_same(_recorder_state(jr), _recorder_state(pr))
    return out[1][1]


def test_scalar_vs_soa_detail_stream_chunked():
    def make(pk):
        rng = np.random.default_rng(3)
        return [[_req(pk, i + 100 * j, int(rng.integers(1, 3000)),
                      int(rng.integers(1, 150)), t=0.04 * i)
                 for i in range(30)] for j in range(3)]
    counts = _stream_case(make, window=4096, n_slots=4,
                          prefill_chunk=256).counts()
    assert counts["complete"] == 90
    assert counts["admit"] == 90 and counts["prefill"] > 0


def test_scalar_vs_soa_eviction_and_escalation_events():
    def make(pk):
        return [[_req(pk, j * 50, 100, 5000)]
                + [_req(pk, j * 50 + 1 + i, 40, 30, t=0.01 * i,
                        esc=6 if i % 3 else None) for i in range(12)]
                for j in range(2)]
    counts = _stream_case(make, window=256, n_slots=2, prefill_chunk=128,
                          evict_on_overflow=True).counts()
    assert counts["overflow"] > 0 and counts["escalate"] > 0


def test_scalar_vs_soa_prefill_phase_handoff():
    def make(pk):
        rng = np.random.default_rng(9)
        return [[_req(pk, i + 30 * j, int(rng.integers(64, 7000)), 1,
                      t=0.03 * i) for i in range(20)] for j in range(2)]
    rec = _stream_case(make, window=8192, n_slots=4, prefill_chunk=512,
                       phase="prefill")
    assert rec.counts()["handoff"] == 40


# --- model mode: the port's engine decoding a real model, traced -----------

@pytest.fixture(scope="module")
def yi_model():
    jcfg = jax_get_config("yi-6b").reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("yi-6b").reduced(), params


def test_model_mode_golden_stream_equals_reference(yi_model):
    """A traced model-mode port engine and the traced model-mode reference
    engine on the same converted weights and requests (chunked prefill, a
    window that evicts one request): equal detail streams, charges and
    per-phase energy; the port's untraced twin emits the same tokens."""
    jcfg, jparams, cfg, params = yi_model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n))
               for n in (5, 9, 3, 12, 7)]
    outs = (6, 4, 30, 5, 3)

    def serve(pk, c, p, traced):
        eng = pk.S.PoolEngine(c, p, window=32, profile=pk.profiles
                              .H100_LLAMA70B, n_slots=2, name="yi",
                              prefill_chunk=4, evict_on_overflow=True)
        rec = pk.S.TraceRecorder(level="detail")
        if traced:
            eng.attach_trace(rec)
        for i, (pr, o) in enumerate(zip(prompts, outs)):
            eng.submit(pk.S.Request(rid=i, prompt=np.array(pr),
                                    max_new_tokens=o))
        eng.run_until_drained(max_iters=500)
        return eng, rec
    jeng, jrec = serve(REF, jcfg, jparams, True)
    eng, rec = serve(PORT, cfg, params, True)
    plain, _ = serve(PORT, cfg, params, False)
    assert_same(_recorder_state(jrec), _recorder_state(rec))
    assert rec.counts()["overflow"] == 1 and rec.counts()["complete"] == 4
    assert [r.generated for r in eng.completed] \
        == [r.generated for r in jeng.completed] \
        == [r.generated for r in plain.completed]
    for phase, row in PORT.S.reconcile_energy(rec, [eng.meter]).items():
        assert row["rel_err"] < 1e-9, (phase, row)
    assert PORT.S.conservation_violations(eng.meter) == []
