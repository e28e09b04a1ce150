"""The port's topology search (`core.topo_search`) vs the JAX package's.

Each case mirrors one of tests/core/test_topo_search.py: `ladder_spec`'s
validation and its multipool equivalence, and `optimize_topology`'s
seeding, determinism, memo and row.  It asserts the reference test's own
claim on the port and that the port's result equals the reference's
exactly (`_plain` of tests/test_torch_fleet_core.py: every dataclass
field, floats by their bits; a search by its history, counts, best spec
and best sizing).

The compiled drain: one small search (azure-conv, 300 requests, budget
4, seed 0) under `engine="graph", device="cpu"` (the steps the card
replays as CUDA graphs, run eagerly) equals the numpy engine's history
and row, and three fleet shapes the search's genome reaches (a
disaggregated ladder, the small-model rung, a chip-mixed ladder) size
under "graph" as under numpy.
"""
import importlib
import math
from types import SimpleNamespace

import pytest

from test_torch_fleet_core import _plain, assert_same


def _pkg(root):
    core = importlib.import_module(f"{root}.core")
    return SimpleNamespace(
        root=root, ts=core.topo_search, slo=core.slo, topospec=core.topospec,
        profiles=core.profiles, modelspec=core.modelspec,
        routing=core.routing, workloads=core.workloads)


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def _ladder(pk):
    return (4096, 16384, pk.routing.LONG_WINDOW)


def _fast(pk):
    """The reference file's fast search arguments: a 300-request trace
    with a relaxed SLO, so the incumbent complies."""
    return dict(slo=pk.slo.SLOSpec(ttft_p99_s=0.8), n_requests=300, seed=0,
                budget=4, max_rounds=3, trim=False)


def _search(pk, **kw):
    return pk.ts.optimize_topology(
        pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B, **_fast(pk), **kw)


def _sizing(res):
    """An SLOSizingResult's compared fields (the policy object and the
    plan's profiles compare through `_plain`)."""
    return _plain(dict(kind=res.kind, rounds=res.rounds,
                       compliant=res.compliant, plan=res.plan,
                       overrides=res.overrides, trimmed=res.trimmed,
                       sim_stats=res.sim_stats,
                       measured_hol=res.measured_hol,
                       explanation=res.explanation,
                       slo_tok_per_watt=res.slo_tok_per_watt,
                       ttft_p99_s=res.ttft_p99_s,
                       measured=res.measured_decode_tok_per_watt))


def _assert_same_search(ref, port):
    assert port.history == ref.history
    assert (port.evaluations, port.restarts, port.workload) \
        == (ref.evaluations, ref.restarts, ref.workload)
    assert port.best_spec.spec_hash == ref.best_spec.spec_hash
    assert _plain(port.best_score) == _plain(ref.best_score)
    assert _sizing(port.best_result) == _sizing(ref.best_result)
    assert _plain(port.row()) == _plain(ref.row())


@pytest.fixture(scope="module")
def fast():
    """The fast search of the reference file, in both packages."""
    ref, port = _search(REF), _search(PORT)
    _assert_same_search(ref, port)
    return port


@pytest.fixture(scope="module")
def with_small():
    """The fast search with the small-model axis, in both packages."""
    ref, port = (_search(pk, small_model=pk.modelspec.LLAMA31_8B)
                 for pk in (REF, PORT))
    _assert_same_search(ref, port)
    return port


# --- ladder_spec -------------------------------------------------------------

def _refused(fn):
    """fn(package) raises ValueError in both packages with one message."""
    msgs = []
    for pk in (REF, PORT):
        with pytest.raises(ValueError) as exc:
            fn(pk)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_ladder_spec_rejects_non_ascending_windows():
    msg = _refused(lambda pk: pk.ts.ladder_spec(
        (16384, 4096, pk.routing.LONG_WINDOW),
        [pk.profiles.H100_LLAMA70B] * 3, pk.modelspec.LLAMA31_70B))
    assert "strictly ascending" in msg


def test_ladder_spec_rejects_gamma_below_one():
    msg = _refused(lambda pk: pk.ts.ladder_spec(
        _ladder(pk), [pk.profiles.H100_LLAMA70B] * 3,
        pk.modelspec.LLAMA31_70B, gamma=0.5))
    assert "gamma" in msg


def test_ladder_spec_rejects_profile_count_mismatch():
    msg = _refused(lambda pk: pk.ts.ladder_spec(
        _ladder(pk), [pk.profiles.H100_LLAMA70B] * 2,
        pk.modelspec.LLAMA31_70B))
    assert "one profile per rung" in msg


def test_ladder_spec_rejects_small_model_without_profile():
    msg = _refused(lambda pk: pk.ts.ladder_spec(
        _ladder(pk), [pk.profiles.H100_LLAMA70B] * 3,
        pk.modelspec.LLAMA31_70B, small_model=pk.modelspec.LLAMA31_8B))
    assert "small_profile" in msg


def test_ladder_spec_matches_multipool_provision():
    def both(pk):
        P, M = pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B
        spec = pk.ts.ladder_spec(_ladder(pk), [P] * 3, M, gamma=2.0)
        legacy = pk.topospec.TopologySpec.from_kind(
            "multipool", P, M, windows=list(_ladder(pk)))
        return (spec.spec_hash, spec.label,
                spec.provision(pk.workloads.AZURE),
                legacy.provision(pk.workloads.AZURE))

    ref, port = both(REF), both(PORT)
    assert_same(ref, port)
    _, _, got, want = port
    assert len(got.pools) == len(want.pools)
    for g, w in zip(got.pools, want.pools):
        assert g.window == w.window
        assert g.instances == w.instances
        assert g.tokens_per_s == pytest.approx(w.tokens_per_s)
        assert g.power_w_per_instance == pytest.approx(
            w.power_w_per_instance)
    assert got.tok_per_watt == pytest.approx(want.tok_per_watt)


def test_ladder_spec_disagg_builds_pool_pairs():
    def build(pk):
        spec = pk.ts.ladder_spec((4096, pk.routing.LONG_WINDOW),
                                 [pk.profiles.H100_LLAMA70B] * 2,
                                 pk.modelspec.LLAMA31_70B, disagg=True)
        return spec, (spec.spec_hash, spec.provision(pk.workloads.AZURE))

    spec, got = build(PORT)
    assert_same(build(REF)[1], got)
    assert spec.accounting == "disagg"
    assert [p.role for p in spec.pools] == [
        "prefill-4K", "decode-4K", "prefill-64K", "decode-64K"]
    assert spec.pool("prefill-4K").handoff_to == "decode-4K"
    assert spec.pool("decode-4K").overflow_to == "prefill-64K"
    assert spec.pool("decode-64K").overflow_to is None


def test_ladder_spec_small_first_binds_small_model():
    def build(pk):
        P = pk.profiles.H100_LLAMA70B
        small_prof = pk.profiles.computed_profile(
            pk.modelspec.LLAMA31_8B, P.chip, P.power_model, tp=1)
        spec = pk.ts.ladder_spec(_ladder(pk), [P] * 3,
                                 pk.modelspec.LLAMA31_70B,
                                 small_model=pk.modelspec.LLAMA31_8B,
                                 small_profile=small_prof)
        return spec, (spec.spec_hash, spec.label,
                      [p.model_key for p in spec.pools],
                      spec.provision(pk.workloads.AZURE))

    spec, got = build(PORT)
    assert_same(build(REF)[1], got)
    assert spec.pools[0].model_key == "small"
    assert spec.models["small"] is PORT.modelspec.LLAMA31_8B
    assert all(p.model_key == "default" for p in spec.pools[1:])


# --- optimize_topology -------------------------------------------------------

def test_search_beats_or_ties_seed_incumbent(fast):
    assert isinstance(fast, PORT.ts.TopologySearchResult)
    seed_score = fast.history[0]["score"]
    assert seed_score is not None
    assert fast.best_score >= seed_score
    assert fast.best_result.compliant
    assert math.isfinite(fast.best_score) and fast.best_score > 0


def test_search_is_deterministic(with_small):
    again = _search(PORT, small_model=PORT.modelspec.LLAMA31_8B)
    assert again.best_spec.spec_hash == with_small.best_spec.spec_hash
    assert again.best_score == with_small.best_score
    assert [h["spec_hash"] for h in again.history] \
        == [h["spec_hash"] for h in with_small.history]


def test_search_memoizes_and_respects_budget(fast):
    assert fast.evaluations <= _fast(PORT)["budget"]
    hashes = [h["spec_hash"] for h in fast.history]
    assert len(hashes) == len(set(hashes))
    assert len(hashes) == fast.evaluations


def test_search_row_shape(fast):
    row = fast.row()
    for key in ("workload", "label", "spec_hash", "slo_feasible",
                "measured", "ttft_p99_s", "instances", "compliant",
                "evaluations", "restarts"):
        assert key in row
    assert row["workload"] == PORT.workloads.AZURE.name
    assert row["spec_hash"] == fast.best_spec.spec_hash


# --- the compiled drain under the search -------------------------------------

def test_search_under_graph_drain_equals_numpy(with_small):
    """The small search with the small-model axis, every candidate's
    pools drained by the graph engine's eager steps on the CPU: the same
    history entry for entry (no error), counts, winner and row."""
    graph = _search(PORT, small_model=PORT.modelspec.LLAMA31_8B,
                    engine="graph", device="cpu")
    assert all(h["error"] is None for h in graph.history)
    _assert_same_search(with_small, graph)


def _shape(pk, name):
    P, M = pk.profiles, pk.modelspec
    ladder, p = _ladder(pk), P.H100_LLAMA70B
    if name == "disagg":
        return pk.ts.ladder_spec((4096, pk.routing.LONG_WINDOW), [p] * 2,
                                 M.LLAMA31_70B, disagg=True)
    if name == "small-model rung":
        small = P.computed_profile(M.LLAMA31_8B, p.chip, p.power_model, tp=1)
        return pk.ts.ladder_spec(ladder, [p] * 3, M.LLAMA31_70B,
                                 small_model=M.LLAMA31_8B,
                                 small_profile=small)
    return pk.ts.ladder_spec(ladder, [p, P.B200_LLAMA70B_FLEET,
                                      P.H200_LLAMA70B], M.LLAMA31_70B)


@pytest.mark.parametrize("name", ["disagg", "small-model rung", "chip mix"])
def test_search_shapes_size_alike_under_graph_drain(name):
    """Fleet shapes of the search's genome that Table E never drains
    (prefill-phase pools with KV handoffs, the small model's rung, chips
    mixed along the ladder), sized by `size_to_slo_spec` on the fast
    search's trace: the reference's numpy, the port's numpy and the
    port's graph drain give one sizing."""
    def sized(pk, **kw):
        args = {k: v for k, v in _fast(pk).items() if k != "budget"}
        return pk.slo.size_to_slo_spec(_shape(pk, name), pk.workloads.AZURE,
                                       **args, **kw)

    ref = _sizing(sized(REF))
    assert _sizing(sized(PORT)) == ref
    assert _sizing(sized(PORT, engine="graph", device="cpu")) == ref
