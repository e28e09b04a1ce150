"""The port's fleet core (sizing, routing topologies, the TopologySpec IR,
the diurnal envelope, the autoscale policy and the SLO sizing loop) vs the
JAX package's numpy twins.

Each case mirrors one of tests/core/test_{fleet,topospec,diurnal,
autoscale_policy}.py or tests/serving/test_slo.py: it asserts the
reference test's own claim on the port, and that the port's result equals
the reference's exactly — every field of every dataclass, float for float
(`_plain` compares floats by their bits).
"""
import dataclasses
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.law import gain_decomposition
from repro_torch.core.law import gain_decomposition as port_gain_decomposition

# --- both packages, one namespace each -------------------------------------


def _pkg(root):
    core = importlib.import_module(f"{root}.core")
    serving = importlib.import_module(f"{root}.serving")
    return SimpleNamespace(
        root=root, core=core, serving=serving, fleet=core.fleet,
        routing=core.routing, topospec=core.topospec, slo=core.slo,
        multipool=core.multipool, disagg=core.disagg,
        autoscale=core.autoscale, profiles=core.profiles,
        modelspec=core.modelspec, workloads=core.workloads,
        hardware=core.hardware, power=core.power, moe=core.moe)


REF, PORT = _pkg("repro"), _pkg("repro_torch")


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


# --- core.fleet / core.routing (tests/core/test_fleet.py) ------------------

def _azure_grid(pk):
    R, P, W = pk.routing, pk.profiles, pk.workloads
    m = pk.modelspec.LLAMA31_70B
    return {g: {"homo": R.Homogeneous().provision(W.AZURE, prof, m),
                "pool": R.TwoPool(b_short=4096).provision(W.AZURE, prof, m),
                "fleetopt": R.FleetOpt(b_short=4096, gamma=2.0).provision(
                    W.AZURE, prof, m)}
            for g, prof in (("H100", P.H100_LLAMA70B),
                            ("B200", P.B200_LLAMA70B_FLEET))}


@pytest.fixture(scope="module")
def azure_grid():
    ref, port = _both(_azure_grid)
    assert_same(ref, port)
    return port


def test_azure_h100_column(azure_grid):
    col = azure_grid["H100"]
    assert col["homo"].instances == pytest.approx(141, rel=0.1)
    assert col["pool"].instances == pytest.approx(68, rel=0.15)
    assert col["fleetopt"].instances == pytest.approx(40, rel=0.15)
    assert col["homo"].tok_per_watt == pytest.approx(5.58, rel=0.1)
    assert col["pool"].tok_per_watt == pytest.approx(9.16, rel=0.2)
    assert col["fleetopt"].tok_per_watt == pytest.approx(14.08, rel=0.15)


def test_azure_b200_fleetopt(azure_grid):
    rep = azure_grid["B200"]["fleetopt"]
    assert rep.instances == pytest.approx(17, abs=3)
    assert rep.tok_per_watt == pytest.approx(23.71, rel=0.1)


def test_topology_ordering(azure_grid):
    for gen in ("H100", "B200"):
        col = azure_grid[gen]
        assert (col["homo"].tok_per_watt < col["pool"].tok_per_watt
                < col["fleetopt"].tok_per_watt)


def test_combined_gain(azure_grid):
    """`gain_decomposition` (core.law) of the port over the port's tok/W
    grid, which equals the reference's exactly, equals the reference's."""
    tpw = {g: {t: r.tok_per_watt for t, r in col.items()}
           for g, col in azure_grid.items()}
    g = port_gain_decomposition(tpw)
    assert_same(gain_decomposition(tpw), g)
    assert g["combined"] == pytest.approx(4.25, rel=0.15)
    assert g["topo_h100"] < 0.75 * g["combined"]
    assert g["gen_homo"] < 0.75 * g["combined"]


def test_gamma_star_optimal():
    def run(pk):
        R, W, P = pk.routing, pk.workloads, pk.profiles
        m = pk.modelspec.LLAMA31_70B
        g_star, rep = R.optimize_gamma(W.AZURE, P.H100_LLAMA70B, m, 4096)
        rates = [R.FleetOpt(b_short=4096, gamma=g).mispredict_rate(W.AZURE)
                 for g in (1.0, 2.0)]
        others = [R.FleetOpt(b_short=4096, gamma=g).provision(
            W.AZURE, P.H100_LLAMA70B, m) for g in (3.0, 4.0)]
        return g_star, rep, rates, others
    ref, port = _both(run)
    assert_same(ref, port)
    g_star, rep, (r1, r2), others = port
    assert g_star == 2.0
    assert r1 > 5e-5 and r2 <= 5e-5
    assert all(rep.tok_per_watt >= o.tok_per_watt for o in others)


def test_lmsys_ordering():
    def run(pk):
        R, W, P = pk.routing, pk.workloads, pk.profiles
        m = pk.modelspec.LLAMA31_70B
        return [(R.Homogeneous().provision(W.LMSYS, prof, m),
                 R.FleetOpt(b_short=1536, gamma=2.0).provision(
                     W.LMSYS, prof, m))
                for prof in (P.H100_LLAMA70B, P.B200_LLAMA70B_FLEET)]
    ref, port = _both(run)
    assert_same(ref, port)
    for h, f in port:
        assert f.tok_per_watt > 1.4 * h.tok_per_watt


def _sized_pool(pk):
    s = pk.modelspec.LLAMA31_70B.streamed_params
    return pk.fleet.PoolSizing(
        name="p", window=65536, profile=pk.profiles.H100_LLAMA70B,
        arrival_rate=100.0, mean_output=300.0, mean_context=4000.0,
        mean_prompt=1500.0).size(streamed_params=s), s


def test_recalibrate_only_adds_capacity():
    steps = [dict(prefill_mfu=0.8), dict(prefill_mfu=0.01),
             dict(prefill_mfu=0.8), "floor+7", dict(min_instances=1),
             dict(hol_inflation=2.0)]

    def run(pk):
        pool, s = _sized_pool(pk)
        trail = [dataclasses.replace(pool)]
        for kw in steps:
            if kw == "floor+7":
                kw = dict(min_instances=trail[2].instances + 7)
            pool.recalibrate(streamed_params=s, **kw)
            trail.append(dataclasses.replace(pool))
        return trail
    ref, trail = _both(run)
    assert_same(ref, trail)
    base, same, grown = trail[0], trail[1], trail[2]
    assert same.instances == base.instances
    assert grown.instances > base.instances
    assert grown.prefill_bound >= grown.instances
    assert grown.tokens_per_s == base.tokens_per_s
    assert trail[3].instances == grown.instances
    assert trail[4].instances == grown.instances + 7
    assert trail[5].instances == grown.instances + 7
    assert trail[6].n_inflight == pytest.approx(2.0 * trail[5].n_inflight)
    assert trail[6].instances >= grown.instances + 7


def _fleetopt_plan(pk):
    return pk.routing.FleetOpt(b_short=4096, gamma=2.0).provision(
        pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B)


def test_measured_hol_override_raises_both_closed_form_bounds():
    def run(pk):
        rep = _fleetopt_plan(pk)
        long_pool = sorted(rep.pools, key=lambda p: p.window)[1]
        before = dataclasses.replace(long_pool)
        pk.fleet.apply_overrides(
            rep, {"long": pk.fleet.PoolOverride(hol_inflation=1.9)},
            roles=["short", "long"],
            streamed_params=pk.modelspec.LLAMA31_70B.streamed_params)
        return before, long_pool
    ref, (before, after) = _both(run)
    assert_same(ref, (before, after))
    assert after.n_inflight == pytest.approx(1.9 * before.n_inflight)
    assert after.decode_bound >= before.decode_bound
    assert after.prefill_bound >= before.prefill_bound
    assert after.decode_bound + after.prefill_bound \
        > before.decode_bound + before.prefill_bound
    assert after.hol_inflation == 1.9


def test_apply_overrides_targets_roles():
    def run(pk):
        rep = _fleetopt_plan(pk)
        pools = sorted(rep.pools, key=lambda p: p.window)
        before = [p.instances for p in pools]
        pk.fleet.apply_overrides(
            rep, {"long": pk.fleet.PoolOverride(
                min_instances=before[1] + 5)},
            roles=["short", "long"],
            streamed_params=pk.modelspec.LLAMA31_70B.streamed_params)
        return before, rep
    ref, (before, rep) = _both(run)
    assert_same(ref, (before, rep))
    pools = sorted(rep.pools, key=lambda p: p.window)
    assert [p.instances for p in pools] == [before[0], before[1] + 5]


# --- core.topospec (tests/core/test_topospec.py) ---------------------------

_KIND_CASES = [
    ("homo", {}),
    ("moe_pool", {"dispatch_ms": 2.0}),
    ("two_pool", {"b_short": 4096}),
    ("fleetopt", {"b_short": 4096, "gamma": 2.0}),
    ("fleetopt", {"b_short": 1536, "gamma": 3.0}),
    ("multipool", {"windows": (4096, 16384, 65536), "gamma": 2.0}),
    ("multipool", {"windows": (2048, 8192, 16384, 65536), "gamma": 1.5}),
    ("semantic", {"b_short": 4096}),
    ("semantic", {"b_short": 4096, "misroute_rate": 0.05}),
    ("semantic_fleetopt", {"b_short": 4096, "gamma": 2.0}),
    ("moe_semantic", {"b_short": 4096, "gamma": 2.0, "dispatch_ms": 2.0}),
    ("disagg", {}),
    ("disagg_fleetopt", {"b_short": 4096, "gamma": 2.0}),
]
_KIND_IDS = [f"{k}-{i}" for i, (k, _) in enumerate(_KIND_CASES)]
WORKLOAD_NAMES = ("AZURE", "LMSYS", "AGENT")


def _model(pk, kind):
    return pk.modelspec.QWEN3_235B_A22B if kind in ("moe_pool",
                                                     "moe_semantic") \
        else pk.modelspec.LLAMA31_70B


def _from_kind(pk, kind, kw):
    return pk.topospec.TopologySpec.from_kind(
        kind, pk.profiles.H100_LLAMA70B, _model(pk, kind), **kw)


def _legacy_twin(pk, kind, spec, kw):
    """The analytical provisioner each kind compiled to before the IR
    (the reference test's `_legacy_twin`), in package `pk`."""
    R, prof = pk.routing, pk.profiles.H100_LLAMA70B
    b_short, gamma = kw.get("b_short", 4096), kw.get("gamma", 2.0)
    model = _model(pk, kind)
    if kind in ("homo", "moe_pool"):
        return R.Homogeneous(), spec.pools[0].profile, model
    if kind in ("two_pool",):
        return R.TwoPool(b_short=b_short), prof, model
    if kind in ("fleetopt",):
        return R.FleetOpt(int(gamma * b_short), gamma=1.0), prof, model
    if kind in ("multipool",):
        return pk.multipool.MultiPool(kw["windows"], gamma=gamma), prof, \
            model
    if kind in pk.topospec.SEMANTIC_KINDS:
        g = 1.0 if kind in ("semantic",) else gamma
        return R.Semantic(b_short=b_short,
                          small_profile=spec.pool("small").profile,
                          small_model=spec.models["small"], gamma=g,
                          misroute_rate=kw.get("misroute_rate", 0.0)), \
            spec.pool("large").profile, model
    return pk.disagg.Disaggregated(
        b_short=int(gamma * b_short), gamma=1.0,
        split=kind in ("disagg_fleetopt",)), prof, model


_SIZED_FIELDS = ("name", "window", "arrival_rate", "mean_output",
                 "mean_context", "mean_prompt", "hol_inflation", "phase",
                 "instances", "n_active", "power_w_per_instance",
                 "tokens_per_s", "decode_bound", "prefill_bound",
                 "n_inflight", "sized_prefill_mfu")


@pytest.mark.parametrize("wl", WORKLOAD_NAMES)
@pytest.mark.parametrize("kind,kw", _KIND_CASES, ids=_KIND_IDS)
def test_provision_parity_bit_exact(kind, kw, wl):
    def run(pk):
        spec = _from_kind(pk, kind, kw)
        legacy, prof, model = _legacy_twin(pk, kind, spec, kw)
        workload = getattr(pk.workloads, wl)
        return spec.provision(workload), legacy.provision(workload, prof,
                                                          model)
    ref, (got, want) = _both(run)
    assert_same(ref, (got, want))
    # the reference's claim: the IR provisions what the legacy class did
    assert got.label == want.label and len(got.pools) == len(want.pools)
    for g, w in zip(got.pools, want.pools):
        for f in _SIZED_FIELDS:
            assert getattr(g, f) == getattr(w, f), (g.name, f)
        assert g.profile is w.profile, g.name


@pytest.mark.parametrize("kind,kw", _KIND_CASES, ids=_KIND_IDS)
def test_roles_spec_hash_and_registry(kind, kw):
    """Roles round-trip, the spec hash (sha-256 of the canonical spec) and
    the model registry equal the reference's for every legacy kind."""
    def run(pk):
        spec = _from_kind(pk, kind, kw)
        plan = spec.provision(pk.workloads.AZURE)
        return (pk.topospec.plan_roles(plan), spec.roles, spec.spec_hash,
                spec.max_window, spec.registry(), spec)
    ref, port = _both(run)
    assert_same(ref, port)
    roles, spec_roles, spec_hash, _, _, _ = port
    assert set(roles) <= set(spec_roles)
    assert len(spec_hash) == 12


def test_plan_roles_rejects_unstamped_pools():
    for pk in (REF, PORT):
        plan = pk.routing.Homogeneous().provision(
            pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B)
        with pytest.raises(ValueError, match="no router role"):
            pk.topospec.plan_roles(plan)


def test_registry_bindings():
    def run(pk):
        prof, m = pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B
        sem = _from_kind(pk, "semantic", {})
        moe = _from_kind(pk, "moe_pool", {"dispatch_ms": 2.0})
        homo = [pk.topospec.TopologySpec.from_kind(k, prof, m).registry()
                for k in ("homo", "two_pool", "fleetopt",
                          "disagg_fleetopt")]
        return sem, sem.registry(), moe.registry(), homo
    ref, (sem, reg, moe_reg, homo) = _both(run)
    assert_same(ref, (sem, reg, moe_reg, homo))
    prof, m = PORT.profiles.H100_LLAMA70B, PORT.modelspec.LLAMA31_70B
    assert all(not r.heterogeneous and r.default.model is m
               and r.default.profile is prof for r in homo)
    assert reg.heterogeneous
    assert reg.for_role("small").model is sem.models["small"]
    assert reg.for_role("large").profile is prof
    assert moe_reg.default.dispatch_ms == 2.0
    assert moe_reg.default.profile.roofline.w_ms == prof.roofline.w_ms + 2.0


def _pool_spec(pk, role="a", window=4096, admit=math.inf, **kw):
    return pk.topospec.PoolSpec(role=role, window=window,
                                profile=pk.profiles.H100_LLAMA70B,
                                admit=admit, **kw)


def _custom(pk, pools, **kw):
    kw.setdefault("models", {"default": pk.modelspec.LLAMA31_70B})
    return pk.topospec.TopologySpec(kind="custom", pools=tuple(pools), **kw)


# (case, builder(pk), message pattern): the reference's validation cases
_INVALID = [
    ("empty", lambda pk: _custom(pk, ()), "at least one PoolSpec"),
    ("dup-roles", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0), _pool_spec(pk, "a", 65536)]),
     "duplicate pool roles"),
    ("dup-names", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0, name="p"),
        _pool_spec(pk, "b", 65536, name="p")]), "duplicate pool names"),
    ("dangling", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0, overflow_to="nope"),
        _pool_spec(pk, "b", 65536)]), "dangling edge"),
    ("backward", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0),
        _pool_spec(pk, "b", 65536, escalate_to="a")]), "points backward"),
    ("evict-dest", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0, evict_on_overflow=True),
        _pool_spec(pk, "b", 65536)]), "no\n?.*overflow_to destination"),
    ("windows-asc", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 65536, 4096.0), _pool_spec(pk, "b", 65536)]),
     "strictly ascending"),
    ("admits-asc", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 8192.0),
        _pool_spec(pk, "b", 65536, 8192.0)]), "strictly ascending"),
    ("last-inf", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 2048.0),
        _pool_spec(pk, "b", 65536, 65536.0)]), "admit everything"),
    ("admit-window", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 8192.0), _pool_spec(pk, "b", 65536)]),
     "exceeds\n?.*serve window"),
    ("no-admit", lambda pk: _custom(pk, [_pool_spec(pk, "a", 4096, None)]),
     "cannot enter the fleet"),
    ("unreachable", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, math.inf),
        _pool_spec(pk, "b", 65536, None)]), "never receive traffic"),
    ("prefill-handoff", lambda pk: _custom(pk, [
        _pool_spec(pk, "pf", 4096, math.inf, phase="prefill")]),
     "handoff_to"),
    ("handoff-phase", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, math.inf, handoff_to="b"),
        _pool_spec(pk, "b", 4096, None)]), "phase-consistent"),
    ("handoff-window", lambda pk: _custom(pk, [
        _pool_spec(pk, "pf", 4096, math.inf, phase="prefill",
                   handoff_to="dec"),
        _pool_spec(pk, "dec", 8192, None)]), "crosses\n?.*window slices"),
    ("model-key", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, math.inf, model_key="missing")]),
     "not in\n?.*spec.models"),
    ("misroute-range", lambda pk: _custom(pk, [_pool_spec(pk)],
                                          misroute_rate=1.5),
     "misroute_rate must be in"),
    ("misroute-flip", lambda pk: _custom(pk, [_pool_spec(pk)],
                                         misroute_rate=0.1),
     "needs a flip"),
    ("flip-role", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0), _pool_spec(pk, "b", 65536)],
        flip=("nope", "b")), "flip role"),
    ("flip-escalate", lambda pk: _custom(pk, [
        _pool_spec(pk, "a", 4096, 4096.0), _pool_spec(pk, "b", 65536)],
        flip=("a", "b")), "must escalate_to"),
    ("hol", lambda pk: _custom(pk, [_pool_spec(pk, hol_inflation=0.5)]),
     "hol_inflation"),
    ("dispatch", lambda pk: _custom(pk, [_pool_spec(pk, dispatch_ms=-1.0)]),
     "dispatch_ms"),
    ("window", lambda pk: _custom(pk, [_pool_spec(pk, window=0)]),
     "positive token count"),
    ("phase", lambda pk: _custom(pk, [_pool_spec(pk, phase="warp")]),
     "unknown phase"),
    ("kind-misroute", lambda pk: _from_kind(pk, "fleetopt",
                                            {"misroute_rate": 0.1}),
     "misroute_rate only applies"),
    ("kind-dispatch", lambda pk: _from_kind(pk, "homo",
                                            {"dispatch_ms": 2.0}),
     "dispatch_ms only applies"),
    ("kind-ladder", lambda pk: _from_kind(pk, "multipool", {}),
     "needs an ascending"),
    ("kind-ascending", lambda pk: _from_kind(
        pk, "multipool", {"windows": (8192, 4096)}), "strictly ascending"),
    ("kind-collide", lambda pk: _from_kind(
        pk, "multipool", {"windows": (4096, 4100, 65536)}), "collide"),
    ("kind-gamma", lambda pk: _from_kind(
        pk, "multipool", {"windows": (4096, 65536), "gamma": 0.5}),
     "gamma must be"),
    ("kind-unknown", lambda pk: _from_kind(pk, "nope", {}), "nope"),
]


@pytest.mark.parametrize("build,match", [c[1:] for c in _INVALID],
                         ids=[c[0] for c in _INVALID])
def test_spec_validation_matches_reference(build, match):
    msgs = []
    for pk in (REF, PORT):
        with pytest.raises(ValueError, match=match) as err:
            build(pk)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_spec_hash_pinned_and_sensitive():
    def run(pk):
        prof, m = pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B
        TS = pk.topospec.TopologySpec
        base = TS.from_kind("fleetopt", prof, m, b_short=4096)
        AP = pk.autoscale.AutoscalePolicy
        return [base.spec_hash,
                dataclasses.replace(base, autoscale=None).spec_hash,
                dataclasses.replace(base, autoscale=AP()).spec_hash,
                dataclasses.replace(
                    base, autoscale=AP(target_utilization=0.5)).spec_hash,
                TS.from_kind("fleetopt", prof, m, b_short=2048).spec_hash,
                TS.from_kind("fleetopt", prof, m, gamma=3.0).spec_hash,
                TS.from_kind("two_pool", prof, m).spec_hash,
                TS.from_kind("semantic", prof, m).spec_hash]
    ref, port = _both(run)
    assert port == ref
    assert port[0] == "73e182db6026" == port[1]
    assert len(set(port[1:])) == len(port) - 1


def test_max_window_and_build():
    def run(pk):
        prof, m = pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B
        TS = pk.topospec.TopologySpec
        spec = TS.from_kind("fleetopt", prof, m, b_short=4096)
        policy, plan, registry = spec.build(pk.workloads.AZURE)
        return ([TS.from_kind("homo", prof, m).max_window,
                 TS.from_kind("multipool", prof, m,
                              windows=(2048, 8192, 32768)).max_window,
                 TS.from_kind("fleetopt", prof, m,
                              long_window=131072).max_window],
                policy.spec is spec, policy, plan, registry)
    ref, port = _both(run)
    assert_same(ref, port)
    windows, is_spec, policy, plan, registry = port
    assert windows == [PORT.routing.LONG_WINDOW, 32768, 131072]
    assert is_spec
    assert policy.ladder == [("short", 8192.0), ("long", math.inf)]
    assert PORT.topospec.plan_roles(plan) == ["short", "long"]
    assert not registry.heterogeneous


# --- core.autoscale (tests/core/test_autoscale_policy.py) ------------------

def test_policy_canon_covers_every_field():
    ref, port = _both(lambda pk: pk.autoscale.AutoscalePolicy())
    assert port.canon() == ref.canon()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) in port.canon(), f.name


@pytest.mark.parametrize("kw", [
    dict(control_interval_s=0.0), dict(target_utilization=1.2),
    dict(scaleup_lag_s=-1.0), dict(min_frac=1.5), dict(weight_load_Bps=0.0),
    dict(spare_instances=-1)], ids=lambda kw: next(iter(kw)))
def test_policy_validation(kw):
    msgs = []
    for pk in (REF, PORT):
        with pytest.raises(ValueError) as err:
            pk.autoscale.AutoscalePolicy(**kw)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# --- core.workloads.DiurnalProfile (tests/core/test_diurnal.py) ------------

def _diurnal(pk, **kw):
    return pk.workloads.DiurnalProfile(**kw)


def test_peak_normalisation_swing_and_periodicity():
    def run(pk):
        p = _diurnal(pk, peak_rate=400.0, day_s=86400.0)
        q = _diurnal(pk, peak_rate=100.0, day_s=240.0)
        t = np.linspace(0.0, p.day_s, 100_001)
        tq = np.array([3.0, 117.0, 239.0])
        return (p.rate_at(t), p.swing, p.mean_rate, q.rate_at(tq),
                q.rate_at(tq + 240.0), q.rate_at(tq + 3 * 240.0))
    ref, port = _both(run)
    assert_same(ref, port)
    r, swing, mean, a, b, c = port
    assert float(r.max()) == pytest.approx(400.0)
    assert swing == pytest.approx(float(r.max() / r.min()), rel=1e-9)
    assert swing == pytest.approx(5.0) and mean < 400.0
    np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(a, c, rtol=1e-12)


def test_cumulative_and_inverse():
    def run(pk):
        p = _diurnal(pk, peak_rate=250.0, day_s=240.0)
        t = np.linspace(0.0, 2.5 * p.day_s, 200_001)
        ti = np.linspace(0.0, p.day_s, 4001)[:-1]
        return t, p.rate_at(t), p.cumulative(t), ti, \
            p._invert(p.cumulative(ti))
    ref, port = _both(run)
    assert_same(ref, port)
    t, rate, cum, ti, inv = port
    numeric = np.concatenate(
        [[0.0], np.cumsum((rate[:-1] + rate[1:]) / 2.0 * np.diff(t))])
    np.testing.assert_allclose(cum, numeric, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(inv, ti, atol=1e-6)


def test_sample_arrivals_deterministic_sorted_and_rate_correct():
    def run(pk):
        p = _diurnal(pk, peak_rate=200.0, day_s=480.0)
        d = _diurnal(pk)
        return (p.sample_arrivals(480.0, seed=7),
                p.sample_arrivals(480.0, seed=7),
                p.cumulative(np.array([480.0]))[0],
                d.sample_arrivals(3600.0, seed=0),
                d.sample_arrivals(3600.0, seed=1))
    ref, port = _both(run)
    assert_same(ref, port)
    a, b, lam, s0, s1 = port
    np.testing.assert_array_equal(a, b)
    assert (np.diff(a) > 0).all() and a[0] >= 0.0 and a[-1] < 480.0
    assert abs(len(a) - lam) < 5 * np.sqrt(lam)
    hour = 480.0 / 24.0
    peak_n = ((a >= 11 * hour) & (a < 13 * hour)).sum() / (2 * hour)
    trough_n = ((a >= 3 * hour) & (a < 5 * hour)).sum() / (2 * hour)
    assert peak_n / max(trough_n, 1e-9) > 3.0
    assert not np.array_equal(s0, s1)


def test_day_compression_preserves_shape():
    def run(pk):
        frac = np.linspace(0.0, 1.0, 97)
        return (_diurnal(pk, peak_rate=100.0, day_s=86400.0).rate_at(
                    frac * 86400.0),
                _diurnal(pk, peak_rate=100.0, day_s=240.0).rate_at(
                    frac * 240.0))
    ref, (long, short) = _both(run)
    assert_same(ref, (long, short))
    np.testing.assert_allclose(long, short, rtol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(peak_rate=0.0), dict(day_s=-1.0), dict(shape=(1.0,)),
    dict(shape=(1.0, 0.0, 0.5))], ids=["peak", "day", "short", "zero"])
def test_diurnal_validation(kw):
    for pk in (REF, PORT):
        with pytest.raises(ValueError):
            _diurnal(pk, **kw)


def test_module_constant_is_frozen_default():
    ref, port = _both(lambda pk: pk.workloads.AZURE_DIURNAL)
    assert_same(ref, port)
    assert port.peak_rate == 1000.0 and port.day_s == 86400.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        port.peak_rate = 1.0


# --- core.slo (tests/serving/test_slo.py) ----------------------------------

def _size(pk, kind, *, profile=None, model=None, **kw):
    return pk.slo.size_to_slo(
        kind, pk.workloads.AZURE, profile or pk.profiles.H100_LLAMA70B,
        model or pk.modelspec.LLAMA31_70B, **kw)


@pytest.fixture(scope="module")
def fleetopt_slo():
    ref, port = _both(lambda pk: _size(pk, "fleetopt", b_short=4096,
                                       n_requests=2000, seed=0))
    assert_same(ref, port)
    return port


def test_slo_loop_converges(fleetopt_slo):
    r = fleetopt_slo
    assert r.rounds[0].ttft_p99_s > r.slo.ttft_p99_s
    assert r.compliant and r.ttft_p99_s <= r.slo.ttft_p99_s
    assert len(r.rounds) >= 2 and r.instances_added > 0
    assert r.report["fleet"]["completed"] == 2000


def test_slo_never_loosened_capacity_monotone(fleetopt_slo):
    r = fleetopt_slo
    assert r.slo == PORT.slo.SLOSpec(ttft_p99_s=0.5)
    assert r.rounds[-1].ttft_p99_s <= 0.5
    for prev, nxt in zip(r.rounds, r.rounds[1:]):
        for role, n in prev.instances.items():
            assert nxt.instances[role] >= n, (role, prev, nxt)
    assert r.plan.instances >= r.unconstrained.instances


def test_slo_tok_per_watt_cost_monotone(fleetopt_slo):
    r = fleetopt_slo
    tpw = [rd.analytical_tok_per_watt for rd in r.rounds]
    assert all(b <= a + 1e-9 for a, b in zip(tpw, tpw[1:])), tpw
    assert r.slo_tok_per_watt <= r.unconstrained.tok_per_watt
    assert r.compliance_cost_pct >= 0.0


def test_slo_calibrates_effective_prefill_mfu(fleetopt_slo):
    cal = fleetopt_slo.calibrated_prefill_mfu
    assert cal and all(0.02 <= v < 0.8 for v in cal.values()), cal


def test_slo_trim_phase_shaves_overshoot(fleetopt_slo):
    r = fleetopt_slo
    assert r.instances_trimmed > 0 and r.trim_rounds >= 1
    grown = sum(r.rounds[-1].instances.values())
    assert r.plan.instances == grown - r.instances_trimmed
    assert r.plan.instances >= r.unconstrained.instances
    assert r.compliant and r.ttft_p99_s <= r.slo.ttft_p99_s
    assert r.slo_tok_per_watt >= r.rounds[-1].analytical_tok_per_watt - 1e-9


def test_slo_incremental_measurement_saves_full_sims(fleetopt_slo):
    s = fleetopt_slo.sim_stats
    assert s["measure_calls"] >= 2
    assert s["full_fleet_sims"] < s["measure_calls"], s
    assert s["pools_reused"] > 0, s
    assert s["pool_sims"] + s["pools_reused"] == \
        2 * (s["measure_calls"] - s["memo_hits"])


def test_slo_converges_identically_to_per_engine_loop(fleetopt_slo):
    r = fleetopt_slo
    assert [rd.instances for rd in r.rounds] == \
        [{"short": 21, "long": 21}, {"short": 21, "long": 25}]
    assert r.trimmed == {"long": 3}
    assert {p.name: p.instances for p in r.plan.pools} == \
        {"fleetopt-short-8K": 21, "fleetopt-long-64K": 22}
    assert round(r.slo_tok_per_watt, 2) == 15.62


def test_slo_azure_fleets_measure_no_hol_inflation(fleetopt_slo):
    r = fleetopt_slo
    assert r.measured_hol
    assert all(v < 1.0 for v in r.measured_hol.values()), r.measured_hol
    assert all(o.hol_inflation is None for o in r.overrides.values())


def test_explain_attributes_violations(fleetopt_slo):
    """`core.slo.explain` rows over the final measured fleet equal the
    reference's (carried in `explanation`)."""
    rows = fleetopt_slo.explanation
    assert sorted(r["role"] for r in rows) == ["long", "short"]
    lates = [r["n_late"] for r in rows]
    assert lates == sorted(lates, reverse=True)


def test_slo_trim_can_be_disabled():
    ref, r = _both(lambda pk: _size(pk, "fleetopt", b_short=4096,
                                    n_requests=2000, seed=0, trim=False))
    assert_same(ref, r)
    assert r.compliant and r.trim_rounds == 0 and not r.trimmed
    assert r.plan.instances == sum(r.rounds[-1].instances.values())


def test_slo_multipool_k3_end_to_end():
    ref, r = _both(lambda pk: _size(
        pk, "multipool", windows=pk.multipool.ladder_windows(3),
        n_requests=1500, seed=0))
    assert_same(ref, r)
    assert r.compliant and r.ttft_p99_s <= 0.5
    assert len([k for k in r.report if k != "fleet"]) == 3
    assert r.report["fleet"]["completed"] == 1500


def test_slo_e2e_constraint_attributes_to_decoding_pool():
    ref, r = _both(lambda pk: _size(
        pk, "fleetopt", b_short=4096, n_requests=1500, seed=0,
        max_rounds=2, slo=pk.slo.SLOSpec(ttft_p99_s=0.5, e2e_p99_s=2.0)))
    assert_same(ref, r)
    assert r.slo.e2e_p99_s == 2.0 and r.rounds[0].e2e_p99_s > 2.0
    assert sum(r.rounds[0].violators.values()) > 0
    assert r.rounds[0].violators["long"] > 0


def test_slo_already_compliant_fleet_untouched():
    ref, r = _both(lambda pk: _size(
        pk, "homo", profile=pk.profiles.B200_LLAMA70B_FLEET,
        n_requests=1500, seed=0))
    assert_same(ref, r)
    assert r.compliant and len(r.rounds) == 1
    assert r.instances_added == 0 and r.compliance_cost_pct == 0.0
    assert not r.overrides and r.trim_rounds == 0 and not r.trimmed


def test_slo_disagg_grows_prefill_fleet_for_ttft():
    ref, r = _both(lambda pk: _size(pk, "disagg_fleetopt", b_short=4096,
                                    n_requests=1500, seed=0))
    assert_same(ref, r)
    assert r.compliant and r.ttft_p99_s <= 0.5
    first, last = r.rounds[0].instances, r.rounds[-1].instances
    assert len(r.rounds) >= 2
    grown = {role for role in first if last[role] > first[role]}
    assert grown and all(role.startswith("prefill") for role in grown)
    assert all(last[role] == first[role] for role in first
               if role.startswith("decode"))


def test_slo_semantic_and_moe_kinds_end_to_end():
    def run(pk):
        sem = _size(pk, "semantic_fleetopt", b_short=4096, n_requests=1500,
                    seed=0, misroute_rate=0.05)
        prof = pk.moe.moe_profile(pk.modelspec.QWEN3_235B_A22B,
                                  pk.hardware.H100, pk.power.H100_POWER,
                                  tp=8)
        moe = _size(pk, "moe_pool", profile=prof,
                    model=pk.modelspec.QWEN3_235B_A22B, n_requests=1500,
                    seed=0, dispatch_ms=2.0, trim=False)
        return sem, moe
    ref, (r, m) = _both(run)
    assert_same(ref, (r, m))
    assert r.compliant and r.ttft_p99_s <= 0.5
    assert set(r.rounds[0].instances) == {"small", "large"}
    assert r.report["fleet"]["escalations"] > 0
    assert m.compliant and m.ttft_p99_s <= 0.5
    assert list(m.rounds[0].instances) == ["moe"] and len(m.rounds) >= 2


def test_slo_measures_hol_inflation_and_feeds_it_back():
    def run(pk):
        wl = pk.workloads.Workload(
            name="prefill-heavy", prompt_mix=((1.0, math.log(6000.0), 0.3),),
            output_mu=math.log(8.0), output_sigma=0.3, arrival_rate=400.0)
        return pk.slo.size_to_slo(
            "homo", wl, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B, n_requests=1200, seed=0,
            max_rounds=4, trim=False)
    ref, r = _both(run)
    assert_same(ref, r)
    assert r.measured_hol["homo"] > 1.0
    o = r.overrides["homo"]
    assert o.hol_inflation is not None and 1.0 < o.hol_inflation <= 2.15
    assert o.hol_inflation == min(r.measured_hol["homo"], 2.15)
    (pool,) = r.plan.pools
    assert pool.hol_inflation == o.hol_inflation


def test_slo_tpot_violations_grow_decode_fleet():
    ref, r = _both(lambda pk: _size(
        pk, "disagg", n_requests=1500, seed=0, max_rounds=2,
        slo=pk.slo.SLOSpec(ttft_p99_s=0.5, tpot_p99_ms=6.0)))
    assert_same(ref, r)
    r0, r1 = r.rounds[0].instances, r.rounds[1].instances
    assert r.rounds[0].violators["decode-64K"] > 0
    assert r1["decode-64K"] > r0["decode-64K"]
    assert r1["prefill-64K"] == r0["prefill-64K"]
    assert r.rounds[0].tpot_p99_ms > 6.0


def test_size_to_slo_spec_on_an_autoscaled_spec():
    """`size_to_slo_spec` (the diurnal bench's entry point) on a spec
    carrying an autoscale policy: sizing never autoscales, and the result
    equals the reference's."""
    def run(pk):
        spec = dataclasses.replace(
            _from_kind(pk, "fleetopt", {"b_short": 4096}),
            autoscale=pk.autoscale.AutoscalePolicy(control_interval_s=6.0))
        wl = dataclasses.replace(pk.workloads.AZURE, arrival_rate=250.0)
        return pk.slo.size_to_slo_spec(
            spec, wl, slo=pk.slo.SLOSpec(ttft_p99_s=0.2), n_requests=800,
            seed=0)
    ref, r = _both(run)
    assert_same(ref, r)
    assert r.report["fleet"]["completed"] == 800
